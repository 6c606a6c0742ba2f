"""LoRA adapters for the LLaMA decoder (port of vstar_tpu/train/lora.py).

The reference trains the VSM with peft LoRA r=8 alpha=16 on q_proj/v_proj
(VisualSearch/train.py:189-231) and merges before export. Adapters live
in `params['layers']['attn']['lora']` as stacked f32 tensors and are
applied inside the attention block (nn/llama.py); `merge_lora` folds them
into the base weights.

As in the JAX package, `lora_scale` (alpha / r, f32 [L, 1, 1]) sits under
the trainable prefix `llama.layers.attn.lora`, so AdamW updates it once
B is non-zero; peft keeps it constant (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..core.params import map_with_path
from ..nn.quant import dequantize_weight

LORA_TARGETS = ("wq", "wv")  # q_proj, v_proj


def add_lora(llama_params: Dict, seed: int, r: int = 8, alpha: int = 16,
             targets: Sequence[str] = LORA_TARGETS) -> Dict:
    """Return params with zero-impact adapters attached: A ~ N(0, 1/r^2)
    (JAX's normal * 1/r), B = 0, drawn on the weights' device from a
    generator seeded with `seed`."""
    attn = llama_params["layers"]["attn"]
    first = attn[targets[0]]
    dev = (first["q"] if isinstance(first, dict) and "q" in first
           else first).device
    # a meta-device tree (a memory plan of shapes only) draws nothing
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    lora = {}
    for t in targets:
        w = attn[t]
        base = w["q"] if isinstance(w, dict) and "q" in w else w
        L, din, dout = base.shape
        lora[f"{t}_a"] = torch.randn((L, din, r), generator=gen,
                                     device=dev) * (1.0 / r)
        lora[f"{t}_b"] = torch.zeros((L, r, dout), device=dev)
    out = dict(llama_params)
    layers = dict(llama_params["layers"])
    layers["attn"] = dict(attn)
    layers["attn"]["lora"] = lora
    layers["attn"]["lora_scale"] = torch.full((L, 1, 1), alpha / r,
                                              device=dev)
    out["layers"] = layers
    return out


def lora_delta(lora: Dict, scale: torch.Tensor, name: str,
               x: torch.Tensor) -> torch.Tensor:
    """x @ (A B) * alpha/r for one target (one layer's slice)."""
    a = lora[f"{name}_a"].to(x.dtype)
    b = lora[f"{name}_b"].to(x.dtype)
    return ((x @ a) @ b) * scale.to(x.dtype)


def split_inputs(lora: Dict, scale: torch.Tensor, x: torch.Tensor,
                 targets: Sequence[str] = LORA_TARGETS) -> tuple:
    """What a rank of a model split of the decoder (core/mesh.ModelSplit)
    uses whole of one layer's adapters: x @ A of each target, B of each,
    the scale. They enter the split together with the block's input, so
    that their partial gradients are summed in its one all-reduce, as
    XLA combines them (A's gradient then follows from the whole one of
    x @ A)."""
    return (tuple(x @ lora[f"{t}_a"].to(x.dtype) for t in targets)
            + tuple(lora[f"{t}_b"] for t in targets) + (scale,))


def split_delta(xa: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                split=None) -> torch.Tensor:
    """lora_delta's columns that this rank's q / v shard holds, from
    x @ A (split_inputs): (x A) times the rank's columns of B (all of
    them without a model `split`), scaled."""
    b = b.to(xa.dtype)
    if split is not None:
        b = split.columns(b)
    return (xa @ b) * scale.to(xa.dtype)


def merge_lora(llama_params: Dict,
               targets: Sequence[str] = LORA_TARGETS) -> Dict:
    """Fold adapters into the base weights and drop them (export path,
    mirroring merge_and_unload)."""
    attn = dict(llama_params["layers"]["attn"])
    lora = attn.pop("lora")
    scale = attn.pop("lora_scale")
    for t in targets:
        orig = attn[t]
        base = dequantize_weight(orig, torch.float32)
        delta = torch.einsum("lir,lro->lio", lora[f"{t}_a"],
                             lora[f"{t}_b"]) * scale
        out_dtype = torch.float32 if isinstance(orig, dict) else orig.dtype
        attn[t] = (base + delta).to(out_dtype)
    out = dict(llama_params)
    layers = dict(llama_params["layers"])
    layers["attn"] = attn
    out["layers"] = layers
    return out


def vsm_trainable_mask(params: Dict) -> Dict:
    """The reference's trainable set (VisualSearch/train.py:236-245):
    LoRA adapters (and, as in JAX, their scale), lm_head, embed_tokens,
    visual_projection, prompt_encoder, mask_decoder, text FCs, owl
    class_head + merge layer_norm. Everything else (towers, box_head,
    projector, base decoder weights) frozen."""
    def trainable(path: str, _) -> bool:
        if path.startswith("llama.layers.attn.lora"):
            return True
        if path.startswith(("llama.lm_head", "llama.embed_tokens")):
            return True
        if path.startswith(("visual_projection", "prompt_encoder",
                            "mask_decoder", "fc_det", "fc_seg",
                            "owl_merge_ln")):
            return True
        if path.startswith("owl_heads.class_head"):
            return True
        return False
    return map_with_path(trainable, params)
