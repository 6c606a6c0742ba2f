"""Export the port's parameter trees back to the HF/torch checkpoint layout
(port of vstar_tpu/core/hf_export.py).

Counterpart of the reference's merge-and-export script
(VisualSearch/merge_lora_weights_and_save_hf_model.py): merge LoRA, map
the nested, stacked trees back to flat torch-style names (dense weights
transposed to (out, in)), and write safetensors shards with the index
JSON, which core/checkpoint.load_torch_dir (or the torch reference) loads.
The files are written by core/checkpoint.write_safetensors, with the
safetensors package's layout.

Weights leave in f32 as JAX exports them; `dtype=torch.bfloat16` keeps a
bf16 model's bits at half the size. Quantized decoder entries (int8,
int4) are dequantized. config_json writes the config.json that core/hf_config reads
back into the same configuration.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from ..nn.quant import dequantize_weight
from .checkpoint import INDEX_NAME, write_safetensors
from .config import VQALLMConfig, VSMConfig

StateDict = Dict[str, torch.Tensor]


def _v(x, dtype) -> torch.Tensor:
    return x.detach().to(dtype).contiguous()


def _t(x, dtype) -> torch.Tensor:
    """(in, out) -> torch (out, in)."""
    return x.detach().to(dtype).T.contiguous()


def _index_entry(entry, i):
    if isinstance(entry, dict):
        return {k: v[i] for k, v in entry.items()}
    return entry[i]


def llama_state_dict(llama_params: Dict, prefix: str = "model.",
                     dtype=torch.float32) -> StateDict:
    """Inverse of hf_import.llama_params_from_torch (merges LoRA first)."""
    p = llama_params
    if "lora" in p["layers"]["attn"]:
        from ..train.lora import merge_lora
        p = merge_lora(p)
    sd: StateDict = {}
    sd[prefix + "embed_tokens.weight"] = _v(p["embed_tokens"], dtype)
    sd[prefix + "norm.weight"] = _v(p["final_norm"]["scale"], dtype)
    sd["lm_head.weight"] = _t(dequantize_weight(p["lm_head"]), dtype)
    L = p["layers"]["input_norm"]["scale"].shape[0]
    names = {
        ("attn", "wq"): "self_attn.q_proj", ("attn", "wk"): "self_attn.k_proj",
        ("attn", "wv"): "self_attn.v_proj", ("attn", "wo"): "self_attn.o_proj",
        ("mlp", "w_gate"): "mlp.gate_proj", ("mlp", "w_up"): "mlp.up_proj",
        ("mlp", "w_down"): "mlp.down_proj",
    }
    for i in range(L):
        base = f"{prefix}layers.{i}."
        sd[base + "input_layernorm.weight"] = _v(
            p["layers"]["input_norm"]["scale"][i], dtype)
        sd[base + "post_attention_layernorm.weight"] = _v(
            p["layers"]["post_norm"]["scale"][i], dtype)
        for (grp, key), tname in names.items():
            w = dequantize_weight(_index_entry(p["layers"][grp][key], i))
            sd[base + tname + ".weight"] = _t(w, dtype)
    return sd


def vit_state_dict(vit_params: Dict, prefix: str,
                   pre_ln_name: str = "pre_layrnorm",
                   dtype=torch.float32) -> StateDict:
    """Inverse of hf_import.vit_params_from_torch."""
    p = vit_params
    sd: StateDict = {}

    def ln(name, lnp):
        sd[prefix + name + ".weight"] = _v(lnp["scale"], dtype)
        sd[prefix + name + ".bias"] = _v(lnp["bias"], dtype)

    # patch embed: (kh*kw*in, out) -> (out, in, kh, kw)
    w = p["patch_embed"]["w"].detach().to(dtype)
    out_c = w.shape[1]
    k = int(round((w.shape[0] / 3) ** 0.5))
    sd[prefix + "embeddings.patch_embedding.weight"] = (
        w.reshape(k, k, 3, out_c).permute(3, 2, 0, 1).contiguous())
    sd[prefix + "embeddings.position_embedding.weight"] = _v(
        p["position_embedding"], dtype)
    if "class_embedding" in p:
        sd[prefix + "embeddings.class_embedding"] = _v(
            p["class_embedding"], dtype)
    if "pre_ln" in p:
        ln(pre_ln_name, p["pre_ln"])
    ln("post_layernorm", p["post_ln"])

    L = p["layers"]["ln1"]["scale"].shape[0]
    for i in range(L):
        b = f"encoder.layers.{i}."
        for name, sub in (("layer_norm1", p["layers"]["ln1"]),
                          ("layer_norm2", p["layers"]["ln2"])):
            sd[prefix + b + name + ".weight"] = _v(sub["scale"][i], dtype)
            sd[prefix + b + name + ".bias"] = _v(sub["bias"][i], dtype)
        for grp, pairs in (("attn", (("wq", "self_attn.q_proj"),
                                     ("wk", "self_attn.k_proj"),
                                     ("wv", "self_attn.v_proj"),
                                     ("wo", "self_attn.out_proj"))),
                           ("mlp", (("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")))):
            for jn, tn in pairs:
                e = p["layers"][grp][jn]
                sd[prefix + b + tn + ".weight"] = _t(e["w"][i], dtype)
                sd[prefix + b + tn + ".bias"] = _v(e["b"][i], dtype)
    return sd


def save_safetensors(sd: StateDict, path: str,
                     shard_bytes: int = 4 * 1024 ** 3) -> None:
    """Write a state_dict as safetensors shards of at most `shard_bytes`
    (a tensor larger than that gets a shard of its own), with the index
    JSON when there is more than one (vstar_tpu's names and index)."""
    os.makedirs(path, exist_ok=True)
    shards = []
    cur: StateDict = {}
    size = 0
    for k, v in sd.items():
        nbytes = v.numel() * v.element_size()
        if size + nbytes > shard_bytes and cur:
            shards.append(cur)
            cur, size = {}, 0
        cur[k] = v
        size += nbytes
    if cur:
        shards.append(cur)
    index = {"metadata": {}, "weight_map": {}}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = (f"model-{i + 1:05d}-of-{n:05d}.safetensors"
                 if n > 1 else "model.safetensors")
        write_safetensors(shard, os.path.join(path, fname))
        for k in shard:
            index["weight_map"][k] = fname
    if n > 1:
        with open(os.path.join(path, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)


def _lin_sd(sd, name, entry, dtype):
    sd[name + ".weight"] = _t(entry["w"], dtype)
    if "b" in entry:
        sd[name + ".bias"] = _v(entry["b"], dtype)


def _ln_sd(sd, name, entry, dtype):
    sd[name + ".weight"] = _v(entry["scale"], dtype)
    sd[name + ".bias"] = _v(entry["bias"], dtype)


def vqa_llm_state_dict(params: Dict, dtype=torch.float32) -> StateDict:
    """LlavaSearchLlamaForCausalLM export: inverse of
    models.vqa_llm.vqa_llm_params_from_torch (the JAX package exports only
    the VSM and its parts; this composes the same parts)."""
    sd: StateDict = {}
    sd.update(llama_state_dict(params["llama"], dtype=dtype))
    sd.update(vit_state_dict(
        params["vision"],
        prefix="model.vision_tower.vision_tower.vision_model.", dtype=dtype))
    _lin_sd(sd, "model.mm_projector", params["proj_image"]["proj"], dtype)
    pp = params["proj_object"]["perceiver"]
    pre = "model.mm_projector_object."
    _ln_sd(sd, pre + "0", pp["pre_ln"], dtype)
    sd[pre + "1.latents"] = _v(pp["latents"], dtype)
    sd[pre + "1.media_pos_emb"] = _v(pp["media_pos_emb"], dtype)
    _ln_sd(sd, pre + "1.norm", pp["final_norm"], dtype)
    _lin_sd(sd, pre + "2", pp["out_proj"], dtype)
    lp = pp["layers"]
    for i in range(lp["to_q"]["w"].shape[0]):
        a, f = f"{pre}1.layers.{i}.0.", f"{pre}1.layers.{i}.1."
        for name in ("norm_media", "norm_latents"):
            _ln_sd(sd, a + name, {k: v[i] for k, v in lp[name].items()},
                   dtype)
        for name in ("to_q", "to_kv", "to_out"):
            sd[a + name + ".weight"] = _t(lp[name]["w"][i], dtype)
        _ln_sd(sd, f + "0", {k: v[i] for k, v in lp["ff_norm"].items()},
               dtype)
        sd[f + "1.weight"] = _t(lp["ff_in"]["w"][i], dtype)
        sd[f + "3.weight"] = _t(lp["ff_out"]["w"][i], dtype)
    return sd


def vsm_state_dict(params: Dict, dtype=torch.float32) -> StateDict:
    """Full VSMForCausalLM export: inverse of
    models.vsm.vsm_params_from_torch (LoRA merged). Covers the decoder,
    CLIP tower, projector, OWL-ViT tower/heads, SAM prompt encoder/mask
    decoder, and the [LOC] text FCs."""
    sd: StateDict = {}
    sd.update(llama_state_dict(params["llama"], dtype=dtype))
    sd.update(vit_state_dict(
        params["vision"],
        prefix="model.vision_tower.vision_tower.vision_model.", dtype=dtype))
    sd.update(vit_state_dict(params["owl_tower"],
                             prefix="model.owlvit.vision_model.",
                             pre_ln_name="pre_layernorm", dtype=dtype))
    _lin_sd(sd, "model.mm_projector", params["proj"]["proj"], dtype)
    _ln_sd(sd, "model.owlvit.layer_norm", params["owl_merge_ln"], dtype)
    for name in ("dense0", "logit_shift", "logit_scale"):
        _lin_sd(sd, f"model.owlvit.class_head.{name}",
                params["owl_heads"]["class_head"][name], dtype)
    for name in ("dense0", "dense1", "dense2"):
        _lin_sd(sd, f"model.owlvit.box_head.{name}",
                params["owl_heads"]["box_head"][name], dtype)
    sd["model.visual_projection.weight"] = _t(
        params["visual_projection"]["w"], dtype)

    pe = params["prompt_encoder"]
    sd["model.prompt_encoder.pe_layer."
       "positional_encoding_gaussian_matrix"] = _v(pe["pe_gaussian"], dtype)
    sd["model.prompt_encoder.no_mask_embed.weight"] = _v(
        pe["no_mask_embed"], dtype)[None]

    dec = params["mask_decoder"]
    dp = "model.mask_decoder."
    sd[dp + "iou_token.weight"] = _v(dec["iou_token"], dtype)
    sd[dp + "mask_tokens.weight"] = _v(dec["mask_tokens"], dtype)

    def attn_sd(base, a):
        for jn, tn in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                       ("out", "out_proj")):
            _lin_sd(sd, base + "." + tn, a[jn], dtype)

    for i, lp in enumerate(dec["transformer"]["layers"]):
        b = f"{dp}transformer.layers.{i}."
        attn_sd(b + "self_attn", lp["self_attn"])
        attn_sd(b + "cross_attn_token_to_image", lp["cross_t2i"])
        attn_sd(b + "cross_attn_image_to_token", lp["cross_i2t"])
        _lin_sd(sd, b + "mlp.lin1", lp["mlp_in"], dtype)
        _lin_sd(sd, b + "mlp.lin2", lp["mlp_out"], dtype)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _ln_sd(sd, b + n, lp[n], dtype)
    attn_sd(dp + "transformer.final_attn_token_to_image",
            dec["transformer"]["final_attn"])
    _ln_sd(sd, dp + "transformer.norm_final_attn",
           dec["transformer"]["norm_final"], dtype)

    def conv_sd(name, entry):
        sd[name + ".weight"] = entry["w"].detach().to(dtype).permute(
            3, 2, 0, 1).contiguous()
        sd[name + ".bias"] = _v(entry["b"], dtype)

    conv_sd(dp + "output_upscaling.0.conv", dec["upscale_conv1"])
    _ln_sd(sd, dp + "output_upscaling.1", dec["upscale_ln"], dtype)
    conv_sd(dp + "output_upscaling.3.conv", dec["upscale_conv2"])
    for i, mlp in enumerate(dec["hyper_mlps"]):
        for j in range(3):
            _lin_sd(sd, f"{dp}output_hypernetworks_mlps.{i}.layers.{j}",
                    mlp[f"fc{j}"], dtype)
    for j in range(3):
        _lin_sd(sd, f"{dp}iou_prediction_head.layers.{j}",
                dec["iou_head"][f"fc{j}"], dtype)

    for fc, tname in (("fc_det", "text_hidden_fcs_det"),
                      ("fc_seg", "text_hidden_fcs_seg")):
        _lin_sd(sd, f"model.{tname}.0.0", params[fc]["fc0"], dtype)
        _lin_sd(sd, f"model.{tname}.0.2", params[fc]["fc1"], dtype)
    return sd


def config_json(cfg) -> Dict:
    """The config.json fields core/hf_config reads, for a VQALLMConfig or a
    VSMConfig; hf_config gives back the same configuration when the
    towers are CLIP ViT-L/14 at 224 or 336 (what it can name)."""
    c = cfg.llama
    d = {"hidden_size": c.hidden_size,
         "intermediate_size": c.intermediate_size,
         "num_hidden_layers": c.num_layers,
         "num_attention_heads": c.num_heads,
         "num_key_value_heads": c.num_kv_heads, "head_dim": c.head_dim,
         "max_position_embeddings": c.max_position_embeddings,
         "rope_theta": c.rope_theta, "rms_norm_eps": c.rms_norm_eps,
         "vocab_size": c.vocab_size,
         "tie_word_embeddings": c.tie_word_embeddings,
         "mm_hidden_size": cfg.vision.hidden_size,
         "mm_vision_tower": "openai/clip-vit-large-patch14"
         + ("-336" if cfg.vision.image_size == 336 else "")}
    if isinstance(cfg, VQALLMConfig):
        d.update(architectures=["LlavaSearchLlamaForCausalLM"],
                 mm_projector_type=cfg.projector_image.type,
                 object_mm_projector_type=cfg.projector_object.type,
                 max_sequence_length=cfg.context_len)
    elif isinstance(cfg, VSMConfig):
        d.update(architectures=["VSMForCausalLM"],
                 mm_projector_type=cfg.projector.type,
                 out_dim=cfg.out_dim)
    else:
        raise TypeError(f"no config.json for {type(cfg).__name__}")
    return d


def save_hf_dir(sd: StateDict, cfg, path: str,
                shard_bytes: int = 4 * 1024 ** 3) -> None:
    """An HF checkpoint directory: the shards and config.json."""
    save_safetensors(sd, path, shard_bytes)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_json(cfg), f, indent=2)
