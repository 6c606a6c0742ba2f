"""The work the window's traffic needs, counted from the traffic and the
records, never from the kernels that ran: model FLOPs for `mfu.*` and
the attention calls' FLOPs and bytes for `attn_roofline.*`.

Counted as the inputs need it: a row that pads a batch, an empty object
slot, a rejected draft token and the forward after a row's last token
are not work. A matmul of m x k by k x n is 2mkn FLOPs. Attention over
n keys is 4 * heads * head_dim * n FLOPs a query (scores and values);
its bytes are q, k and v read once and the output written once, in bf16,
with k and v at their own head count (grouped-query attention reads
num_key_value_heads of them).

`attention` lists only the attention that the kernels named in
portbench/attention/ compute: the decoder's (K1) and the OWL-ViT tower's
(K2, sequences of 512 and more). CLIP at 257 tokens, the perceiver and
SAM attend through plain matmuls, whose time no name file can pick out,
so their attention counts in `mfu.*` only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

BYTES = 2            # bf16


@dataclass
class Work:
    flops: float = 0.0
    attn: List[tuple] = field(default_factory=list)   # (flops, bytes)

    def add_attention(self, flops: float, nbytes: float, kernel: bool):
        self.flops += flops
        if kernel:
            self.attn.append((flops, nbytes))


def _dec(cfg: Dict):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Dh = D // H
    return D, H, cfg["num_key_value_heads"], Dh, cfg["intermediate_size"], \
        cfg["num_hidden_layers"], cfg["vocab_size"] + cfg["added_tokens"]


def layer_matmul_flops(cfg: Dict) -> float:
    """One token through one decoder layer's matmuls."""
    D, H, Hkv, Dh, F, _, _ = _dec(cfg)
    return 2.0 * (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D + 3 * D * F)


def decoder(work: Work, cfg: Dict, prefix: int, queries: int,
            logits: int):
    """`queries` new tokens after `prefix` cached ones through the stack
    (causal within the chunk), with `logits` rows of the lm_head."""
    D, H, Hkv, Dh, F, L, V = _dec(cfg)
    work.flops += L * queries * layer_matmul_flops(cfg) + 2.0 * D * V * logits
    keys = sum(prefix + j + 1 for j in range(queries))
    fl = 4.0 * H * Dh * keys
    by = BYTES * Dh * (2 * queries * H + 2 * (prefix + queries) * Hkv)
    for _ in range(L):
        work.add_attention(fl, by, kernel=True)


def generate(work: Work, cfg: Dict, prompt: int, new_tokens: int):
    """A prompt's prefill (the last position's logits) and greedy decode
    of `new_tokens` tokens: the first from the prefill, each later one a
    one-token forward."""
    decoder(work, cfg, 0, prompt, 1)
    for i in range(max(0, new_tokens - 1)):
        decoder(work, cfg, prompt + i, 1, 1)


def vit(work: Work, t: Dict, layers: int, kernel_min_seq: int = 512):
    D, I, P = t["hidden_size"], t["intermediate_size"], t["patch_size"]
    n = (t["image_size"] // P) ** 2
    S = n + 1
    work.flops += 2.0 * n * P * P * 3 * D
    heads = t["num_heads"]
    Dh = D // heads
    for _ in range(layers):
        work.flops += 2.0 * S * (4 * D * D + 2 * D * I)
        work.add_attention(4.0 * heads * Dh * S * S,
                           BYTES * 4 * S * heads * Dh,
                           kernel=S >= kernel_min_seq)


def clip(work: Work, cfg: Dict, images: int = 1):
    t = cfg["seal"]["vision"]
    for _ in range(images):
        vit(work, t, t["num_layers"] - 1)


def linear_projector(work: Work, cfg: Dict, images: int = 1):
    n = (cfg["seal"]["vision"]["image_size"]
         // cfg["seal"]["vision"]["patch_size"]) ** 2
    work.flops += images * 2.0 * n * cfg["seal"]["projector_image"][
        "in_dim"] * cfg["hidden_size"]


def perceiver(work: Work, cfg: Dict, images: int = 1):
    p = cfg["seal"]["perceiver"]
    n = (cfg["seal"]["vision"]["image_size"]
         // cfg["seal"]["vision"]["patch_size"]) ** 2
    d, inner, lat = p["dim"], p["heads"] * p["dim_head"], p["num_latents"]
    per = (2.0 * lat * d * inner + 2.0 * (n + lat) * d * 2 * inner
           + 4.0 * lat * (n + lat) * inner + 2.0 * lat * inner * d
           + 2.0 * lat * d * p["ff_mult"] * d * 2)
    work.flops += images * (p["depth"] * per
                            + 2.0 * lat * d * cfg["hidden_size"])


def owl_detect(work: Work, cfg: Dict):
    """One patch through OWL-ViT and its heads, and the text FCs of the
    [LOC] state (SAM's small decoder is not counted)."""
    s = cfg["seal"]
    t = s["owl_vision"]
    vit(work, t, t["num_layers"])
    n = (t["image_size"] // t["patch_size"]) ** 2
    V, Q = s["owl_head"]["vision_dim"], s["owl_head"]["query_dim"]
    D = cfg["hidden_size"]
    work.flops += 2.0 * n * (V * Q + 2 * V * V + V * 4 + 2 * V)
    work.flops += 2.0 * (2 * D * D + D * (s["vsm_out_dim"]
                                           + s["vsm_seg_dim"]))
