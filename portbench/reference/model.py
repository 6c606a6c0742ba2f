"""The plain reference of SEAL's two models, in float32 with TF32 off.

Plain PyTorch and nothing else: no kernel, no cache, no batching of
ragged rows, no import of the program. It follows the published
architectures as SEAL uses them (LLaVA's CLIP ViT-L/14 tower and linear
projector, the Flamingo perceiver resampler, a LLaMA-family decoder with
grouped-query attention, OWL-ViT B/16 with its class and box heads, SAM's
prompt encoder and two-way mask decoder), with the parameter names of
the repository's trees. Weights come from a `weights.Source`, which makes
each leaf (or one layer of a stack) again from the seed, so only one
layer of a stack is alive at a time.

`Ref.q`, when set, maps every matmul input (activations and weights) to
a lower precision: the control's fp8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def plain_precision():
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def layernorm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def softmax_attention(q, k, v, causal: bool = False):
    """q [Sq, H, Dh], k / v [Sk, H, Dh] -> [Sq, H * Dh]."""
    Dh = q.shape[-1]
    logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(Dh)
    if causal:
        Sq, Sk = q.shape[0], k.shape[0]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(q.shape[0], -1)


class Ref:
    """The reference over one model's weights (a weights.Source) and its
    configuration file's dict."""

    def __init__(self, src, cfg: Dict, q: Optional[Callable] = None):
        self.src, self.cfg, self.q = src, cfg, q
        self._whole: Dict[str, torch.Tensor] = {}

    # -- elementary ------------------------------------------------------

    def w(self, path, layer=None):
        """A weight; a leaf outside the layer stacks is made once."""
        if layer is not None:
            return self.src.get(path, layer)
        if path not in self._whole:
            self._whole[path] = self.src.get(path)
        return self._whole[path]

    def mm(self, x, w):
        if self.q is not None:
            x, w = self.q(x, -1), self.q(w, 0)
        return x @ w

    def dense(self, x, path, layer=None, bias=True):
        y = self.mm(x, self.w(path + ".w", layer))
        return y + self.w(path + ".b", layer) if bias else y

    def ln(self, x, path, layer=None, eps=1e-5):
        return layernorm(x, self.w(path + ".scale", layer),
                         self.w(path + ".bias", layer), eps)

    # -- vision towers ---------------------------------------------------

    def vit(self, root: str, tcfg: Dict, px: torch.Tensor, n_layers: int,
            post_ln: bool) -> torch.Tensor:
        """Pre-LN ViT over normalized NHWC pixels -> [B, 1 + N, D]."""
        B, H, W, C = px.shape
        P, D, heads = tcfg["patch_size"], tcfg["hidden_size"], \
            tcfg["num_heads"]
        eps = tcfg["layer_norm_eps"]
        g = H // P
        x = px.reshape(B, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5)
        x = self.mm(x.reshape(B, g * g, P * P * C),
                    self.w(root + ".patch_embed.w"))
        cls = self.w(root + ".class_embedding")
        x = torch.cat([cls.expand(B, 1, D), x], 1)
        x = x + self.w(root + ".position_embedding")[None]
        x = self.ln(x, root + ".pre_ln", eps=eps)
        L = root + ".layers"
        for i in range(n_layers):
            h = self.ln(x, L + ".ln1", i, eps)
            qkv = [self.dense(h, f"{L}.attn.{n}", i).reshape(B, -1, heads,
                                                              D // heads)
                   for n in ("wq", "wk", "wv")]
            att = torch.stack([softmax_attention(qkv[0][b], qkv[1][b],
                                                 qkv[2][b])
                               for b in range(B)])
            x = x + self.dense(att, L + ".attn.wo", i)
            h = self.ln(x, L + ".ln2", i, eps)
            x = x + self.dense(quick_gelu(self.dense(h, L + ".mlp.fc1", i)),
                               L + ".mlp.fc2", i)
        if post_ln:
            x = self.ln(x, root + ".post_ln", eps=eps)
        return x

    def clip_features(self, px: torch.Tensor) -> torch.Tensor:
        """LLaVA's features: the penultimate layer's patches [B, 256, D]."""
        t = self.cfg["seal"]["vision"]
        return self.vit("vision", t, px, t["num_layers"] - 1, False)[:, 1:]

    def owl_feature_map(self, px: torch.Tensor) -> torch.Tensor:
        """OWL-ViT's map [B, N, D]: post-LN patches times the CLS state,
        then the merge layernorm."""
        t = self.cfg["seal"]["owl_vision"]
        x = self.vit("owl_tower", t, px, t["num_layers"], True)
        return self.ln(x[:, 1:] * x[:, :1], "owl_merge_ln",
                       eps=t["layer_norm_eps"])

    def perceiver(self, root: str, media: torch.Tensor) -> torch.Tensor:
        """Flamingo resampler [B, N, d] -> [B, latents, out]."""
        p = self.cfg["seal"]["perceiver"]
        H, Dh = p["heads"], p["dim_head"]
        x = self.ln(media, root + ".pre_ln")
        x = x + self.w(root + ".media_pos_emb")[0][None]
        lat = self.w(root + ".latents")[None].expand(x.shape[0], -1, -1)
        L = root + ".layers"
        for i in range(p["depth"]):
            xm = self.ln(x, L + ".norm_media", i)
            xl = self.ln(lat, L + ".norm_latents", i)
            q = self.dense(xl, L + ".to_q", i, bias=False)
            kv = self.dense(torch.cat([xm, xl], 1), L + ".to_kv", i,
                            bias=False)
            k, v = kv.chunk(2, dim=-1)
            B = q.shape[0]
            att = torch.stack([softmax_attention(
                q[b].reshape(-1, H, Dh), k[b].reshape(-1, H, Dh),
                v[b].reshape(-1, H, Dh)) for b in range(B)])
            lat = lat + self.dense(att, L + ".to_out", i, bias=False)
            h = self.ln(lat, L + ".ff_norm", i)
            lat = lat + self.dense(
                F.gelu(self.dense(h, L + ".ff_in", i, bias=False)),
                L + ".ff_out", i, bias=False)
        lat = self.ln(lat, root + ".final_norm")
        return self.dense(lat, root + ".out_proj")

    # -- decoder ---------------------------------------------------------

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        table = self.w("llama.embed_tokens")
        idx = torch.tensor([max(int(i), 0) for i in ids],
                           device=table.device)
        return table[idx]

    def decoder(self, seqs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Causal LLaMA stack over each row's embeddings [S_i, D] (one row
        at a time, layer by layer) -> final-norm hidden states."""
        c = self.cfg
        D, H = c["hidden_size"], c["num_attention_heads"]
        Hkv, Dh = c["num_key_value_heads"], c["hidden_size"] // \
            c["num_attention_heads"]
        eps, theta = c["rms_norm_eps"], c["rope_theta"]
        dev = seqs[0].device
        ropes = []
        for s in seqs:
            pos = torch.arange(s.shape[0], device=dev, dtype=torch.float32)
            inv = 1.0 / theta ** (torch.arange(0, Dh, 2, device=dev,
                                               dtype=torch.float32) / Dh)
            ang = pos[:, None] * inv[None]
            ang = torch.cat([ang, ang], -1)
            ropes.append((ang.cos()[:, None], ang.sin()[:, None]))

        def rope(x, cs):
            cos, sin = cs
            half = x.shape[-1] // 2
            rot = torch.cat([-x[..., half:], x[..., :half]], -1)
            return x * cos + rot * sin

        xs = [s.clone() for s in seqs]
        L = "llama.layers"
        for i in range(c["num_hidden_layers"]):
            wq, wk, wv, wo = (self.w(f"{L}.attn.{n}", i)
                              for n in ("wq", "wk", "wv", "wo"))
            n_in = self.w(L + ".input_norm.scale", i)
            n_post = self.w(L + ".post_norm.scale", i)
            wg, wu, wd = (self.w(f"{L}.mlp.{n}", i)
                          for n in ("w_gate", "w_up", "w_down"))
            for r, x in enumerate(xs):
                S = x.shape[0]
                h = rmsnorm(x, n_in, eps)
                q = rope(self.mm(h, wq).reshape(S, H, Dh), ropes[r])
                k = rope(self.mm(h, wk).reshape(S, Hkv, Dh), ropes[r])
                v = self.mm(h, wv).reshape(S, Hkv, Dh)
                k = k.repeat_interleave(H // Hkv, dim=1)
                v = v.repeat_interleave(H // Hkv, dim=1)
                x = x + self.mm(softmax_attention(q, k, v, causal=True), wo)
                h = rmsnorm(x, n_post, eps)
                x = x + self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wu), wd)
                xs[r] = x
            del wq, wk, wv, wo, wg, wu, wd
        fin = self.w("llama.final_norm.scale")
        return [rmsnorm(x, fin, eps) for x in xs]

    def logits(self, hidden: torch.Tensor, block: int = 256) -> torch.Tensor:
        """lm_head over hidden states [n, D] -> [n, V], by blocks of rows."""
        head = self.w("llama.lm_head")
        return torch.cat([self.mm(hidden[a:a + block], head)
                          for a in range(0, hidden.shape[0], block)])

    # -- the VSM's heads -------------------------------------------------

    def text_fc(self, root: str, h: torch.Tensor) -> torch.Tensor:
        return self.dense(F.relu(self.dense(h, root + ".fc0")),
                          root + ".fc1")

    def owl_heads(self, fmap: torch.Tensor, query: torch.Tensor):
        """fmap [B, N, V], query [B, qd] -> (logits [B, N], boxes
        [B, N, 4] cxcywh)."""
        c = "owl_heads.class_head"
        img = self.dense(fmap, c + ".dense0")
        img = img / (img.norm(dim=-1, keepdim=True) + 1e-6)
        qn = query / (query.norm(dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("bnd,bd->bn", img, qn)
        shift = self.dense(fmap, c + ".logit_shift")[..., 0]
        scale = F.elu(self.dense(fmap, c + ".logit_scale")[..., 0]) + 1.0
        logits = (logits + shift) * scale
        b = "owl_heads.box_head"
        x = F.gelu(self.dense(fmap, b + ".dense0"))
        x = F.gelu(self.dense(x, b + ".dense1"))
        x = self.dense(x, b + ".dense2")
        n = int(round(math.sqrt(fmap.shape[1])))
        grid = np.stack(np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1)),
                        -1).reshape(-1, 2) / n
        coord = np.log(grid + 1e-4) - np.log1p(-grid + 1e-4)
        size = np.full_like(coord, np.log(1.0 / n + 1e-4)
                            - np.log1p(-1.0 / n + 1e-4))
        bias = torch.tensor(np.concatenate([coord, size], -1),
                            dtype=torch.float32, device=x.device)
        return logits, torch.sigmoid(x + bias)

    def _sam_attn(self, root, q, k, v, heads):
        qq, kk, vv = (self.dense(t, f"{root}.{n}")
                      for t, n in ((q, "q"), (k, "k"), (v, "v")))
        B, I = qq.shape[0], qq.shape[-1]
        out = torch.stack([softmax_attention(
            qq[b].reshape(-1, heads, I // heads),
            kk[b].reshape(-1, heads, I // heads),
            vv[b].reshape(-1, heads, I // heads)) for b in range(B)])
        return self.dense(out, root + ".out")

    def sam_mask(self, fmap: torch.Tensor, text: torch.Tensor
                 ) -> torch.Tensor:
        """SAM with one text prompt token: fmap [B, N, 768] (the OWL map),
        text [B, 256] -> the single-mask low-res logits [B, 4h, 4w]."""
        s = self.cfg["seal"]["sam"]
        D, heads = s["embed_dim"], s["transformer_num_heads"]
        h = w = int(round(math.sqrt(fmap.shape[1])))
        B = fmap.shape[0]
        img = self.mm(fmap, self.w("visual_projection.w"))
        src = img + self.w("prompt_encoder.no_mask_embed")
        gauss = self.w("prompt_encoder.pe_gaussian")
        ys = (torch.arange(h, device=img.device) + 0.5) / h
        xs = (torch.arange(w, device=img.device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx, gy], -1).reshape(h * w, 2)
        pe = 2 * math.pi * ((2 * coords - 1) @ gauss)
        pe = torch.cat([pe.sin(), pe.cos()], -1)[None].expand(B, -1, -1)
        md = "mask_decoder"
        n_masks = s["num_multimask_outputs"] + 1
        out_tokens = torch.cat([self.w(md + ".iou_token"),
                                self.w(md + ".mask_tokens")], 0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1),
                            text[:, None]], 1)
        queries, keys = tokens, src
        T = md + ".transformer"
        for i in range(s["transformer_depth"]):
            lp = f"{T}.layers.{i}"
            if i == 0:
                queries = self._sam_attn(lp + ".self_attn", queries, queries,
                                         queries, heads)
            else:
                qq = queries + tokens
                queries = queries + self._sam_attn(lp + ".self_attn", qq, qq,
                                                   queries, heads)
            queries = self.ln(queries, lp + ".norm1")
            queries = queries + self._sam_attn(
                lp + ".cross_t2i", queries + tokens, keys + pe, keys, heads)
            queries = self.ln(queries, lp + ".norm2")
            mlp = self.dense(F.relu(self.dense(queries, lp + ".mlp_in")),
                             lp + ".mlp_out")
            queries = self.ln(queries + mlp, lp + ".norm3")
            keys = self.ln(keys + self._sam_attn(
                lp + ".cross_i2t", keys + pe, queries + tokens, queries,
                heads), lp + ".norm4")
        queries = queries + self._sam_attn(T + ".final_attn", queries + tokens,
                                           keys + pe, keys, heads)
        queries = self.ln(queries, T + ".norm_final")
        mask_tokens = queries[:, 1:1 + n_masks]

        def up2(x):                      # NHWC bilinear x2, half-pixel
            return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                 mode="bilinear", align_corners=False
                                 ).permute(0, 2, 3, 1)

        def conv(x, root):
            wt = self.w(root + ".w").permute(3, 2, 0, 1)
            x = x.permute(0, 3, 1, 2)
            if self.q is not None:
                x, wt = self.q(x, 1), self.q(wt, 1)
            return F.conv2d(x, wt, padding=1).permute(0, 2, 3, 1) \
                + self.w(root + ".b")

        up = conv(up2(keys.reshape(B, h, w, D)), md + ".upscale_conv1")
        up = F.gelu(self.ln(up, md + ".upscale_ln", eps=1e-6))
        up = F.gelu(conv(up2(up), md + ".upscale_conv2"))

        def mlp3(root, x):
            x = F.relu(self.dense(x, root + ".fc0"))
            x = F.relu(self.dense(x, root + ".fc1"))
            return self.dense(x, root + ".fc2")

        hyper = mlp3(md + ".hyper_mlps.0", mask_tokens[:, 0])   # [B, D/8]
        masks = torch.einsum("bc,bpc->bp", hyper,
                             up.reshape(B, 16 * h * w, -1))
        return masks.reshape(B, 4 * h, 4 * w)


def fp8_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along every axis
    but `dim` (a row of activations, a column of weights), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale
