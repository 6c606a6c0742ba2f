"""The shape of every weight of SEAL's two models, from a configuration
file alone (the names of the repository's trees, 'vqa.' / 'vsm.'
prefixed). weights.Source reads its shapes here."""

from __future__ import annotations

from typing import Dict


def _vit(out, root, t, lead_cls=True):
    D, I, L = t["hidden_size"], t["intermediate_size"], t["num_layers"]
    P = t["patch_size"]
    n = (t["image_size"] // P) ** 2 + 1
    out[root + ".patch_embed.w"] = (P * P * 3, D)
    out[root + ".position_embedding"] = (n, D)
    out[root + ".class_embedding"] = (D,)
    for ln in ("pre_ln", "post_ln"):
        out[f"{root}.{ln}.scale"] = out[f"{root}.{ln}.bias"] = (D,)
    lay = root + ".layers"
    for ln in ("ln1", "ln2"):
        out[f"{lay}.{ln}.scale"] = out[f"{lay}.{ln}.bias"] = (L, D)
    for n_ in ("wq", "wk", "wv", "wo"):
        out[f"{lay}.attn.{n_}.w"] = (L, D, D)
        out[f"{lay}.attn.{n_}.b"] = (L, D)
    out[f"{lay}.mlp.fc1.w"], out[f"{lay}.mlp.fc1.b"] = (L, D, I), (L, I)
    out[f"{lay}.mlp.fc2.w"], out[f"{lay}.mlp.fc2.b"] = (L, I, D), (L, D)


def _dense(out, root, i, o, bias=True):
    out[root + ".w"] = (i, o)
    if bias:
        out[root + ".b"] = (o,)


def _ln(out, root, d):
    out[root + ".scale"] = out[root + ".bias"] = (d,)


def _llama(out, root, cfg):
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    Hkv = cfg["num_key_value_heads"]
    Dh = D // H
    V = cfg["vocab_size"] + cfg["added_tokens"]
    out[root + ".embed_tokens"] = (V, D)
    out[root + ".lm_head"] = (D, V)
    out[root + ".final_norm.scale"] = (D,)
    lay = root + ".layers"
    out[lay + ".input_norm.scale"] = out[lay + ".post_norm.scale"] = (L, D)
    out[lay + ".attn.wq"] = (L, D, H * Dh)
    out[lay + ".attn.wk"] = out[lay + ".attn.wv"] = (L, D, Hkv * Dh)
    out[lay + ".attn.wo"] = (L, H * Dh, D)
    out[lay + ".mlp.w_gate"] = out[lay + ".mlp.w_up"] = (L, D, F)
    out[lay + ".mlp.w_down"] = (L, F, D)


def _perceiver(out, root, p, out_dim):
    D, L = p["dim"], p["depth"]
    inner = p["heads"] * p["dim_head"]
    _ln(out, root + ".pre_ln", D)
    out[root + ".latents"] = (p["num_latents"], D)
    out[root + ".media_pos_emb"] = (p["num_media_embeds"], 1, D)
    lay = root + ".layers"
    for ln in ("norm_media", "norm_latents", "ff_norm"):
        out[f"{lay}.{ln}.scale"] = out[f"{lay}.{ln}.bias"] = (L, D)
    out[lay + ".to_q.w"] = (L, D, inner)
    out[lay + ".to_kv.w"] = (L, D, 2 * inner)
    out[lay + ".to_out.w"] = (L, inner, D)
    out[lay + ".ff_in.w"] = (L, D, p["ff_mult"] * D)
    out[lay + ".ff_out.w"] = (L, p["ff_mult"] * D, D)
    _ln(out, root + ".final_norm", D)
    _dense(out, root + ".out_proj", D, out_dim)


def _sam(out, s):
    D = s["embed_dim"]
    out["prompt_encoder.pe_gaussian"] = (2, D // 2)
    out["prompt_encoder.no_mask_embed"] = (D,)
    md = "mask_decoder"
    n = s["num_multimask_outputs"] + 1
    out[md + ".iou_token"] = (1, D)
    out[md + ".mask_tokens"] = (n, D)
    inner = D // s["attention_downsample_rate"]

    def attn(root, internal):
        for x in ("q", "k", "v"):
            _dense(out, f"{root}.{x}", D, internal)
        _dense(out, root + ".out", internal, D)

    T = md + ".transformer"
    for i in range(s["transformer_depth"]):
        lp = f"{T}.layers.{i}"
        attn(lp + ".self_attn", D)
        attn(lp + ".cross_t2i", inner)
        attn(lp + ".cross_i2t", inner)
        for k in ("norm1", "norm2", "norm3", "norm4"):
            _ln(out, f"{lp}.{k}", D)
        _dense(out, lp + ".mlp_in", D, s["transformer_mlp_dim"])
        _dense(out, lp + ".mlp_out", s["transformer_mlp_dim"], D)
    attn(T + ".final_attn", inner)
    _ln(out, T + ".norm_final", D)
    out[md + ".upscale_conv1.w"] = (3, 3, D, D // 4)
    out[md + ".upscale_conv1.b"] = (D // 4,)
    _ln(out, md + ".upscale_ln", D // 4)
    out[md + ".upscale_conv2.w"] = (3, 3, D // 4, D // 8)
    out[md + ".upscale_conv2.b"] = (D // 8,)
    for i in range(n):
        h = f"{md}.hyper_mlps.{i}"
        _dense(out, h + ".fc0", D, D)
        _dense(out, h + ".fc1", D, D)
        _dense(out, h + ".fc2", D, D // 8)
    _dense(out, md + ".iou_head.fc0", D, s["iou_head_hidden_dim"])
    _dense(out, md + ".iou_head.fc1", s["iou_head_hidden_dim"],
           s["iou_head_hidden_dim"])
    _dense(out, md + ".iou_head.fc2", s["iou_head_hidden_dim"], n)


def shapes(cfg: Dict) -> Dict[str, tuple]:
    s = cfg["seal"]
    D = cfg["hidden_size"]
    vq: Dict[str, tuple] = {}
    _llama(vq, "llama", cfg)
    _vit(vq, "vision", s["vision"])
    _dense(vq, "proj_image.proj", s["projector_image"]["in_dim"], D)
    _perceiver(vq, "proj_object.perceiver", s["perceiver"], D)
    vs: Dict[str, tuple] = {}
    _llama(vs, "llama", cfg)
    _vit(vs, "vision", s["vision"])
    _dense(vs, "proj.proj", s["projector_image"]["in_dim"], D)
    ov = s["owl_vision"]
    _vit(vs, "owl_tower", ov)
    _ln(vs, "owl_merge_ln", ov["hidden_size"])
    V, Q = s["owl_head"]["vision_dim"], s["owl_head"]["query_dim"]
    _dense(vs, "owl_heads.class_head.dense0", V, Q)
    _dense(vs, "owl_heads.class_head.logit_shift", V, 1)
    _dense(vs, "owl_heads.class_head.logit_scale", V, 1)
    _dense(vs, "owl_heads.box_head.dense0", V, V)
    _dense(vs, "owl_heads.box_head.dense1", V, V)
    _dense(vs, "owl_heads.box_head.dense2", V, 4)
    vs["visual_projection.w"] = (ov["hidden_size"], s["sam"]["embed_dim"])
    _sam(vs, s["sam"])
    _dense(vs, "fc_det.fc0", D, D)
    _dense(vs, "fc_det.fc1", D, s["vsm_out_dim"])
    _dense(vs, "fc_seg.fc0", D, D)
    _dense(vs, "fc_seg.fc1", D, s["vsm_seg_dim"])
    out = {"vqa." + k: v for k, v in vq.items()}
    out.update({"vsm." + k: v for k, v in vs.items()})
    return out
