"""Module parity: each ported module against its vstar_tpu counterpart on
the same numpy-seeded inputs and the same weights (JAX init, bridged by
vstar_tpu_torch.core.convert), in f32 at tiny widths, atol 1e-4; each
side is built from its own package's configs. Also checks that the
port's 7B parameter trees (built on the meta device), bf16 and quantized,
have the JAX trees' names, shapes and dtypes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.core.config import (ProjectorConfig, ViTConfig, vqa_llm_7b,
                                   vqa_llm_tiny, vsm_7b, vsm_tiny)
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.models.vsm import init_vsm_params as jax_init_vsm
from vstar_tpu.multimodal import splicing as jsplice
from vstar_tpu.nn import llama as jllama
from vstar_tpu.nn import owl_heads as jowl
from vstar_tpu.nn import projectors as jproj
from vstar_tpu.nn import sam as jsam
from vstar_tpu.nn import vit as jvit
from vstar_tpu.nn.basic import init_layernorm as jax_init_layernorm
from vstar_tpu.models import vqa_llm as jvqa
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.models import vqa_llm as tvqa
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
from vstar_tpu_torch.models.vsm import init_vsm_params
from vstar_tpu_torch.multimodal import splicing as tsplice
from vstar_tpu_torch.nn import llama as tllama
from vstar_tpu_torch.nn import owl_heads as towl
from vstar_tpu_torch.nn import projectors as tproj
from vstar_tpu_torch.nn.quant import qdot, quantize_weight
from vstar_tpu_torch.nn import sam as tsam
from vstar_tpu_torch.nn import vit as tvit

torch.set_num_threads(1)

ATOL = 1e-4


def bridge(params):
    return from_numpy_tree(jax.device_get(params), "cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def test_llama_prefill_decode_option_chunk():
    cfg = vqa_llm_tiny().llama
    tc = tcfg.vqa_llm_tiny().llama
    jp = jllama.init_llama_params(jax.random.PRNGKey(3), cfg)
    tp = bridge(jp)
    rng = np.random.RandomState(0)
    B, S, Smax, D = 2, 12, 40, cfg.hidden_size
    lens = np.array([12, 9], np.int32)
    jcache = jllama.init_cache(cfg, B, Smax, jnp.float32)
    tcache = tllama.init_cache(tc, B, Smax, torch.float32, device="cpu")

    def step(h, pos, kv_lens, offs):
        nonlocal jcache, tcache
        jh, jcache = jllama.llama_forward(
            jp, cfg, jnp.asarray(h), jnp.asarray(pos), jnp.asarray(kv_lens),
            q_offsets=jnp.asarray(offs), cache=jcache)
        th, tcache = tllama.llama_forward(
            tp, tc, t(h), t(pos), t(kv_lens), q_offsets=t(offs),
            cache=tcache)
        close(th, jh)
        for row, n in enumerate(kv_lens):
            close(tcache.k[:, row, :n], jcache.k[:, row, :n])
            close(tcache.v[:, row, :n], jcache.v[:, row, :n])
        assert tcache.length.tolist() == list(kv_lens)

    # prefill, then one cached decode token per row
    step(rng.randn(B, S, D).astype(np.float32),
         np.broadcast_to(np.arange(S), (B, S)).astype(np.int32), lens,
         np.zeros(B, np.int32))
    step(rng.randn(B, 1, D).astype(np.float32), lens[:, None], lens + 1,
         lens)
    # an option chunk of 5 slots over the prefix, ragged valid lengths
    prefix = lens + 1
    step(rng.randn(B, 5, D).astype(np.float32),
         (prefix[:, None] + np.arange(5)).astype(np.int32),
         prefix + np.array([5, 3], np.int32), prefix)

    ids = np.array([[-200, 5, 7], [3, -1, 0]], np.int32)
    close(tllama.embed_tokens(tp, t(ids), torch.float32),
          jllama.embed_tokens(jp, jnp.asarray(ids), jnp.float32))
    h = rng.randn(B, 3, D).astype(np.float32)
    close(tllama.lm_logits(tp, t(h)), jllama.lm_logits(jp, jnp.asarray(h)))


def test_llama_gqa_repeat():
    cfg = dataclasses.replace(vqa_llm_tiny().llama, num_kv_heads=2)
    jp = jllama.init_llama_params(jax.random.PRNGKey(4), cfg)
    rng = np.random.RandomState(1)
    h = rng.randn(1, 6, cfg.hidden_size).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    lens = np.array([6], np.int32)
    want, _ = jllama.llama_forward(jp, cfg, jnp.asarray(h),
                                   jnp.asarray(pos), jnp.asarray(lens))
    tc = dataclasses.replace(tcfg.vqa_llm_tiny().llama, num_kv_heads=2)
    got, _ = tllama.llama_forward(bridge(jp), tc, t(h), t(pos), t(lens))
    close(got, want)


def test_vqa_prefill_and_decode_step():
    """models/vqa_llm: bank encode, spliced prefill and one decode step."""
    cfg, tc = vqa_llm_tiny(), tcfg.vqa_llm_tiny()
    jp = jax_init_vqa(jax.random.PRNGKey(9), cfg)
    tp = bridge(jp)
    rng = np.random.RandomState(8)
    img = (rng.rand(2, 28, 28, 3) * 255).astype(np.uint8)
    objs = (rng.rand(2, cfg.max_objects, 28, 28, 3) * 255).astype(np.uint8)
    jbank = jvqa.encode_feature_bank(jp, cfg, jnp.asarray(img),
                                     jnp.asarray(objs))
    tbank = tvqa.encode_feature_bank(tp, tc, t(img), t(objs))
    close(tbank, jbank)
    ids = [1, 7, -200, 9, 11]
    lays = [tsplice.build_layout(ids, 16, n_long=4, n_short=4,
                                 image_long=il) for il in (True, False)]
    arrs = {k: np.stack([getattr(lay, k) for lay in lays])
            for k in ("text_ids", "feat_idx", "is_feat")}
    lens = np.array([lay.length for lay in lays], np.int32)
    jcache = jllama.init_cache(cfg.llama, 2, 32, jnp.float32)
    tcache = tllama.init_cache(tc.llama, 2, 32, torch.float32, device="cpu")
    jl, jh, jcache = jvqa.prefill(
        jp, cfg, jbank, *(jnp.asarray(arrs[k]) for k in
                          ("text_ids", "feat_idx", "is_feat")),
        jnp.asarray(lens), jcache, jnp.float32)
    tl, th, tcache = tvqa.prefill(
        tp, tc, tbank, *(t(arrs[k]) for k in
                          ("text_ids", "feat_idx", "is_feat")),
        t(lens), tcache, torch.float32)
    close(tl, jl)
    close(th, jh)
    tok = np.array([[5], [6]], np.int32)
    jl, jh, jcache = jvqa.decode_step(jp, cfg, jcache, jnp.asarray(tok),
                                      jnp.float32)
    tl, th, tcache = tvqa.decode_step(tp, tc, tcache, t(tok),
                                      torch.float32)
    close(tl, jl)
    close(th, jh)
    assert tcache.length.tolist() == np.asarray(jcache.length).tolist()


def test_convert_bf16_leaves_and_refuses_quantized():
    """bf16 leaves cross bit for bit; quantized entries (which the port
    refused before its quantized kernels existed) now cross with their
    int8 / uint8 / f32 leaves, and qdot on them matches JAX's."""
    w = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    out = from_numpy_tree({"a": [jax.device_get(jnp.asarray(w, jnp.bfloat16))],
                           "n": np.arange(3, dtype=np.int32)}, "cpu")
    assert out["a"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["a"][0].float().numpy(),
        np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32)))
    assert out["n"].dtype == torch.int32 and out["n"].tolist() == [0, 1, 2]
    from vstar_tpu.nn.quant import qdot as jax_qdot
    from vstar_tpu.nn.quant import quantize_weight_int4_np, quantize_weight_np
    tree = {"attn": {"wq": quantize_weight_np(w),
                     "w4": quantize_weight_int4_np(w),
                     "tower": dict(quantize_weight_np(w), b=w[0])}}
    got = from_numpy_tree(tree, "cpu")
    assert {k: v.dtype for k, v in got["attn"]["wq"].items()} == \
        {"q": torch.int8, "s": torch.float32}
    assert {k: v.dtype for k, v in got["attn"]["w4"].items()} == \
        {"q4": torch.uint8, "s4": torch.float32}
    assert sorted(got["attn"]["tower"]) == ["b", "q", "s"]
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    for key in ("wq", "w4"):
        want = jax_qdot(jnp.asarray(x), jax.tree_util.tree_map(
            jnp.asarray, tree["attn"][key]))
        close(qdot(t(x), got["attn"][key]), want, atol=1e-5)
    np.testing.assert_array_equal(
        got["attn"]["wq"]["q"].numpy(), quantize_weight(t(w))["q"].numpy())


# ---------------------------------------------------------------------------
# Vision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["clip", "owl", "tower_gate"])
def test_vit_paths(which):
    rng = np.random.RandomState(2)
    if which == "clip":
        cfg, tc = vqa_llm_tiny().vision, tcfg.vqa_llm_tiny().vision
    elif which == "owl":
        cfg, tc = vsm_tiny().owl_vision, tcfg.vsm_tiny().owl_vision
    else:   # 23x23 patches + CLS = 530 tokens: the S >= 512 tower path
        kw = dict(image_size=368, patch_size=16, hidden_size=32,
                  intermediate_size=64, num_layers=1, num_heads=4,
                  feature_layer=-1)
        cfg, tc = ViTConfig(**kw), tcfg.ViTConfig(**kw)
    jp = jvit.init_vit_params(jax.random.PRNGKey(5), cfg)
    tp = bridge(jp)
    px = rng.randn(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    if which == "clip":
        want = jvit.clip_patch_features(jp, cfg, jnp.asarray(px))
        got = tvit.clip_patch_features(tp, tc, t(px))
    else:
        ln = jax_init_layernorm(cfg.hidden_size)
        ln = {"scale": ln["scale"] + 0.1, "bias": ln["bias"] - 0.2}
        want = jvit.owlvit_feature_map(jp, cfg, ln, jnp.asarray(px))
        got = tvit.owlvit_feature_map(tp, tc, bridge(ln), t(px))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


@pytest.mark.parametrize("kind", ["linear", "mlp2x_gelu", "perceiver"])
def test_projectors(kind):
    base, tbase = vqa_llm_tiny(), tcfg.vqa_llm_tiny()
    cfg, tc = {"linear": (base.projector_image, tbase.projector_image),
               "mlp2x_gelu": (ProjectorConfig(type="mlp2x_gelu", in_dim=32,
                                              out_dim=64),
                              tcfg.ProjectorConfig(type="mlp2x_gelu",
                                                   in_dim=32, out_dim=64)),
               "perceiver": (base.projector_object,
                             tbase.projector_object)}[kind]
    jp = jproj.init_projector_params(jax.random.PRNGKey(6), cfg)
    feats = np.random.RandomState(3).randn(2, 4, 32).astype(np.float32)
    want = jproj.apply_projector(jp, cfg, jnp.asarray(feats))
    got = tproj.apply_projector(bridge(jp), tc, t(feats))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


def test_owl_heads():
    cfg = vsm_tiny().owl_head
    jp = jowl.init_owl_head_params(jax.random.PRNGKey(7), cfg)
    rng = np.random.RandomState(4)
    fmap = rng.randn(2, 3, 3, cfg.vision_dim).astype(np.float32)
    query = rng.randn(2, 1, cfg.query_dim).astype(np.float32)
    jl, jb = jowl.owl_detect(jp, cfg, jnp.asarray(fmap), jnp.asarray(query))
    tl, tb = towl.owl_detect(bridge(jp), tcfg.vsm_tiny().owl_head, t(fmap),
                             t(query))
    close(tl, jl)
    close(tb, jb)


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------

def test_sam_mask_decoder():
    cfg, tc = vsm_tiny().sam, tcfg.vsm_tiny().sam
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    jpe = jsam.init_prompt_encoder_params(k1, cfg)
    jdec = jsam.init_mask_decoder_params(k2, cfg)
    tpe, tdec = bridge(jpe), bridge(jdec)
    rng = np.random.RandomState(5)
    h, w = cfg.image_embedding_size
    img = rng.randn(2, h, w, cfg.embed_dim).astype(np.float32)
    text = rng.randn(2, 1, cfg.embed_dim).astype(np.float32)

    jpos = jsam.dense_positional_encoding(jpe, cfg)
    tpos = tsam.dense_positional_encoding(tpe, tc)
    close(tpos, jpos)
    js, jd = jsam.encode_text_prompt(jpe, cfg, jnp.asarray(text))
    ts, td = tsam.encode_text_prompt(tpe, tc, t(text))
    close(td, jd)
    jm, jiou = jsam.mask_decoder(jdec, cfg, jnp.asarray(img), jpos, js, jd)
    tm, tiou = tsam.mask_decoder(tdec, tc, t(img), tpos, ts, td)
    assert tuple(tm.shape) == tuple(jm.shape)
    close(tm, jm)
    close(tiou, jiou)


def test_sam_upsample_edges_and_conv():
    """jax.image.resize 'bilinear' vs F.interpolate(align_corners=False):
    equal everywhere, edges included (both clamp to the border pixel);
    the NHWC/HWIO conv against F.conv2d's NCHW/OIHW."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    got = tsam._upsample2x(t(x)).numpy()
    want = np.asarray(jsam._upsample2x(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], atol=1e-6)
    p = {"w": rng.randn(3, 3, 3, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    close(tsam._conv3x3(bridge(p), t(x)),
          jsam._conv3x3({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)), atol=1e-5)


# ---------------------------------------------------------------------------
# Splicing
# ---------------------------------------------------------------------------

def test_splice_layout_and_apply():
    ids = [1, 5, -200, 9, -300, 11, -300, 12]
    kw = dict(n_long=6, n_short=2, image_long=False,
              objects_long=[True, False])
    want = jsplice.build_layout(ids, 24, **kw)
    got = tsplice.build_layout(ids, 24, **kw)
    for name in ("text_ids", "feat_idx", "is_feat"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert got.length == want.length == jsplice.spliced_length(ids, **kw) \
        == tsplice.spliced_length(ids, **kw)
    rng = np.random.RandomState(7)
    tok = rng.randn(2, 24, 8).astype(np.float32)
    bank = rng.randn(2, 3 * 8, 8).astype(np.float32)
    fi = np.stack([got.feat_idx] * 2)
    isf = np.stack([got.is_feat] * 2)
    close(tsplice.apply_splice(t(tok), t(bank), t(fi), t(isf)),
          jsplice.apply_splice(jnp.asarray(tok), jnp.asarray(bank),
                               jnp.asarray(fi), jnp.asarray(isf)), atol=0)
    with pytest.raises(ValueError, match="bucket"):
        tsplice.build_layout(ids, 8, **kw)


# ---------------------------------------------------------------------------
# Full-width parameter trees, at no memory cost
# ---------------------------------------------------------------------------

def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def _shapes(tree):
    return {path: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for path, x in flatten(tree)}


@pytest.mark.parametrize("model", ["vqa", "vsm"])
def test_7b_param_tree_matches_jax(model):
    if model == "vqa":
        cfg = vqa_llm_7b()
        want = jax.eval_shape(lambda k: jax_init_vqa(k, cfg, jnp.bfloat16),
                              jax.random.PRNGKey(0))
        got = init_vqa_llm_params(0, tcfg.vqa_llm_7b(), device="meta",
                                  dtype=torch.bfloat16)
    else:
        cfg = vsm_7b()
        want = jax.eval_shape(lambda k: jax_init_vsm(k, cfg, jnp.bfloat16),
                              jax.random.PRNGKey(0))
        got = init_vsm_params(0, tcfg.vsm_7b(), device="meta",
                              dtype=torch.bfloat16)
    assert all(x.device.type == "meta" for _, x in flatten(got))
    assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("quantize", [True, "int4", "int4mix"])
def test_7b_quantized_param_tree_matches_jax(quantize):
    """The quantized 7B trees (the VQA decoder of --mixed / --int4mix is
    int8, the VSM's int4 or int4mix; towers int8 as quantize_model_towers
    leaves them) have the JAX trees' names, shapes and dtypes."""
    from vstar_tpu.nn.quant import quantize_model_towers as jax_towers
    from vstar_tpu_torch.nn.quant import quantize_model_towers
    want = jax.eval_shape(
        lambda k: jax_towers(jax_init_vsm(k, vsm_7b(), jnp.bfloat16,
                                          quantize_llm=quantize)),
        jax.random.PRNGKey(0))
    got = quantize_model_towers(init_vsm_params(
        0, tcfg.vsm_7b(), device="meta", dtype=torch.bfloat16,
        quantize_llm=quantize))
    assert _shapes(got) == _shapes(want)
