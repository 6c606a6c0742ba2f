"""Checkpoints in the HF layout: the port's safetensors reader and writer
against the `safetensors` package and the JAX package's writer (files
equal byte for byte, BF16 included, sharded with the index),
load_torch_dir on safetensors and .bin shards, config.json to configs
against vstar_tpu's hf_config field by field, the importers on JAX's
exported tiny state dicts (bit for bit at f32, and quantized), the import
audit against JAX's reports, and the export with LoRA merged (bit for
bit)."""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

import vstar_tpu.core.hf_config as jhc
from tests.test_hf_config import SEAL_VQA_7B, SEAL_VSM_7B
from vstar_tpu.core import hf_export as jex
from vstar_tpu.core import import_audit as jaudit
from vstar_tpu.core.config import vqa_llm_tiny, vsm_tiny
from vstar_tpu.models.vqa_llm import (init_vqa_llm_params,
                                      vqa_llm_params_from_torch as j_vqa_imp)
from vstar_tpu.models.vsm import (init_vsm_params,
                                  vsm_params_from_torch as j_vsm_imp)
from vstar_tpu.train.lora import add_lora as j_add_lora
from vstar_tpu_torch.core import checkpoint as ckpt
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core import hf_config as thc
from vstar_tpu_torch.core import hf_export as tex
from vstar_tpu_torch.core import import_audit as taudit
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.models.vqa_llm import vqa_llm_params_from_torch
from vstar_tpu_torch.models.vsm import vsm_params_from_torch

torch.set_num_threads(1)


def _tensors(seed=0):
    """One tensor of every dtype the reader takes, odd shapes, a scalar."""
    g = torch.Generator().manual_seed(seed)
    return {
        "w.f32": torch.randn(3, 5, generator=g),
        "w.bf16": torch.randn(7, 2, generator=g).bfloat16(),
        "w.f16": torch.randn(4, generator=g).half(),
        "q.i8": torch.randint(-128, 127, (6, 3), generator=g,
                              dtype=torch.int8),
        "q4.u8": torch.randint(0, 255, (5,), generator=g, dtype=torch.uint8),
        "ids.i32": torch.arange(9, dtype=torch.int32).reshape(3, 3),
        "pos.i64": torch.arange(4, dtype=torch.int64),
        "mask.bool": torch.tensor([True, False, True]),
        "scale": torch.tensor(2.5),
    }


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_safetensors_file_equals_the_package(tmp_path):
    """write_safetensors writes the package's bytes; each reads the
    other's file back to the same tensors, the port's reader also a file
    with metadata (as HF writes them)."""
    sd = _tensors()
    save_file(sd, str(tmp_path / "pkg.safetensors"))
    ckpt.write_safetensors(sd, str(tmp_path / "port.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "pkg.safetensors").read_bytes()
    _same(ckpt.read_safetensors(str(tmp_path / "pkg.safetensors")), sd)
    _same(load_file(str(tmp_path / "port.safetensors")), sd)
    save_file(sd, str(tmp_path / "meta.safetensors"),
              metadata={"format": "pt"})
    _same(ckpt.read_safetensors(str(tmp_path / "meta.safetensors")), sd)


def test_sharded_export_equals_jax_and_loads(tmp_path):
    """save_safetensors at a 1 KB shard cap writes JAX's shard files and
    index JSON byte for byte (f32, as JAX's writer takes numpy); the
    port's bf16 shards go through the package and load_torch_dir, which
    reads the shards the index names; .bin shards load too."""
    g = torch.Generator().manual_seed(1)
    sd = {f"layer.{i}.w": torch.randn(9, 11, generator=g) for i in range(6)}
    jex.save_safetensors({k: v.numpy() for k, v in sd.items()},
                         str(tmp_path / "jax"), shard_bytes=1024)
    tex.save_safetensors(sd, str(tmp_path / "port"), shard_bytes=1024)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and ckpt.INDEX_NAME in names   # 3 shards
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    _same(ckpt.load_torch_dir(str(tmp_path / "port")), sd)

    bf = {k: v.bfloat16() for k, v in sd.items()} | _tensors(2)
    tex.save_safetensors(bf, str(tmp_path / "bf16"), shard_bytes=512)
    index = json.loads((tmp_path / "bf16" / ckpt.INDEX_NAME).read_text())
    pkg = {}
    for fname in sorted(set(index["weight_map"].values())):
        pkg.update(load_file(str(tmp_path / "bf16" / fname)))
    _same(pkg, bf)
    # a shard the index does not name is not read
    save_file({"stray": torch.zeros(1)},
              str(tmp_path / "bf16" / "stray.safetensors"))
    _same(ckpt.load_torch_dir(str(tmp_path / "bf16")), bf)

    os.makedirs(tmp_path / "bin")
    part = dict(list(sd.items())[:3])
    torch.save(part, tmp_path / "bin" / "pytorch_model-00001-of-00002.bin")
    torch.save(dict(list(sd.items())[3:]),
               tmp_path / "bin" / "pytorch_model-00002-of-00002.bin")
    _same(ckpt.load_torch_dir(str(tmp_path / "bin")), sd)
    with pytest.raises(FileNotFoundError):
        ckpt.load_torch_dir(str(tmp_path))


HF_DICTS = {
    "vqa_7b": SEAL_VQA_7B,
    "vqa_13b": dict(SEAL_VQA_7B, hidden_size=5120, intermediate_size=13824,
                    num_hidden_layers=40, num_attention_heads=40),
    "vqa_mlp_336": dict(SEAL_VQA_7B, mm_projector_type="mlp2x_gelu",
                        mm_vision_tower="openai/clip-vit-large-patch14-336"),
    "vqa_gqa": dict(SEAL_VQA_7B, num_key_value_heads=8),
    "vsm_7b": SEAL_VSM_7B,
    "vsm_13b": dict(SEAL_VSM_7B, hidden_size=5120, intermediate_size=13824,
                    num_hidden_layers=40, num_attention_heads=40),
}


@pytest.mark.parametrize("name", sorted(HF_DICTS))
def test_hf_config_equals_jax(name):
    """Each config.json dict of tests/test_hf_config.py gives the port the
    configuration JAX derives, field by field; config_json writes a dict
    that reads back to the same configuration."""
    d = HF_DICTS[name]
    if name.startswith("vqa"):
        want, got = jhc.vqa_llm_config_from_hf(d), \
            thc.vqa_llm_config_from_hf(d)
        back = thc.vqa_llm_config_from_hf(tex.config_json(got))
    else:
        want, got = jhc.vsm_config_from_hf(d), thc.vsm_config_from_hf(d)
        back = thc.vsm_config_from_hf(tex.config_json(got))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert back == got
    assert thc.llama_config_from_hf(d) == got.llama


def test_hf_config_dir_fallback(tmp_path):
    assert thc.vqa_llm_config_for(str(tmp_path)) == tcfg.vqa_llm_7b()
    assert thc.vsm_config_for(str(tmp_path)) == tcfg.vsm_7b()
    cut = dataclasses.replace(tcfg.vsm_7b(), llama=dataclasses.replace(
        tcfg.vsm_7b().llama, num_layers=2))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(tex.config_json(cut), f)
    assert thc.vsm_config_for(str(tmp_path)) == cut


@functools.lru_cache(maxsize=None)
def _host(kind):
    if kind == "vqa":
        return jax.device_get(init_vqa_llm_params(jax.random.PRNGKey(4),
                                                  vqa_llm_tiny()))
    p = init_vsm_params(jax.random.PRNGKey(9), vsm_tiny())
    p["llama"] = j_add_lora(p["llama"], jax.random.PRNGKey(2), r=2, alpha=4)
    lora = p["llama"]["layers"]["attn"]["lora"]
    lora["wq_b"] = jax.random.normal(jax.random.PRNGKey(3),
                                     lora["wq_b"].shape) * 0.02
    return jax.device_get(p)


@functools.lru_cache(maxsize=None)
def _state_dict(kind):
    """A tiny checkpoint in JAX's layout: vstar_tpu's vsm_state_dict (LoRA
    merged); for the VQA LLM, which vstar_tpu does not export, the port's
    export (held to JAX's importer below)."""
    host = _host(kind)
    if kind == "vsm":
        return jex.vsm_state_dict(host)
    return {k: v.numpy() for k, v in
            tex.vqa_llm_state_dict(from_numpy_tree(host, "cpu")).items()}


@pytest.mark.parametrize("kind", ["vqa", "vsm"])
@pytest.mark.parametrize("quant", [False, True, "int4", "int4mix"])
def test_import_equals_jax(kind, quant):
    """The port's importer on a tiny state dict equals JAX's importer's
    tree (through core.convert) key by key, bit for bit: at f32, and with
    the decoder quantized (int8, int4, int4mix) as the loaders ask."""
    sd = _state_dict(kind)
    if kind == "vqa":
        want = j_vqa_imp(sd, vqa_llm_tiny(), quantize_llm=quant)
        got = vqa_llm_params_from_torch(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
            tcfg.vqa_llm_tiny(), quantize_llm=quant)
    else:
        want = j_vsm_imp(sd, vsm_tiny(), quantize_llm=quant)
        got = vsm_params_from_torch(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
            tcfg.vsm_tiny(), quantize_llm=quant)
    want = dict(leaves_with_path(from_numpy_tree(jax.device_get(want),
                                                 "cpu")))
    got = dict(leaves_with_path(got))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["vqa", "vsm"])
def test_export_equals_jax_with_lora_merged(kind):
    """The port's export of a tree (the VSM's with LoRA, B non-zero) equals
    JAX's export of the same tree bit for bit (the VQA LLM by its parts:
    llama_state_dict and vit_state_dict); the import of the export gives
    the merged tree back bit for bit."""
    host = _host(kind)
    tp = from_numpy_tree(host, "cpu")
    if kind == "vsm":
        want = jex.vsm_state_dict(host)
        got = tex.vsm_state_dict(tp)
    else:
        want = jex.llama_state_dict(host["llama"]) | jex.vit_state_dict(
            host["vision"], prefix="v.")
        got = tex.llama_state_dict(tp["llama"]) | tex.vit_state_dict(
            tp["vision"], prefix="v.")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and \
            np.array_equal(got[k].numpy(), want[k]), k
    if kind == "vsm":
        from vstar_tpu_torch.train.lora import merge_lora
        back = vsm_params_from_torch(got, tcfg.vsm_tiny(), strict=True)
        merged = dict(tp, llama=merge_lora(tp["llama"]))
        for (k, a), (k2, b) in zip(leaves_with_path(back),
                                   leaves_with_path(merged)):
            assert k == k2 and torch.equal(a, b), k
        half = tex.vsm_state_dict(tp, dtype=torch.bfloat16)
        assert all(torch.equal(half[k], got[k].bfloat16()) for k in got)


def _report(r):
    return dataclasses.astuple(r)


@pytest.mark.parametrize("kind", ["vqa", "vsm"])
def test_audit_reports_equal_jax(kind):
    """audit_import on a tiny state dict with a skippable key, an unknown
    key and (second case) a missing one, and strict_import's errors, as
    JAX's audit reports them."""
    sd = _state_dict(kind)
    extra = dict(sd)
    extra["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.zeros(4)
    extra["model.surprise.weight"] = np.zeros(2)
    short = dict(extra)
    short.pop("model.norm.weight")
    j_imp, t_imp = (j_vqa_imp, vqa_llm_params_from_torch) if kind == "vqa" \
        else (j_vsm_imp, vsm_params_from_torch)
    j_cfg = vqa_llm_tiny() if kind == "vqa" else vsm_tiny()
    t_cfg = tcfg.vqa_llm_tiny() if kind == "vqa" else tcfg.vsm_tiny()
    for case in (extra, short):
        want = jaudit.audit_import(case, lambda s: j_imp(s, j_cfg))
        got = taudit.audit_import(
            {k: torch.as_tensor(v) for k, v in case.items()},
            lambda s: t_imp(s, t_cfg))
        assert _report(got) == _report(want)
        assert got.summary() == want.summary()
        with pytest.raises(KeyError) as jerr:
            want.raise_on_problems()
        with pytest.raises(KeyError) as terr:
            got.raise_on_problems()
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(KeyError, match="never consumes"):
        t_imp({k: torch.as_tensor(v) for k, v in extra.items()}, t_cfg,
              strict=True)
    assert _report(taudit.audit_import(
        {k: torch.as_tensor(v) for k, v in sd.items()},
        lambda s: t_imp(s, t_cfg))).count([]) == 3


@pytest.mark.parametrize("name", ["seal_vqa_7b", "seal_vsm_7b"])
def test_manifest_audit_equals_jax(name):
    """The copied 7B manifests equal JAX's, and audit_key_list over the
    manifest's keys with one dropped, a skippable buffer and an unknown
    key reports as JAX's does."""
    keys = taudit.load_manifest(name)
    assert keys == jaudit.load_manifest(name) and len(keys) > 700
    present = keys[1:] + ["model.layers.3.self_attn.rotary_emb.inv_freq",
                          "model.owlvit.text_model.x.weight", "model.extra"]
    assert _report(taudit.audit_key_list(present, name)) == \
        _report(jaudit.audit_key_list(present, name))
    clean = taudit.audit_key_list(keys, name)
    assert (clean.unknown, clean.missing) == ([], [])
