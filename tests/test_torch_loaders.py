"""The entry points that take a checkpoint directory, from tiny HF
directories on the CPU: the directories are the port's export of random
tiny models (safetensors shards with the index), the config functions
patched to the tiny configs (config.json names only CLIP-L towers) and
the tokenizer loader to the stub. The loaders rebuild the exported
weights bit for bit (bf16 by default; quantized equal to quantizing in
memory) and their engines answer as in-memory engines on the same weights
and [LOC] id; eval/vstar_bench main (serial and --single-chip-phased
without factories), eval/search_eval main, the server's engine flags
without --random-init, train_vsm_main main and export_main run from the
directories. The `gpu` cases load on the card (the module imports no
JAX; the one CPU case that holds the trainer imports the JAX test
helpers inside it)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core import hf_config
from vstar_tpu_torch.core.checkpoint import load_torch_dir
from vstar_tpu_torch.core.hf_export import (save_safetensors,
                                            vqa_llm_state_dict,
                                            vsm_state_dict)
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.eval import search_eval, synthetic, vstar_bench
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
from vstar_tpu_torch.models.vsm import init_vsm_params, vsm_params_from_torch
from vstar_tpu_torch.multimodal import tokenizer as tok_mod
from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
from vstar_tpu_torch.nn.quant import (quantize_model_towers, quantize_weight,
                                      quantize_weight_int4,
                                      resolve_matrix_quant)
from vstar_tpu_torch.search.batched import BatchedVSMEngine

torch.set_num_threads(1)

VQA_CFG, VSM_CFG = tcfg.vqa_llm_tiny(), tcfg.vsm_tiny()
FREE_FORM_BUDGET = 12


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Random tiny f32 models exported as HF directories (16 KB shards, so
    the index is read)."""
    base = tmp_path_factory.mktemp("hf")
    params = {"vqa": init_vqa_llm_params(0, VQA_CFG, device="cpu"),
              "vsm": init_vsm_params(1, VSM_CFG, device="cpu")}
    save_safetensors(vqa_llm_state_dict(params["vqa"]), str(base / "vqa"),
                     shard_bytes=16 * 1024)
    save_safetensors(vsm_state_dict(params["vsm"]), str(base / "vsm"),
                     shard_bytes=16 * 1024)
    assert os.path.isfile(base / "vqa" / "model.safetensors.index.json")
    return {"vqa": str(base / "vqa"), "vsm": str(base / "vsm")}, params


@pytest.fixture(autouse=True)
def tiny_hooks(monkeypatch):
    """config.json cannot name the tiny towers: the loaders take the tiny
    configs; the tokenizer loader hands out the stub; free-form answers
    stop at FREE_FORM_BUDGET tokens (on loaded and in-memory engines
    alike)."""
    monkeypatch.setattr(hf_config, "vqa_llm_config_for", lambda p: VQA_CFG)
    monkeypatch.setattr(hf_config, "vsm_config_for", lambda p: VSM_CFG)
    monkeypatch.setattr(tok_mod, "load_tokenizer", lambda path, **kw:
                        StubTokenizer(VQA_CFG.llama.vocab_size))
    orig = VQAEngine.free_form

    def budget(self, *a, **kw):
        kw.setdefault("max_new_tokens", FREE_FORM_BUDGET)
        return orig(self, *a, **kw)
    monkeypatch.setattr(VQAEngine, "free_form", budget)


def _quantized(params, mode):
    """What the loaders build under `mode` from a checkpoint of `params`,
    made in memory: each decoder matrix quantized per layer from its
    checkpoint values (int4 / int8 by resolve_matrix_quant), the other
    leaves in bf16, the towers then int8."""
    cast = _recast(params, torch.bfloat16)
    llama = dict(cast["llama"])
    layers = {g: dict(v) for g, v in llama["layers"].items()}
    for grp in ("attn", "mlp"):
        for name, w in params["llama"]["layers"][grp].items():
            q = resolve_matrix_quant(mode, name)
            fn = quantize_weight_int4 if q == "int4" else quantize_weight
            parts = [fn(w[i].float()) for i in range(w.shape[0])]
            layers[grp][name] = {k: torch.stack([e[k] for e in parts])
                                 for k in parts[0]}
    llama["layers"] = layers
    q = resolve_matrix_quant(mode, "lm_head")
    llama["lm_head"] = (quantize_weight_int4 if q == "int4"
                        else quantize_weight)(
        params["llama"]["lm_head"].float())
    return quantize_model_towers(dict(cast, llama=llama))


def _same_tree(got, want):
    got, want = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            torch.equal(got[k], want[k]), k


def _engines(params):
    """In-memory engines as the loaders build them (bf16)."""
    tok = StubTokenizer(VQA_CFG.llama.vocab_size)
    return (VQAEngine(_recast(params["vqa"], torch.bfloat16), VQA_CFG, tok,
                      device="cpu"),
            BatchedVSMEngine(_recast(params["vsm"], torch.bfloat16), VSM_CFG,
                             tok, loc_token_id=3, device="cpu"))


def _recast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _recast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_recast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


@pytest.mark.parametrize("quant", [False, "int4mix"])
def test_loaders_rebuild_the_exported_weights(hf_dirs, quant):
    """load_engines gives the exported tensors back bit for bit in bf16;
    with int4='int4mix' the trees equal quantizing the same weights in
    memory; the [LOC] id is the tokenizer's."""
    dirs, params = hf_dirs
    vqa, vsm = vstar_bench.load_engines(dirs["vqa"], dirs["vsm"],
                                        device="cpu", int4=quant)
    assert vsm.loc_token_id == 3 and isinstance(vsm, BatchedVSMEngine)
    for engine, key in ((vqa, "vqa"), (vsm, "vsm")):
        want = (_quantized(params[key], quant) if quant
                else _recast(params[key], torch.bfloat16))
        _same_tree(engine.params, want)
    with pytest.raises(FileNotFoundError, match="no such checkpoint"):
        vstar_bench.load_vqa_engine(dirs["vqa"] + "_missing", device="cpu")
    # a mesh must be the world of ranks (sharded engines:
    # tests/test_torch_mesh.py)
    with pytest.raises(ValueError, match="needs 4 devices .* the world has 1"):
        vstar_bench.load_vsm_engine(dirs["vsm"], mesh="1x4x1", device="cpu")


def test_loaded_engines_answer_as_in_memory(hf_dirs):
    """A free-form answer and a detection (boxes, logits, heatmap) of the
    loaded bf16 pair equal the in-memory engines' on the same weights and
    [LOC] id."""
    dirs, params = hf_dirs
    loaded = vstar_bench.load_engines(dirs["vqa"], dirs["vsm"], device="cpu")
    memory = _engines(params)
    img = Image.fromarray((np.random.RandomState(0).rand(80, 120, 3) * 255)
                          .astype("uint8"))
    answers = [vqa.free_form(img, "what is on the table ?")
               for vqa, _ in (loaded, memory)]
    assert answers[0] == answers[1]
    dets = [vsm.detect(img, "cup") for _, vsm in (loaded, memory)]
    for a, b in zip(*dets):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bench(tmp_path):
    synthetic.make_synthetic_benchmark(str(tmp_path / "bench"), n_per_task=1,
                                       seed=0, image_hw=(256, 256), target=3)
    return str(tmp_path / "bench")


def test_eval_main_and_phased_from_hf_dirs(hf_dirs, tmp_path):
    """vstar_bench main loads the pair from --vqa-model-path /
    --vsm-model-path and writes the result JSON of eval_model on the
    in-memory pair; --single-chip-phased without factories builds its
    engines with the loaders, as phased runs on in-memory factories do."""
    dirs, params = hf_dirs
    bench = _bench(tmp_path)
    paths = ["--vqa-model-path", dirs["vqa"], "--vsm-model-path",
             dirs["vsm"], "--benchmark-folder", bench]
    got = vstar_bench.main(paths + ["--output-path",
                                    str(tmp_path / "main.json")],
                           device="cpu")
    args = vstar_bench.build_parser().parse_args(
        paths + ["--output-path", str(tmp_path / "mem.json")])
    want = vstar_bench.eval_model(args, *_engines(params))
    assert got[0] == want[0] and got[1] == want[1]
    assert json.loads((tmp_path / "main.json").read_text()) == \
        json.loads((tmp_path / "mem.json").read_text())

    phased = ["--single-chip-phased", "--image-batch", "2"]
    got = vstar_bench.main(paths + phased + ["--output-path",
                                             str(tmp_path / "ph.json")],
                           device="cpu")
    args = vstar_bench.build_parser().parse_args(
        paths + phased + ["--output-path", str(tmp_path / "ph_mem.json")])
    want = vstar_bench.eval_model(args, factories=(
        lambda: _engines(params)[0], lambda: _engines(params)[1]))
    assert got[0] == want[0] and got[2]["n_images"] == 2


def test_search_eval_main_from_hf_dir(hf_dirs, tmp_path):
    """search_eval main loads the VSM from --version and scores as
    evaluate_search on the in-memory engine."""
    dirs, params = hf_dirs
    bench = _bench(tmp_path)
    got = search_eval.main(["--version", dirs["vsm"], "--benchmark-folder",
                            bench, "--minimum_size", "300"], device="cpu")
    want = search_eval.evaluate_search(_engines(params)[1], bench,
                                       minimum_size=300)
    assert got == want


def test_server_flags_load_checkpoints(hf_dirs):
    """Without --random-init the server's (and the demo's) engine flags
    load the model paths: bf16 by default; --int4mix alone is --mixed (an
    int8 VQA decoder, the int4mix VSM decoder, int8 towers), as
    vstar_tpu resolves it."""
    import argparse

    from vstar_tpu_torch.serve import server
    dirs, params = hf_dirs
    p = argparse.ArgumentParser()
    server.add_engine_flags(p)
    base = ["--vqa-model-path", dirs["vqa"], "--vsm-model-path",
            dirs["vsm"], "--device", "cpu"]
    vqa, vsm = server.engines_from_flags(p.parse_args(base))
    _same_tree(vqa.params, _recast(params["vqa"], torch.bfloat16))
    _same_tree(vsm.params, _recast(params["vsm"], torch.bfloat16))
    vqa, vsm = server.engines_from_flags(p.parse_args(base + ["--int4mix"]))
    _same_tree(vqa.params, _quantized(params["vqa"], True))
    _same_tree(vsm.params, _quantized(params["vsm"], "int4mix"))
    assert p.parse_args([]).random_init is None


def test_train_vsm_main_and_export(hf_dirs, tmp_path):
    """train_vsm_main main builds the VSM from --version with LoRA and
    trains as run_vsm_training on the same tree does; export_main merges
    the checkpoint's LoRA and writes shards that import to the merged
    tree bit for bit."""
    from tests.test_data import WordTokenizer
    from tests.test_torch_train import make_dataset_dir
    from tests.test_torch_train_loop import _loop_args
    from vstar_tpu_torch.train import export_main, train_vsm_main
    from vstar_tpu_torch.train.lora import add_lora, merge_lora
    dirs, params = hf_dirs
    make_dataset_dir(tmp_path)
    tok = WordTokenizer()
    argv = ["--version", dirs["vsm"], "--dataset_dir", str(tmp_path),
            "--log_base_dir", str(tmp_path / "runs"), "--exp_name", "main",
            "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "1",
            "--grad_accumulation_steps", "1", "--lr", "1e-3",
            "--lora_r", "2", "--lora_alpha", "4", "--warmup_steps", "1",
            "--seq_bucket", "64", "--mask_res", "12", "--no_eval",
            "--dataset", "general_segdet||vqa", "--sample_rates", "1,1",
            "--param_dtype", "f32", "--save_steps", "0"]
    state = train_vsm_main.main(argv, tokenizer=tok, device="cpu")
    args = _loop_args(tmp_path, "direct", 1, None)
    args.lora_r, args.lora_alpha = 2, 4
    tree = dict(params["vsm"])
    tree["llama"] = add_lora(tree["llama"], 0, r=2, alpha=4)
    want = train_vsm_main.run_vsm_training(args, VSM_CFG, tree, tok, 3)
    assert state.step == want.step == 2
    _same_tree(state.params, want.params)

    ckpt = tmp_path / "runs" / "main" / "ckpt_model" / "state"
    out = tmp_path / "exported"
    sd = export_main.main(["--ckpt", str(ckpt), "--version", dirs["vsm"],
                           "--save_path", str(out), "--lora_r", "2",
                           "--lora_alpha", "4"])
    back = vsm_params_from_torch(load_torch_dir(str(out)), VSM_CFG,
                                 strict=True)
    _same_tree(back, dict(state.params,
                          llama=merge_lora(state.params["llama"])))
    assert len(sd) == len(load_torch_dir(str(out)))
    with pytest.raises(ValueError, match="LoRA"):
        export_main.main(["--ckpt", str(ckpt), "--version", dirs["vsm"],
                          "--save_path", str(out), "--lora_r", "0"])


def _kernel_cfg():
    """vqa_llm_tiny with the decoder at the kernels' head width (2 x 128)."""
    llama = dataclasses.replace(VQA_CFG.llama, hidden_size=256, num_heads=2,
                                num_kv_heads=2, head_dim=128)
    return dataclasses.replace(
        VQA_CFG, llama=llama,
        projector_image=dataclasses.replace(VQA_CFG.projector_image,
                                            out_dim=256),
        projector_object=dataclasses.replace(VQA_CFG.projector_object,
                                             out_dim=256))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, "int4mix"])
def test_loader_on_the_card(tmp_path, monkeypatch, quant):
    """On CUDA: the loader reads a bf16 export onto the card, the tensors
    equal the export bit for bit (quantized: equal to quantizing them on
    the card), and the loaded engine's free-form answer equals the
    in-memory engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _kernel_cfg()
    monkeypatch.setattr(hf_config, "vqa_llm_config_for", lambda p: cfg)
    params = _recast(init_vqa_llm_params(0, cfg, device="cuda"),
                     torch.bfloat16)
    save_safetensors(vqa_llm_state_dict(params, dtype=torch.bfloat16),
                     str(tmp_path / "vqa"), shard_bytes=1 << 20)
    eng = vstar_bench.load_vqa_engine(str(tmp_path / "vqa"), device="cuda",
                                      int4=quant)
    want = _quantized(params, quant) if quant else params
    _same_tree(eng.params, want)
    tok = StubTokenizer(cfg.llama.vocab_size)
    mem = VQAEngine(want, cfg, tok, device="cuda")
    img = Image.fromarray(np.zeros((64, 64, 3), np.uint8))
    assert eng.free_form(img, "what is this ?") == \
        mem.free_form(img, "what is this ?")
