"""The port and its chip smoke run without JAX and without the JAX
package: in a fresh interpreter, import every vstar_tpu_torch module (and
chip_smoke; the train/, data/ and utils/ modules included), answer one
tiny SEAL request and take one tiny LoRA training step on the CPU, and
find neither a `jax` nor a `vstar_tpu` module loaded (nor `safetensors`
or `transformers`); no source imports jax or vstar_tpu."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import numpy as np
    import torch
    from PIL import Image
    torch.set_num_threads(1)
    import vstar_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(vstar_tpu_torch.__path__,
                                                   "vstar_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    from vstar_tpu_torch.serve.server import SealService, random_init_engines
    vqa, vsm = random_init_engines("tiny", "cpu")
    img = Image.fromarray((np.random.RandomState(0).rand(90, 150, 3)
                           * 255).astype("uint8"))
    rec = SealService(vqa, vsm).answer(img, "what color?", ["red", "blue"])
    assert rec["option_chosen"] in (0, 1), rec
    from vstar_tpu_torch.core.config import vsm_tiny
    from vstar_tpu_torch.data.vsm_collate import (VSMRow, batch_to_torch,
                                                  collate_vsm_rows)
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train.lora import add_lora, vsm_trainable_mask
    from vstar_tpu_torch.train.vsm_train import (
        init_train_state, make_vsm_optimizer, vsm_train_step)
    cfg = vsm_tiny()
    params = init_vsm_params(0, cfg, device="cpu")
    params["llama"] = add_lora(params["llama"], 1, r=2, alpha=4)
    mask = vsm_trainable_mask(params)
    opt = make_vsm_optimizer(warmup_steps=0, trainable_mask=mask)
    rng = np.random.RandomState(0)
    rows = [VSMRow(image_clip=rng.randn(28, 28, 3).astype("float32"),
                   image_owl=rng.randn(48, 48, 3).astype("float32"),
                   source=[{"from": "human",
                            "value": "<image>\\nPlease locate the cup."},
                           {"from": "gpt", "value": "Sure, [LOC]."}],
                   gt_mask=(rng.rand(20, 20) > 0.5).astype("float32"),
                   mask_valid=True,
                   tgt_boxes=np.array([[0.5, 0.5, 0.2, 0.3]], "float32"),
                   bboxes_valid=True)] * 2
    batch = batch_to_torch(collate_vsm_rows(
        rows, StubTokenizer(cfg.llama.vocab_size), 3, n_image_tokens=4,
        seq_bucket=64, t_max=4, mask_res=12), "cpu")
    state, m = vsm_train_step(init_train_state(params, opt), batch, cfg,
                              opt, mask, grad_accum=2)
    assert state.step == 1 and bool(torch.isfinite(m["loss"])), m
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not loaded, loaded
    ported_from = sorted(m for m in sys.modules
                         if m == "vstar_tpu" or m.startswith("vstar_tpu."))
    assert not ported_from, ported_from
    # the port reads and writes safetensors itself and imports
    # transformers only inside load_tokenizer
    libs = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("safetensors", "transformers"))
    assert not libs, libs
    print("modules", len(names))
""")


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def _port_sources():
    return sorted((ROOT / "vstar_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    assert [str(f) for f in _port_sources() if pat.search(f.read_text())] \
        == []


def test_port_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+vstar_tpu(\.|\s|$)", re.M)
    assert not pat.search("from vstar_tpu_torch.nn import quant")
    assert pat.search("    from vstar_tpu.core.config import X")
    assert [str(f) for f in _port_sources() if pat.search(f.read_text())] \
        == []
