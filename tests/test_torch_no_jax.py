"""The port and its chip smoke run without JAX and without the JAX
package: in a fresh interpreter, import every vstar_tpu_torch module (and
chip_smoke), answer one tiny SEAL request on the CPU, and find neither a
`jax` nor a `vstar_tpu` module loaded; no source imports either."""

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
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not loaded, loaded
    ported_from = sorted(m for m in sys.modules
                         if m == "vstar_tpu" or m.startswith("vstar_tpu."))
    assert not ported_from, ported_from
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
