"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which `ctypes` loads. The library lives
in `vstar_tpu_torch/_build/`, named by a hash of the sources and flags,
and is built at first use. There is no fallback: a missing `nvcc` or a
failed build raises.

Each C entry point takes pointers and the CUDA stream as `c_void_p`,
sizes and strides as `c_longlong`, launches on that stream, and returns
`cudaGetLastError()` (0 on success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "vstar_flash_attention_fwd": [_P] * 10 + [_LL] * 21 + [_F, _P],
    "vstar_attention_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.POINTER(ctypes.c_longlong)],
    "vstar_flash_attention_bwd_dq": [_P] * 12 + [_LL] * 29 + [_F, _P],
    "vstar_flash_attention_bwd_dkv": [_P] * 12 + [_LL] * 29 + [_F, _P],
    "vstar_tower_attention_fwd": [_P] * 4 + [_LL] * 15 + [_F, _P],
    "vstar_int8_matvec": [_P] * 4 + [_LL] * 6 + [_P],
    "vstar_int4_matmul": [_P] * 4 + [_LL] * 7 + [_P],
    "vstar_int4_w4a8": [_P] * 5 + [_LL] * 8 + [_P],
    "vstar_w4a8_quantize": [_P] * 4 + [_LL] * 3 + [_P],
    "vstar_w4a8_decode_occupancy": [_LL] * 2 + [_P],
    "vstar_w4a8_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_longlong)],
    "vstar_int8_decode_occupancy": [_LL] * 2 + [_P],
    "vstar_int8_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_longlong)],
    "vstar_int4_decode_occupancy": [_LL] * 2 + [_P],
    "vstar_int4_tile_occupancy": [_LL] * 3 + [_P],
    "vstar_int4_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                               ctypes.POINTER(ctypes.c_longlong)],
    "vstar_unpack_probe": [_P] * 2 + [_LL] * 2 + [_P],
    "vstar_w4a8_variant": [_P] * 4 + [_LL] * 7 + [_P],
    "vstar_w4a8_variant_occupancy": [_LL] * 3 + [_P],
    "vstar_w4a8_rows": [_P] * 4 + [_LL] * 6 + [_P],
    "vstar_w4a8_rows_occupancy": [_LL] + [_P],
    "vstar_w4a8_variants_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                        ctypes.POINTER(ctypes.c_longlong)],
    "vstar_w4a8_t": [_P] * 4 + [_LL] * 5 + [_P],
    "vstar_w4a8_t_occupancy": [_LL] + [_P],
    "vstar_w4a8_t_kernel_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_longlong)],
    "vstar_graph_kernel_nodes": [_P] * 3,
}

_LOCK = threading.Lock()
_LIB = None

# Every launch counter of the port: (module, attribute name), an int or a
# dict of ints on the module. A module registers its counters when it is
# imported, under their definitions, so none can grow unregistered; the
# decode graphs (decode/graphs.py) replay their growth through this list.
COUNTERS: list = []


def register_counters(module: str, *names: str) -> None:
    """Registers the launch counters `names` of the module named
    `module`; a name the module does not define raises."""
    mod = sys.modules[module]
    for name in names:
        value = getattr(mod, name)
        if not isinstance(value, (int, dict)):
            raise TypeError(f"{module}.{name} is not a counter: {value!r}")
        if (mod, name) not in COUNTERS:
            COUNTERS.append((mod, name))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvstar_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is not built yet; returns its
    path. The compilers' reports (registers, shared memory, spills) are
    kept beside it as `<name>.log`."""
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    nvcc = _nvcc()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(f),
                         "-o", str(o)] for f, o in zip(cu, objs))]
    tmp = so.with_name(f"{tag}.tmp")
    report, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out[-4000:]}")
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        report.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"{' '.join(link)}\n{res.stderr[-4000:]}")
    so.with_suffix(".log").write_text("".join(report))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vstar_error_string.argtypes = [ctypes.c_int]
            lib.vstar_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch(fn, dev, *args) -> int:
    """Calls a launcher with its arguments and the current stream of
    `dev` (made the current device for the call if it is not)."""
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def kernel_info(entry: str):
    """Build facts of every instantiation that the C entry `entry`
    reports (one call each, until it returns -1): registers and local
    (spill) bytes per thread, static and dynamic shared memory, resident
    blocks per SM, threads per block."""
    lib = library()
    name = ctypes.c_char_p()
    vals = (ctypes.c_longlong * 6)()
    info, i = [], 0
    while True:
        code = getattr(lib, entry)(i, ctypes.byref(name), vals)
        if code == -1:
            return info
        check(lib, code, entry)
        info.append(dict(zip(("registers", "local_bytes", "static_smem",
                              "dynamic_smem", "blocks_per_sm", "threads"),
                             list(vals)), kernel=name.value.decode()))
        i += 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.vstar_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
