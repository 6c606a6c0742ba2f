"""Weight-only int8 matvec for decode-shaped rows: the K3/K4 CUDA kernel
and its plain PyTorch version.

Replaces two Pallas kernels of the JAX package that compute the same
function, y = (x @ q) * s for at most 16 rows of x:
vstar_tpu/kernels/int8_matmul.py (`_kernel`, behind `qdot_fast`) and
vstar_tpu/kernels/stream_matvec.py (`_kernel`, the double-buffered DMA
variant). One kernel, csrc/int8_matvec.cu, serves both: on the H100 the
product is bound by the weight bytes, so it runs K5's tensor-core decode
rows (csrc/decode_rows.cuh) on int8 bytes, one launch per call, with the
k-splits of each 128-column strip added across a thread-block cluster
(`k3_plan`).

`nn/quant.qdot` sends int8 entries with at most MAX_ROWS rows here, as
`qdot_fast` does; larger row counts stay a dequantize-and-matmul, as the
JAX package leaves them to XLA. A CPU tensor takes the plain version
`int8_matmul_reference`; a CUDA tensor launches the kernel or raises.

The occupancy query (`capacity`) and the cluster plan of the decode rows
(`decode_plan`) are shared with the int4 kernels (K5, K6, P4).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0
plain_calls_cuda = 0
_build.register_counters(__name__, "launches", "plain_calls_cuda")

MAX_ROWS = 16          # vstar_tpu DECODE_ROW_LIMIT
# The tensor-core decode rows (csrc/decode_rows.cuh): a block owns a strip
# of DECODE_COLS output columns and its k-splits; the blocks of a strip
# form one cluster of at most DECODE_MAX_CLUSTER.
DECODE_COLS = 128
DECODE_MAX_CLUSTER = 8
# K3's shipped shape (VSTAR_K3_DECODE): weight rows of a ring stage (the
# unit its k-splits take), warps side by side along a strip's columns and
# k-splits per block; its clusters may take 16 blocks (non-portable).
K3_STAGE_ROWS = 32
K3_WARP_COLS = 1
K3_SPLITS = 2
K3_MAX_CLUSTER = 16


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """x [R, IN] @ (q [IN, OUT] * s [.., OUT]) in f32, cast to x.dtype."""
    global plain_calls_cuda
    if x.is_cuda:
        plain_calls_cuda += 1
    w = q.float() * s.float().reshape(1, -1)
    return (x.float() @ w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_bucket(rows: int) -> int:
    """The row count a launch is instantiated for: 1, 2, 4, 8 or 16."""
    return 1 << max(rows - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(entry: str, args: tuple) -> int:
    lib = _build.library()
    n = ctypes.c_int(0)
    _build.check(lib, getattr(lib, entry)(*args, ctypes.addressof(n)), entry)
    return n.value


def capacity(dev: torch.device, entry: str, args: tuple) -> int:
    """Blocks of one decode-row launch the card holds at once: the CUDA
    occupancy calculator's blocks per SM (C entry `entry`, queried once
    per `args`) times the SMs."""
    return _blocks_per_sm(entry, args) * _sm_count(dev.index or 0)


def decode_plan(units: int, out: int, resident: int, cols: int = DECODE_COLS,
                splits: int = 4, max_cluster: int = DECODE_MAX_CLUSTER) -> int:
    """Blocks per strip of `cols` output columns (the thread-block cluster
    size: a power of two up to `max_cluster`) of the tensor-core decode
    rows: the most that fill the card's `resident` block slots in one
    wave, each block taking `splits` k-splits of whole units (K5, K6, P4:
    groups; K3: ring stages), and no more blocks than give every split a
    unit.
    Powers of two only: clusters of 3 measured slower than of 2 or 4 on
    the H100 (their blocks fit the GPCs worse)."""
    strips = -(-out // cols)
    limit = min(max_cluster, resident // strips, -(-units // splits))
    return 1 << (max(limit, 1).bit_length() - 1)


def k3_plan(IN: int, out: int, resident: int) -> int:
    """K3's cluster size: `decode_plan` over ring stages of K3_STAGE_ROWS
    inputs, in strips of DECODE_COLS * K3_WARP_COLS columns."""
    return decode_plan(-(-IN // K3_STAGE_ROWS), out, resident,
                       DECODE_COLS * K3_WARP_COLS, K3_SPLITS, K3_MAX_CLUSTER)


def int8_kernel_info():
    """Build facts of K3's instantiations (8 / 16 rows, aligned / ragged),
    as `flash_attention.attention_kernel_info`."""
    return _build.kernel_info("vstar_int8_kernel_info")


def check_cuda_operand(name: str, t: torch.Tensor, dtype, shape, dev):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype} on CUDA, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, x on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """x [R, IN] (R <= 16) @ (q int8 [IN, OUT] * s f32 [1, OUT]) ->
    [R, OUT] in x.dtype."""
    global launches
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    if not x.is_cuda:
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"int8_matmul: x must be [1..{MAX_ROWS}, IN], got "
                         f"{tuple(x.shape)}")
    rows, IN = x.shape
    OUT = q.shape[-1]
    dev = x.device
    check_cuda_operand("x", x, torch.bfloat16, (rows, IN), dev)
    check_cuda_operand("q", q, torch.int8, (IN, OUT), dev)
    s = s.reshape(OUT)
    check_cuda_operand("s", s, torch.float32, (OUT,), dev)
    xs = -(-IN // 8) * 8       # the kernel reads x in 16-byte chunks
    if xs != IN or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, xs - IN))
    aligned = OUT % 16 == 0 and q.data_ptr() % 16 == 0
    cap = capacity(dev, "vstar_int8_decode_occupancy",
                   (16 if rows > 8 else 8, int(aligned)))
    cluster = k3_plan(IN, OUT, cap)
    y = torch.empty((rows, OUT), dtype=x.dtype, device=dev)
    lib = _build.library()
    code = _build.launch(lib.vstar_int8_matvec, dev, x.data_ptr(),
                         q.data_ptr(), s.data_ptr(), y.data_ptr(), rows, IN,
                         OUT, xs, cluster, int(aligned))
    _build.check(lib, code, "int8_matmul")
    launches += 1
    return y
