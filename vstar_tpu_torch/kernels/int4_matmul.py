"""Group-wise int4 weight matmuls: the K5 (W4A16) and K6 (W4A8) CUDA
kernels and their plain PyTorch versions.

Replaces vstar_tpu/kernels/int4_matmul.py (`_kernel`, `_w4a8_kernel`).
Weight format, from nn/quant.quantize_weight_int4:
  q4  uint8 [IN/2, OUT]: row p holds input 2p in its low nibble and 2p+1
      in its high nibble, both two's-complement signed 4-bit;
  s4  f32 [IN/group, OUT]: one scale per (group, column).

  int4_matmul(x, q4, s4)       x [R, IN] @ dequant -> [R, OUT] in x.dtype,
                               every R (K5; csrc/int4_matmul.cu: decode
                               rows on tensor cores at R <= 16, pipelined
                               tensor-core tiles above; one launch per
                               call; group a multiple of 64)
  int4_matmul_w4a8(xq, q4, s4) int8 xq [R <= 16, IN] -> f32 [R, OUT] with
                               exact int32 group dots, no activation scale
                               (K6, the TPU kernel's own function:
                               csrc/int4_matmul.cu, the decode rows on
                               int8 tensor cores, one launch)
  quantize_rows(x, amax=None)  x [R, IN] -> per-row int8 xq and f32 sx
                               (the row quantization of K6's qdot, one
                               launch; with `amax` the rows' largest
                               |value| comes from outside: a rank of an
                               engine's hidden split holds part of each
                               row, nn/llama.py)
  qdot4 / qdot4_w4a8           the qdot entry points over [..., IN]; on a
                               CUDA tensor qdot4_w4a8 is two launches,
                               quantize_rows and K6 with the activation
                               scale and x's type in its store

Both kernels take any OUT, the ragged 32003-wide lm_head included (the
JAX package sends that shape to an XLA dequantize; the function is the
same). The dispatch gate of the JAX package stays because it changes the
result: W4A8 only for at most 16 rows, IN % 256 == 0 and OUT % 128 == 0
(`w4a8_applies`), else W4A16.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .int8_matmul import (DECODE_COLS, DECODE_MAX_CLUSTER, MAX_ROWS,
                          _blocks_per_sm, _sm_count, capacity,
                          check_cuda_operand, decode_plan)

NAMES = ("int4_matmul", "int4_matmul_w4a8", "quantize_rows")
launches = dict.fromkeys(NAMES, 0)
# K5's launches by route: decode rows (R <= 16) and tiles (R > 16)
route_launches = {"decode": 0, "tile": 0}
plain_calls_cuda = dict.fromkeys(NAMES, 0)
_build.register_counters(__name__, "launches", "route_launches",
                         "plain_calls_cuda")

# The JAX dispatch gate of W4A8 (vstar_tpu int4_matmul.py): IN a multiple
# of 256 (:204, :252), and OUT a multiple of the smallest block_o the
# Pallas kernel takes, 128 (:210-212); elsewhere qdot takes W4A16.
W4A8_IN_MULTIPLE = 256
W4A8_OUT_MULTIPLE = 128
# K5's decode rows (VSTAR_K5_DECODE): DECODE_SPLITS k-splits of whole
# groups per block; a ring stage is 64 inputs, so a group spans whole
# stages. The tiles take k-tiles of 64 inputs inside one group.
DECODE_SPLITS = 4
GROUP_MULTIPLE = 64
# K6's decode rows (VSTAR_K6_DECODE): strips of two warps' 256 columns, one
# k-split of whole groups per block, a ring stage one group (so groups are
# multiples of 128 inputs), clusters of up to W4A8_MAX_CLUSTER blocks
# (16, non-portable, measured no faster), each block streaming at least
# W4A8_MIN_GROUPS groups where the strips still cover the SMs (`w4a8_plan`)
W4A8_WARP_COLS = 2
W4A8_SPLITS = 1
W4A8_GROUP_MULTIPLE = 128
W4A8_MAX_CLUSTER = 8
W4A8_MIN_GROUPS = 8
# K5's tile shapes (rows, columns), in the order of run_k5_tiles, and the
# k-splits a tile may take (a cluster along the inputs)
TILE_SHAPES = ((64, 128), (128, 256))
TILE_SPLITS = (1, 2, 4)
TILE_K = 64


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """uint8 [..., IN/2, OUT] -> int8 [..., IN, OUT] signed nibbles."""
    qi = q4.to(torch.int16)
    lo = ((qi & 0xF) ^ 8) - 8
    hi = (((qi >> 4) & 0xF) ^ 8) - 8
    w = torch.stack([lo, hi], dim=-2)            # [..., IN/2, 2, OUT]
    return w.reshape(*q4.shape[:-2], 2 * q4.shape[-2],
                     q4.shape[-1]).to(torch.int8)


def dequantize_int4(q4: torch.Tensor, s4: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """[..., IN/2, OUT] + [..., IN/group, OUT] -> [..., IN, OUT] in dtype
    (nib * scale computed in dtype, as vstar_tpu nn/quant._deq4)."""
    w = unpack_int4(q4)
    IN, OUT = w.shape[-2:]
    NG = s4.shape[-2]
    w = w.reshape(*w.shape[:-2], NG, IN // NG, OUT).to(dtype)
    w = w * s4.to(dtype)[..., :, None, :]
    return w.reshape(*w.shape[:-3], IN, OUT)


def int4_matmul_reference(x, q4, s4):
    """x [R, IN] @ dequant(q4, s4) in f32, cast to x.dtype."""
    if x.is_cuda:
        plain_calls_cuda["int4_matmul"] += 1
    return (x.float() @ dequantize_int4(q4, s4)).to(x.dtype)


def int4_matmul_kernel_math(x, q4, s4):
    """K5's own arithmetic in f32, before its output is rounded to
    x.dtype: above MAX_ROWS rows the tensor-core tiles round nib * scale
    to bf16 (as the TPU kernel does); at most MAX_ROWS rows the decode
    rows keep the weights exact (the nibbles, with f32 group dots scaled
    by s4 in f32). The kernel agrees with it within the rounding of its
    output; a check, never on the path."""
    w = dequantize_int4(q4, s4)
    if x.shape[0] > MAX_ROWS:
        w = w.to(torch.bfloat16).float()
    return x.float() @ w


def int4_kernel_info():
    """Build facts of K5's decode-row instantiations (8 / 16 rows,
    aligned / ragged) and shipped tiles, as
    `flash_attention.attention_kernel_info`."""
    return _build.kernel_info("vstar_int4_kernel_info")


def int4_matmul_w4a8_reference(xq, q4, s4):
    """The TPU kernel's math: per group, the exact integer dot of xq with
    the nibbles, scaled by s4; f32 [R, OUT] (no activation scale)."""
    if xq.is_cuda:
        plain_calls_cuda["int4_matmul_w4a8"] += 1
    w = unpack_int4(q4)
    IN, OUT = w.shape
    NG = s4.shape[0]
    G = IN // NG
    # int64 products summed exactly (integer matmul is CPU-only in torch,
    # so compute in f64, exact for |dot| < 2**53)
    xg = xq.reshape(xq.shape[0], NG, G).double()
    wg = w.reshape(NG, G, OUT).double()
    dots = torch.einsum("rgk,gko->gro", xg, wg).float()   # [NG, R, OUT]
    acc = torch.zeros((xq.shape[0], OUT), dtype=torch.float32,
                      device=xq.device)
    for g in range(NG):                                  # the TPU's order
        acc = acc + dots[g] * s4[g].float()
    return acc


def _int4_shapes(q4, s4, IN):
    IN2, OUT = q4.shape
    NG = s4.shape[0]
    if IN != 2 * IN2 or IN % NG or (IN // NG) % 2:
        raise ValueError(f"int4: x has {IN} inputs, q4 {tuple(q4.shape)}, "
                         f"s4 {tuple(s4.shape)}")
    return OUT, NG, IN // NG


def tile_plan(rows: int, out: int, k_tiles: int, sms: int, resident) -> tuple:
    """K5's tile shape (index into TILE_SHAPES) and k-splits for `rows` >
    MAX_ROWS: 64 x 128 tiles up to 128 rows, 128 x 256 above; then the
    most k-splits (a cluster of blocks per tile) that still fit the card's
    block slots in one wave and leave each split at least 4 k-tiles; one
    where the tiles alone pass a wave (splits then add waves, which
    measured slower). `resident(tile, ks)` is the blocks of that
    instantiation one SM holds."""
    tile = 0 if rows <= 128 else 1
    bm, bn = TILE_SHAPES[tile]
    tiles = -(-rows // bm) * -(-out // bn)
    best = 1
    for ks in TILE_SPLITS[1:]:
        if k_tiles >= 4 * ks and tiles * ks <= resident(tile, ks) * sms:
            best = ks
    return tile, best


def w4a8_kernel_info():
    """Build facts of K6's instantiations (8 / 16 rows, aligned /
    ragged), as `int4_kernel_info`."""
    return _build.kernel_info("vstar_w4a8_kernel_info")


def w4a8_plan(groups: int, out: int, resident: int, sms: int,
              cols: int = DECODE_COLS * W4A8_WARP_COLS) -> int:
    """K6's cluster size: decode_plan's (the most blocks a strip that fill
    the card's resident slots in one wave), halved while a block would
    stream fewer than W4A8_MIN_GROUPS groups and half the blocks would
    still give every SM one. Measured at one and 16 rows (kernel_probe.py
    --k6-shapes): 4096x11008 runs faster on clusters of 4 (8 groups a
    block, 172 blocks) than of 8; the 4096-wide outputs (16 strips) on 8.
    `cols`: the strip (P2's block_o; K6's 256 by default)."""
    c = decode_plan(groups, out, resident, cols, W4A8_SPLITS, W4A8_MAX_CLUSTER)
    strips = -(-out // cols)
    while (c > 1 and -(-groups // (c * W4A8_SPLITS)) < W4A8_MIN_GROUPS
           and strips * (c // 2) >= sms):
        c //= 2
    return c


def _w4a8_operands(name, xq, q4, s4):
    """(rows, IN, OUT, NG, group) of a K6 launch, after its checks."""
    if xq.dim() != 2 or not 1 <= xq.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name}: x must be [1..{MAX_ROWS}, IN], got "
                         f"{tuple(xq.shape)}")
    rows, IN = xq.shape
    OUT, NG, group = _int4_shapes(q4, s4, IN)
    if group % W4A8_GROUP_MULTIPLE:
        raise ValueError(f"{name}: group {group} must be a multiple of "
                         f"{W4A8_GROUP_MULTIPLE}")
    dev = xq.device
    check_cuda_operand("q4", q4, torch.uint8, (IN // 2, OUT), dev)
    check_cuda_operand("s4", s4, torch.float32, (NG, OUT), dev)
    return rows, IN, OUT, NG, group


def _launch_w4a8(xq, q4, s4, sx, y, pdl):
    """Plan the cluster and launch K6: y = (xq @ nib) per group times s4
    / 16, times sx [rows, 1] unless it is None, in y's type."""
    dev = xq.device
    rows, IN = xq.shape
    NG, OUT = s4.shape
    aligned = (OUT % 16 == 0 and q4.data_ptr() % 16 == 0
               and s4.data_ptr() % 16 == 0)
    cap = capacity(dev, "vstar_w4a8_decode_occupancy",
                   (16 if rows > 8 else 8, int(aligned)))
    cluster = w4a8_plan(NG, OUT, cap, _sm_count(dev.index or 0))
    lib = _build.library()
    code = _build.launch(lib.vstar_int4_w4a8, dev, xq.data_ptr(),
                         q4.data_ptr(), s4.data_ptr(),
                         None if sx is None else sx.data_ptr(), y.data_ptr(),
                         rows, IN, OUT, IN // NG, cluster, int(aligned),
                         int(y.dtype == torch.float32), int(pdl))
    _build.check(lib, code, "int4_matmul_w4a8")
    launches["int4_matmul_w4a8"] += 1
    return y


def int4_matmul(x: torch.Tensor, q4: torch.Tensor,
                s4: torch.Tensor) -> torch.Tensor:
    """x [R, IN] @ dequant(q4 [IN/2, OUT], s4 [IN/group, OUT]) ->
    [R, OUT] in x.dtype (K5, every R)."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q4, s4)
    if not x.is_cuda:
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"int4_matmul: x must be [R, IN], got "
                         f"{tuple(x.shape)}")
    rows, IN = x.shape
    OUT, NG, group = _int4_shapes(q4, s4, IN)
    if IN % 8:
        raise ValueError(f"int4_matmul: IN = {IN} must be a multiple of 8")
    dev = x.device
    check_cuda_operand("x", x, torch.bfloat16, (rows, IN), dev)
    check_cuda_operand("q4", q4, torch.uint8, (IN // 2, OUT), dev)
    check_cuda_operand("s4", s4, torch.float32, (NG, OUT), dev)
    if group % GROUP_MULTIPLE:
        raise ValueError(f"int4_matmul: group {group} must be a multiple of "
                         f"{GROUP_MULTIPLE}")
    if x.data_ptr() % 16:    # both routes load 16-byte vectors of x
        x = x.clone()
    y = torch.empty((rows, OUT), dtype=x.dtype, device=dev)
    if rows == 0:
        return y
    aligned = (OUT % 16 == 0 and q4.data_ptr() % 16 == 0
               and s4.data_ptr() % 16 == 0)
    if rows <= MAX_ROWS:
        route, tile = "decode", 0
        cap = capacity(dev, "vstar_int4_decode_occupancy",
                       (16 if rows > 8 else 8, int(aligned)))
        cluster = decode_plan(NG, OUT, cap, splits=DECODE_SPLITS)
    else:
        route = "tile"
        tile, cluster = tile_plan(
            rows, OUT, IN // TILE_K, _sm_count(dev.index or 0),
            lambda t, ks: _blocks_per_sm("vstar_int4_tile_occupancy",
                                         (t, ks, int(aligned))))
    lib = _build.library()
    code = _build.launch(lib.vstar_int4_matmul, dev, x.data_ptr(),
                         q4.data_ptr(), s4.data_ptr(), y.data_ptr(), rows, IN,
                         OUT, group, cluster, int(aligned), tile)
    _build.check(lib, code, "int4_matmul")
    launches["int4_matmul"] += 1
    route_launches[route] += 1
    return y


def int4_matmul_w4a8(xq: torch.Tensor, q4: torch.Tensor,
                     s4: torch.Tensor) -> torch.Tensor:
    """int8 xq [R <= 16, IN] @ signed nibbles -> f32 [R, OUT], each
    group's int32 dot times s4 (K6; the caller applies the activation
    scale)."""
    if xq.device.type == "cpu":
        return int4_matmul_w4a8_reference(xq, q4, s4)
    if not xq.is_cuda:
        raise ValueError(f"int4_matmul_w4a8: unsupported device {xq.device}")
    rows, IN, OUT, _, _ = _w4a8_operands("int4_matmul_w4a8", xq, q4, s4)
    check_cuda_operand("xq", xq, torch.int8, (rows, IN), xq.device)
    if xq.data_ptr() % 16:   # the kernel copies 16-byte chunks of x
        xq = xq.clone()
    y = torch.empty((rows, OUT), dtype=torch.float32, device=xq.device)
    return _launch_w4a8(xq, q4, s4, None, y, pdl=False)


def quantize_activations(xf: torch.Tensor,
                         amax: Optional[torch.Tensor] = None):
    """Per-row symmetric int8 of f32 rows (qdot4_w4a8's rule):
    (xq int8, sx f32 [R, 1]); the plain version of quantize_rows. `amax`
    [R, 1]: the rows' largest |value| where xf holds part of each row;
    default xf's."""
    if xf.is_cuda:
        plain_calls_cuda["quantize_rows"] += 1
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    amax = torch.clamp(amax, min=1e-8)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the IEEE quotient (JAX's,
    # and the CPU's) for ~4 % of values
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def quantize_rows(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """x [R, IN] (bf16 or f32) -> (xq int8 [R, IN], sx f32 [R, 1]) by
    qdot4_w4a8's rule, the bits of quantize_activations(x.float(), amax)
    (K6's row quantization, one launch). `amax` f32 [R, 1]: the rows'
    largest |value| taken from outside (x holds part of each row: an
    engine's hidden split), which the kernel then does not compute."""
    if x.device.type == "cpu":
        return quantize_activations(x.float(), amax)
    if not x.is_cuda:
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_rows: x must be bf16 or f32 [R, IN], got "
                         f"{x.dtype} {tuple(x.shape)}")
    rows, IN = x.shape
    if IN % 8:
        raise ValueError(f"quantize_rows: IN = {IN} must be a multiple of 8")
    if amax is not None:
        check_cuda_operand("amax", amax, torch.float32, (rows, 1), x.device)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous().clone()
    xq = torch.empty((rows, IN), dtype=torch.int8, device=x.device)
    sx = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return xq, sx
    lib = _build.library()
    code = _build.launch(lib.vstar_w4a8_quantize, x.device, x.data_ptr(),
                         xq.data_ptr(), sx.data_ptr(),
                         None if amax is None else amax.data_ptr(), rows, IN,
                         int(x.dtype == torch.float32))
    _build.check(lib, code, "quantize_rows")
    launches["quantize_rows"] += 1
    return xq, sx


def w4a8_applies(x: torch.Tensor, entry, split: int = 1) -> bool:
    """The JAX dispatch gate, all three of its conditions: at most 16
    rows, IN % 256 == 0 and OUT % 128 == 0 (the JAX kernel declines every
    other shape, and qdot then takes W4A16). `split`: x and the entry
    hold 1/split of each row's inputs and groups (an engine's hidden
    split), whose whole row the gate reads."""
    rows = x.numel() // x.shape[-1]
    IN = x.shape[-1] * split
    return (rows <= MAX_ROWS and IN % W4A8_IN_MULTIPLE == 0
            and IN % (entry["s4"].shape[-2] * split) == 0
            and entry["q4"].shape[-1] % W4A8_OUT_MULTIPLE == 0)


def qdot4_w4a8(x: torch.Tensor, entry) -> torch.Tensor:
    """W4A8 qdot over [..., IN]: per-row int8 activations, K6, then the
    activation scale (vstar_tpu qdot4_w4a8). On a CUDA tensor two
    launches: quantize_rows, and K6 with the scale and x's type in its
    store."""
    q4, s4 = entry["q4"], entry["s4"].float()
    lead, IN = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, IN)
    if x.device.type == "cpu":
        xq, sx = quantize_activations(x2.float())
        y = (int4_matmul_w4a8(xq, q4, s4) * sx).to(x.dtype)
        return y.reshape(*lead, q4.shape[-1])
    if not x.is_cuda:
        raise ValueError(f"qdot4_w4a8: unsupported device {x.device}")
    rows, _, OUT, _, _ = _w4a8_operands("qdot4_w4a8", x2, q4, s4)
    xq, sx = quantize_rows(x2)
    y = torch.empty((rows, OUT), dtype=x.dtype, device=x.device)
    # dependent on the row quantization (programmatic dependent launch):
    # K6's first weight copies overlap that kernel, whose blocks take no
    # shared memory, the resource that bounds K6's wave
    _launch_w4a8(xq, q4, s4, sx, y, pdl=True)
    return y.reshape(*lead, OUT)


def qdot4(x: torch.Tensor, entry) -> torch.Tensor:
    """x [..., IN] against an int4 entry {'q4', 's4'} through K5."""
    q4, s4 = entry["q4"], entry["s4"]
    lead, IN = x.shape[:-1], x.shape[-1]
    y = int4_matmul(x.reshape(-1, IN).contiguous(), q4, s4.float())
    return y.reshape(*lead, q4.shape[-1])
