"""The int4 profile's kernels, P1-P4 (csrc/int4_variants.cu), and their
plain PyTorch versions.

Replaces the Pallas kernels of scripts/int4_profile.py, the JAX package's
experiment on the W4A8 (K6) design; `scripts/int4_profile.py` of this
package launches them (its --probe and --matmul stages):

  unpack_probe(q, how)          P1, probe_mosaic: u8 q -> int8 (q & 0xF) << 4
                                by a per-byte multiply by 16 ('mul') or four
                                doublings ('add')
  w4a8_variant(xq, q4, s4, unpack, block_o)
                                P2, _w4a8_call: K6's function with the lo
                                nibble unpacked as 'ship' (K6's shift and
                                mask), 'mul', '2and' or 'off'; K6's
                                tensor-core decode rows in strips of block_o
                                columns (one launch)
  w4a8_rows(xq, q4, s4, block_i=None)
                                P3, _w4a8_call_rows: blocks over block_i
                                packed input rows, partial sums added in
                                block order; K6's decode rows, shape and
                                plan, whole blocks a k-split (one launch)
  w4a8_t(xq, q4t, s4t, block_o) P4, _w4a8_call_t: transposed storage q4t
                                uint8 [OUT, IN/2], s4t f32 [OUT, NG]; K6's
                                tensor-core decode rows on that layout
                                (one launch), block_o checked only

K6's function: int8 xq [R, IN] against the signed nibbles of q4 uint8
[IN/2, OUT], each group's exact int32 dot (of 16 * nibble) times s4 / 16,
summed over the groups in order, f32 [R, OUT]. The plain versions repeat
the JAX functions' f32 arithmetic (P2 and P4: a sum over all groups; P3:
a sum over each block's groups, then the blocks; `_kernel_sum`), so they
give their bits on the CPU. The kernels split the sums differently and
agree within 1e-5 of the largest |output|. Domain, the JAX functions':
1 <= R <= 16, block_o 256 or 512 dividing OUT (the JAX grid is OUT //
block_o), block_i a multiple of the group's packed rows dividing IN/2,
a group of a multiple of 8 inputs. On CUDA the decode rows also need
(`_check_cuda`) a group of a multiple of W4A8_GROUP_MULTIPLE inputs, IN %
32 == 0 and 16-byte aligned weights and scales (P3: OUT % 16 == 0), and
raise ValueError outside it.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .int4_matmul import (W4A8_GROUP_MULTIPLE, W4A8_MAX_CLUSTER, decode_plan,
                          unpack_int4, w4a8_plan)
from .int8_matmul import MAX_ROWS, _sm_count, capacity, check_cuda_operand

NAMES = ("unpack_probe", "w4a8_variant", "w4a8_rows", "w4a8_t")
launches = dict.fromkeys(NAMES, 0)
plain_calls_cuda = dict.fromkeys(NAMES, 0)
_build.register_counters(__name__, "launches", "plain_calls_cuda")

PROBES = ("mul", "add")                   # P1's candidates, in C order
UNPACKS = ("ship", "mul", "2and", "off")  # P2's lo-nibble unpacks
BLOCK_O = (256, 512)
P4_SPLITS = 2                 # k-splits a block (VSTAR_P4_DECODE)


def _count_plain(name, t):
    if t.is_cuda:
        plain_calls_cuda[name] += 1


def _on_cpu(t, name) -> bool:
    if t.device.type == "cpu":
        return True
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _launch(name, fn, dev, *args):
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    _build.check(lib, code, name)
    launches[name] += 1


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def want_lo(q: torch.Tensor) -> torch.Tensor:
    """The probe's expected bytes: ((q << 4) & 0xF0) as int8."""
    return ((q.to(torch.int32) << 4) & 0xF0).to(torch.uint8).view(torch.int8)


def unpack_probe_reference(q: torch.Tensor, how: str) -> torch.Tensor:
    """P1's arithmetic on int8 bytes wrapped mod 256: q read as int8, times
    16 ('mul') or doubled four times ('add')."""
    _count_plain("unpack_probe", q)
    x = q.view(torch.int8).to(torch.int16)
    if how == "mul":
        x = x * 16
    else:
        for _ in range(4):
            x = x + x
    return (x & 0xFF).to(torch.uint8).view(torch.int8)


def unpack_probe(q: torch.Tensor, how: str) -> torch.Tensor:
    """uint8 q (any shape) -> int8 lo nibble times 16, by candidate `how`
    ('mul' or 'add')."""
    if how not in PROBES:
        raise ValueError(f"unpack_probe: how must be one of {PROBES}, got "
                         f"{how!r}")
    if q.dtype != torch.uint8:
        raise TypeError(f"unpack_probe: expected uint8, got {q.dtype}")
    if _on_cpu(q, "unpack_probe"):
        return unpack_probe_reference(q, how)
    q = q.contiguous()
    o = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    if q.numel():
        _launch("unpack_probe", "vstar_unpack_probe", q.device, q.data_ptr(),
                o.data_ptr(), q.numel(), PROBES.index(how))
    return o


# ---------------------------------------------------------------------------
# P2-P4: plain versions
# ---------------------------------------------------------------------------

def _group_products(xq, q4, s4):
    """[NG, R, OUT] f64: each group's exact int32 dot of xq with 16 *
    nibble times s4 / 16 (the TPU kernels' `d.astype(f32) * s[g]`, before
    its rounding to f32; both factors are f32 values, so the f64 product
    is exact)."""
    w = unpack_int4(q4)
    IN, OUT = w.shape
    NG = s4.shape[0]
    G = IN // NG
    xg = xq.reshape(xq.shape[0], NG, G).double()
    wg = w.reshape(NG, G, OUT).double()
    # exact in f64 (|16 * dot| < 2**53); int matmul is CPU-only in torch
    d16 = (16 * torch.einsum("rgk,gko->gro", xg, wg)).float()
    return d16.double() * (s4.float() * (1.0 / 16.0)).double()[:, None, :]


def _kernel_sum(products):
    """The group loop's f32 sum `acc = term` then `acc = acc + term`, as
    the JAX function computes it (XLA contracts each add with the
    product beside it into a fused multiply-add: the first as
    fma(d0, s0, t1), the later ones as fma(d, s, acc)). A fused
    multiply-add is the exact f64 sum of the exact product and an f32
    value, rounded once to f32."""
    if len(products) == 1:
        return products[0].float()
    acc = (products[0] + products[1].float().double()).float()
    for p in products[2:]:
        acc = (p + acc.double()).float()
    return acc


def w4a8_variant_reference(xq, q4, s4, unpack="ship", block_o=256):
    """P2 (every unpack and block width computes the same f32 [R, OUT])."""
    _count_plain("w4a8_variant", xq)
    return _kernel_sum(_group_products(xq, q4, s4))


def w4a8_rows_reference(xq, q4, s4, block_i=None):
    """P3: each block's groups summed in order, then the blocks in order
    (the TPU's `o_ref = acc` then `o_ref += acc`)."""
    _count_plain("w4a8_rows", xq)
    IN2, OUT = q4.shape
    NG = s4.shape[0]
    ngb = _block_i(IN2, OUT, NG, block_i) // (IN2 // NG)
    products = _group_products(xq, q4, s4)
    out = None
    for b in range(0, NG, ngb):
        part = _kernel_sum(products[b:b + ngb])
        out = part if out is None else out + part
    return out


def w4a8_t_reference(xq, q4t, s4t, block_o=256):
    """P4: P2's sum on the transposed storage, returned [R, OUT]."""
    _count_plain("w4a8_t", xq)
    return _kernel_sum(_group_products(xq, q4t.t(), s4t.t()))


# ---------------------------------------------------------------------------
# P2-P4: domain and kernels
# ---------------------------------------------------------------------------

def default_block_i(IN2: int, OUT: int, NG: int) -> int:
    """P3's block of packed rows when none is given (int4_profile.py
    _w4a8_call_rows): the fewest groups whose block holds >= 512 KB."""
    gh = IN2 // NG
    cands = [m * gh for m in range(1, NG + 1)
             if NG % m == 0 and (m * gh) * OUT >= 4 * 128 * 1024]
    return cands[0] if cands else IN2


def _block_i(IN2, OUT, NG, block_i):
    gh = IN2 // NG
    block_i = default_block_i(IN2, OUT, NG) if block_i is None else block_i
    if block_i < gh or block_i % gh or IN2 % block_i:
        raise ValueError(f"w4a8_rows: block_i {block_i} must be a multiple "
                         f"of {gh} packed rows dividing {IN2}")
    return block_i


def _check(name, xq, IN2, OUT, NG, block_o=None):
    """The JAX functions' domain (and the kernels' groups of 8k inputs)."""
    if xq.dim() != 2 or not 1 <= xq.shape[0] <= MAX_ROWS:
        raise ValueError(f"{name}: xq must be [1..{MAX_ROWS}, IN], got "
                         f"{tuple(xq.shape)}")
    IN = xq.shape[1]
    if IN != 2 * IN2 or IN % NG or (IN // NG) % 8:
        raise ValueError(f"{name}: xq has {IN} inputs, weights {IN2} packed "
                         f"rows in {NG} groups (a group must be a multiple "
                         "of 8 inputs)")
    if block_o is not None and (block_o not in BLOCK_O or OUT % block_o):
        raise ValueError(f"{name}: block_o {block_o} must be one of "
                         f"{BLOCK_O} and divide OUT = {OUT}")


def _check_cuda(name, xq, q, s, shape_q, shape_s, group):
    """The operands of a decode-row launch, and the kernels' domain beyond
    the JAX functions': a group of a multiple of W4A8_GROUP_MULTIPLE
    inputs (whole ring stages), IN % 32 == 0, q and s 16-byte aligned.
    Returns xq, cloned if it is not 16-byte aligned (the kernels copy
    16-byte chunks of it)."""
    dev = xq.device
    check_cuda_operand("xq", xq, torch.int8, xq.shape, dev)
    check_cuda_operand("q4", q, torch.uint8, shape_q, dev)
    check_cuda_operand("s4", s, torch.float32, shape_s, dev)
    IN = xq.shape[1]
    if group % W4A8_GROUP_MULTIPLE or IN % 32 or q.data_ptr() % 16 \
            or s.data_ptr() % 16:
        raise ValueError(f"{name}: a group of {group} inputs must be a "
                         f"multiple of {W4A8_GROUP_MULTIPLE}, IN = {IN} of "
                         "32, and q4, s4 16-byte aligned")
    return xq.clone() if xq.data_ptr() % 16 else xq


def _rows_key(rows):
    """The instantiation (8 or 16 rows) a launch of `rows` takes."""
    return 16 if rows > 8 else 8


def w4a8_variant(xq: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
                 unpack: str = "ship", block_o: int = 256) -> torch.Tensor:
    """P2: int8 xq [R, IN] against q4 [IN/2, OUT], s4 [NG, OUT] -> f32
    [R, OUT], the lo nibble unpacked as `unpack`, block_o columns per
    block."""
    if unpack not in UNPACKS:
        raise ValueError(f"w4a8_variant: unpack must be one of {UNPACKS}, "
                         f"got {unpack!r}")
    IN2, OUT = q4.shape
    NG = s4.shape[0]
    _check("w4a8_variant", xq, IN2, OUT, NG, block_o)
    if _on_cpu(xq, "w4a8_variant"):
        return w4a8_variant_reference(xq, q4, s4, unpack, block_o)
    rows, IN = xq.shape
    xq = _check_cuda("w4a8_variant", xq, q4, s4, (IN2, OUT), (NG, OUT),
                     IN // NG)
    u = UNPACKS.index(unpack)
    cap = capacity(xq.device, "vstar_w4a8_variant_occupancy",
                   (u, _rows_key(rows), block_o))
    cluster = w4a8_plan(NG, OUT, cap, _sm_count(xq.device.index or 0),
                        block_o)
    y = torch.empty((rows, OUT), dtype=torch.float32, device=xq.device)
    _launch("w4a8_variant", "vstar_w4a8_variant", xq.device, xq.data_ptr(),
            q4.data_ptr(), s4.data_ptr(), y.data_ptr(), rows, IN, OUT,
            IN // NG, u, block_o, cluster)
    return y


def w4a8_rows(xq: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor,
              block_i=None) -> torch.Tensor:
    """P3: P2's function (K6's unpack) over blocks of block_i packed rows
    (None: `default_block_i`), added in block order."""
    IN2, OUT = q4.shape
    NG = s4.shape[0]
    _check("w4a8_rows", xq, IN2, OUT, NG)
    block_i = _block_i(IN2, OUT, NG, block_i)
    if _on_cpu(xq, "w4a8_rows"):
        return w4a8_rows_reference(xq, q4, s4, block_i)
    rows, IN = xq.shape
    if OUT % 16:
        raise ValueError(f"w4a8_rows: OUT = {OUT} must be a multiple of 16")
    xq = _check_cuda("w4a8_rows", xq, q4, s4, (IN2, OUT), (NG, OUT), IN // NG)
    # K6's plan over the groups, then no more k-splits than blocks
    cap = capacity(xq.device, "vstar_w4a8_rows_occupancy", (_rows_key(rows),))
    cluster = w4a8_plan(NG, OUT, cap, _sm_count(xq.device.index or 0))
    while cluster > IN2 // block_i:
        cluster //= 2
    y = torch.empty((rows, OUT), dtype=torch.float32, device=xq.device)
    _launch("w4a8_rows", "vstar_w4a8_rows", xq.device, xq.data_ptr(),
            q4.data_ptr(), s4.data_ptr(), y.data_ptr(), rows, IN, OUT,
            IN // NG, block_i, cluster)
    return y


def w4a8_t(xq: torch.Tensor, q4t: torch.Tensor, s4t: torch.Tensor,
           block_o: int = 256) -> torch.Tensor:
    """P4: K6's function on q4t uint8 [OUT, IN/2], s4t f32 [OUT, NG] ->
    f32 [R, OUT]; block_o output rows per block."""
    OUT, IN2 = q4t.shape
    NG = s4t.shape[1]
    _check("w4a8_t", xq, IN2, OUT, NG, block_o)
    if _on_cpu(xq, "w4a8_t"):
        return w4a8_t_reference(xq, q4t, s4t, block_o)
    rows, IN = xq.shape
    xq = _check_cuda("w4a8_t", xq, q4t, s4t, (OUT, IN2), (OUT, NG), IN // NG)
    cap = capacity(xq.device, "vstar_w4a8_t_occupancy", (_rows_key(rows),))
    cluster = decode_plan(NG, OUT, cap, splits=P4_SPLITS,
                          max_cluster=W4A8_MAX_CLUSTER)
    y = torch.empty((rows, OUT), dtype=torch.float32, device=xq.device)
    _launch("w4a8_t", "vstar_w4a8_t", xq.device, xq.data_ptr(),
            q4t.data_ptr(), s4t.data_ptr(), y.data_ptr(), rows, IN, OUT,
            IN // NG, cluster)
    return y


def variants_kernel_info():
    """Build facts of P2's (unpack x 256 / 512 columns x 8 / 16 rows) and
    P3's (8 / 16 rows) instantiations."""
    return _build.kernel_info("vstar_w4a8_variants_kernel_info")


def w4a8_t_kernel_info():
    """Build facts of P4's instantiations (8 / 16 rows)."""
    return _build.kernel_info("vstar_w4a8_t_kernel_info")
