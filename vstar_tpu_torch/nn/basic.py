"""Elementary building blocks over parameter dicts (vstar_tpu/nn/basic.py).

  * Dense weights are (in, out): `y = x @ w + b`; a tower's int8 entry
    {q, s, b} goes through nn/quant.qdot.
  * Norms compute in float32 and cast back to the input dtype.
  * `init_*` draw from an `Init` (core/params.py); the others apply.
  * `partial_dot` is a product of one rank's shard of a model split
    (core/mesh.ModelSplit), kept in f32 for the sum over the group; so
    is `rmsnorm`'s sum of squares on an engine's split hidden axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.params import Init, dense_init
from .quant import qdot


def quick_gelu(x):
    """CLIP/OWL-ViT activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x):
    """jax.nn.gelu's default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "gelu_exact": F.gelu,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


class _PartialDot(torch.autograd.Function):
    """x @ w on the card, accumulated and returned in f32 (torch.mm's
    out_dtype); backward: the two products in x's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        return (g @ w.t()).reshape(x.shape), x2.t() @ g


def partial_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w of a rank's rows of w as an f32 partial sum (accumulated in
    f32 and not rounded to x's dtype before the model group adds it)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    w = w.to(x.dtype)
    if x.is_cuda:
        return _PartialDot.apply(x, w)
    return x.float() @ w.float()


def init_dense(init: Init, in_dim: int, out_dim: int, use_bias: bool = True,
               lead=()):
    p = {"w": dense_init(init, in_dim, out_dim, lead)}
    if use_bias:
        p["b"] = init.zeros((*lead, out_dim))
    return p


def dense(p, x):
    if "q" in p:            # weight-only int8 entry {q, s, b} (nn/quant.py)
        y = qdot(x, p)
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_layernorm(init: Init, dim: int, lead=()):
    return {"scale": init.ones((*lead, dim)), "bias": init.zeros((*lead, dim))}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def init_rmsnorm(init: Init, dim: int, lead=()):
    return {"scale": init.ones((*lead, dim))}


def rmsnorm(p, x, eps: float = 1e-6, split=None):
    """split: an engine's split of the hidden axis (core/mesh.hidden_split):
    x and the scale hold this rank's columns, and the sum of squares is
    all-reduced over the split's group in f32 before the mean."""
    xf = x.float()
    if split is None:
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        var = split.reduce(xf.square().sum(dim=-1, keepdim=True)) \
            / torch.full((), x.shape[-1] * split.size, dtype=torch.float32,
                         device=x.device)
    y = xf * torch.rsqrt(var + eps)
    # HF LlamaRMSNorm: normalize in f32, scale, cast to the input dtype
    return (y * p["scale"].float()).to(x.dtype)
