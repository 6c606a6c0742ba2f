"""Elementary building blocks over parameter dicts (vstar_tpu/nn/basic.py).

  * Dense weights are (in, out): `y = x @ w + b`; a tower's int8 entry
    {q, s, b} goes through nn/quant.qdot.
  * Norms compute in float32 and cast back to the input dtype.
  * `init_*` draw from an `Init` (core/params.py); the others apply.
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


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # HF LlamaRMSNorm: normalize in f32, scale, cast to the input dtype
    return (y * p["scale"].float()).to(x.dtype)
