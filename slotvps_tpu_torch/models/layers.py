"""NN primitives on NHWC tensors, with torch-layout parameters.

Counterpart of ``slotvps_tpu/models/layers.py``.  Activations stay
channels-last as in the JAX package; convolution weights are OIHW and
linear weights ``[out, in]`` (torch's own layout), so a conv runs as
``F.conv2d`` on a channels-last view and needs no copy.

Parameter holders are small ``nn.Module``s whose parameter and buffer names
follow torch (``weight``, ``bias``, ``running_mean``, ``running_var``,
``in_proj_weight``); ``utils/convert.py`` relies on those names.

Every init helper draws from an explicit ``torch.Generator`` (a CPU one:
modules are built on the CPU and moved with ``.to(device)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers (same recipes as the JAX package, on torch.Generator)
# ---------------------------------------------------------------------------


def kaiming_normal(gen: torch.Generator, shape, fan_in, a=0.0):
    std = math.sqrt(2.0 / ((1 + a * a) * fan_in))
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def xavier_uniform(gen: torch.Generator, shape, fan_in, fan_out):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return -bound + 2 * bound * torch.rand(shape, generator=gen,
                                           dtype=torch.float32)


class Conv2d(nn.Module):
    """NHWC convolution holding an OIHW ``weight`` and optional ``bias``."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x, stride=1, padding=0):
        return conv2d(x, self.weight, self.bias, stride, padding)


class Linear(nn.Module):
    """``nn.Linear`` semantics over the last axis (``weight`` [out, in])."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Norm(nn.Module):
    """Affine parameters of a LayerNorm / GroupNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, eps=1e-5):
        return layer_norm(x, self.weight, self.bias, eps)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with running statistics held as buffers (never trained)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, eps=1e-5):
        return batch_norm_eval(x, self.weight, self.bias, self.running_mean,
                               self.running_var, eps)


class MultiheadAttention(nn.Module):
    """Parameters of ``nn.MultiheadAttention`` (packed ``in_proj``)."""

    def __init__(self, gen: torch.Generator, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(xavier_uniform(
            gen, (3 * d_model, d_model), d_model, 3 * d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = init_linear(gen, d_model, d_model)

    def forward(self, q, k, v, num_heads):
        return multi_head_attention(self, q, k, v, num_heads)


def init_conv(gen, kh, kw, c_in, c_out, bias=True, init="kaiming") -> Conv2d:
    fan_in = kh * kw * c_in
    fan_out = kh * kw * c_out
    shape = (c_out, c_in, kh, kw)
    if init == "kaiming":
        w = kaiming_normal(gen, shape, fan_in)
    elif init == "xavier":
        w = xavier_uniform(gen, shape, fan_in, fan_out)
    elif init == "zero":
        w = torch.zeros(shape)
    else:
        raise ValueError(init)
    return Conv2d(w, torch.zeros(c_out) if bias else None)


def init_linear(gen, d_in, d_out, bias=True, init="xavier") -> Linear:
    shape = (d_out, d_in)
    if init == "xavier":
        w = xavier_uniform(gen, shape, d_in, d_out)
    elif init == "kaiming":
        w = kaiming_normal(gen, shape, d_in)
    elif init == "normal001":  # track-head init (simple_track_head.py:55)
        w = 0.01 * torch.randn(shape, generator=gen)
    else:
        raise ValueError(init)
    return Linear(w, torch.zeros(d_out) if bias else None)


# ---------------------------------------------------------------------------
# apply functions (NHWC)
# ---------------------------------------------------------------------------


def conv2d(x, weight, bias=None, stride=1, padding=0):
    """NHWC conv with an OIHW weight; ``padding`` is a symmetric int.

    The permuted input is a channels-last view of the same storage, so the
    convolution reads it in place and its channels-last output permutes
    back to NHWC without a copy."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                   None if bias is None else bias.to(x.dtype),
                   stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def linear(x, weight, bias=None):
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def layer_norm(x, weight, bias, eps=1e-5):
    # statistics in f32, as in the JAX package
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def group_norm(x, weight, bias, num_groups=32, eps=1e-5):
    """GroupNorm over NHWC (channels last), matching torch nn.GroupNorm."""
    *lead, h, w, c = x.shape
    g = num_groups
    xg = x.reshape(*lead, h, w, g, c // g).float()
    var, mean = torch.var_mean(xg, dim=(-4, -3, -1), keepdim=True,
                               correction=0)
    xg = ((xg - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    y = xg.reshape(*lead, h, w, c)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def batch_norm_eval(x, weight, bias, mean, var, eps=1e-5):
    """Frozen BatchNorm (running stats), channels-last."""
    inv = torch.rsqrt(var + eps)
    scale = (weight * inv).to(x.dtype)
    shift = (bias - mean * weight * inv).to(x.dtype)
    return x * scale + shift


def batch_norm_train(x, weight, bias, mean, var, axes, eps=1e-5,
                     momentum=0.1):
    """Training-mode BN over ``axes`` (channels last); returns (y,
    new_stats): the batch's biased statistics normalize ``x``, and the
    running statistics ``mean`` / ``var`` move by ``momentum`` towards the
    batch mean and the *unbiased* batch variance (``var * n / (n - 1)``,
    n = elements per channel), as torch's train-mode BN keeps them."""
    axes = tuple(axes)
    bvar, bmean = torch.var_mean(x, dim=axes, correction=0)
    shape = [1] * x.ndim
    shape[-1] = x.shape[-1]
    y = (x - bmean.reshape(shape)) * torch.rsqrt(bvar.reshape(shape) + eps)
    y = y * weight.reshape(shape) + bias.reshape(shape)
    n = x.numel() // x.shape[-1]
    unbiased = bvar * n / max(n - 1, 1)
    new_stats = {"mean": (1 - momentum) * mean + momentum * bmean,
                 "var": (1 - momentum) * var + momentum * unbiased}
    return y, new_stats


def multi_head_attention(p: MultiheadAttention, q, k, v, num_heads):
    """torch ``nn.MultiheadAttention`` with packed in_proj.

    q/k/v: [B, L, D].  Returns [B, L, D]."""
    d = q.shape[-1]
    wq, wk, wv = p.in_proj_weight.to(q.dtype).chunk(3, dim=0)
    bq, bk, bv = p.in_proj_bias.to(q.dtype).chunk(3)
    qh = F.linear(q, wq, bq)
    kh = F.linear(k, wk, bk)
    vh = F.linear(v, wv, bv)
    b, lq, _ = qh.shape
    lk = kh.shape[1]
    hd = d // num_heads
    qh = qh.reshape(b, lq, num_heads, hd).transpose(1, 2)
    kh = kh.reshape(b, lk, num_heads, hd).transpose(1, 2)
    vh = vh.reshape(b, lk, num_heads, hd).transpose(1, 2)
    attn = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
    attn = torch.softmax(attn, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
    out = out.transpose(1, 2).reshape(b, lq, d)
    return p.out_proj(out)


def gelu(x):
    """torch F.gelu default (erf formulation)."""
    return F.gelu(x)


def relu(x):
    return torch.clamp_min(x, 0)


ACTIVATIONS = {"relu": relu, "gelu": gelu}
