"""Swin Transformer backbone (NHWC; the Swin-L of ``swinl_fpn_slotvps``).

Counterpart of ``slotvps_tpu/models/swin.py`` (reference
mmdet/models/backbones/swin_transformer.py:449 with the settings of
configs/cityscapes/swinL_fpn_slotvps.py:6-20): windowed multi-head
self-attention with a relative position bias, shifted windows on odd
blocks, patch merging between stages and a LayerNorm on each output level.

The module tree mirrors the JAX parameter tree (``patch_embed.{proj,
norm}``, ``stage{s}.blocks.{b}.{norm1, qkv, proj, rel_pos_bias, norm2, fc1,
fc2}``, ``stage{s}.downsample.{reduction, norm}``, ``out_norm{i}``), so
``utils/convert.py`` maps it with no special case.  The relative-position
index and the shift masks are derived: the index is a non-persistent
buffer, the masks a per-shape cache on the device; neither is in the
``state_dict``.

The JAX package scans an even-depth stage over block pairs only to keep
XLA's compile small; its numerics are those of the unrolled loop run here.
Window attention is plain PyTorch (matmul, softmax), as the JAX package
computes it in XLA outside any Pallas kernel.  In bf16 the weights are cast
per call, the bias and the mask are cast to bf16 before the add and the
softmax runs on bf16 scores, as in the JAX package.  Stochastic depth
(timm DropPath, the JAX package's ``_drop_path``) runs when ``forward`` is
given a ``torch.Generator``; no entry point gives one (the JAX package's
``loss_fn`` passes no ``drop_path_key`` either).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from slotvps_tpu_torch.config import SwinConfig
from slotvps_tpu_torch.models import layers as L


def _trunc_normal(gen: torch.Generator, shape, std=0.02):
    """Normal(0, std) truncated at +-2 std (torch ``trunc_normal_``), by
    the inverse CDF of a uniform draw from ``gen``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * u - 1)
    return (std * z.clamp(-2.0, 2.0)).float()


def rel_pos_index(window: int) -> torch.Tensor:
    """Relative position index table [W*W, W*W] (reference swin :87-97)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, w, w, C] (H, W divisible by w), windows
    ordered batch-major (B, nH, nW)."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(wins: torch.Tensor, w: int, b: int, h: int,
                   ww: int) -> torch.Tensor:
    c = wins.shape[-1]
    x = wins.reshape(b, h // w, ww // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, c)


def shift_mask(h: int, w: int, window: int, shift: int,
               device=None) -> torch.Tensor:
    """Attention mask [nW, W*W, W*W] of shifted windows on an (h, w) map
    (reference swin :318-337): -100 between tokens of different regions."""
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    rows = [(0, h - window), (h - window, h - shift), (h - shift, h)]
    cols = [(0, w - window), (w - window, w - shift), (w - shift, w)]
    for r0, r1 in rows:
        for c0, c1 in cols:
            img[:, r0:r1, c0:c1, :] = cnt
            cnt += 1
    wins = window_partition(img, window).reshape(-1, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def drop_path_mask(x: torch.Tensor, rate: float,
                   generator: torch.Generator) -> torch.Tensor:
    """The keep mask of stochastic depth: one Bernoulli(1 - rate) draw per
    sample, shape [B, 1, 1, 1], in ``x``'s dtype on ``x``'s device (drawn
    on the generator's device)."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - rate).to(device=x.device, dtype=x.dtype)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth on the batch axis (timm DropPath, the JAX package's
    ``_drop_path``): ``x * mask / (1 - rate)``."""
    return x * drop_path_mask(x, rate, generator) / (1.0 - rate)


def drop_path_rates(cfg: SwinConfig) -> List[float]:
    """Per-block rates, rising linearly from 0 to ``drop_path_rate`` over
    all blocks (reference swin :481-483)."""
    total = sum(cfg.depths)
    return [cfg.drop_path_rate * i / max(total - 1, 1) for i in range(total)]


class SwinBlock(nn.Module):
    def __init__(self, gen: torch.Generator, dim: int, num_heads: int,
                 window: int, mlp_ratio: float, qkv_bias: bool):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.norm1 = L.Norm(dim)
        self.qkv = L.init_linear(gen, dim, 3 * dim, bias=qkv_bias)
        self.proj = L.init_linear(gen, dim, dim)
        self.rel_pos_bias = nn.Parameter(_trunc_normal(
            gen, ((2 * window - 1) ** 2, num_heads)))
        self.norm2 = L.Norm(dim)
        self.fc1 = L.init_linear(gen, dim, hidden)
        self.fc2 = L.init_linear(gen, hidden, dim)

    def attention(self, x, rel_index, mask=None):
        """x: [nW, N, C] windows; mask: [num_win_types, N, N] or None."""
        nw, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = self.qkv(x).reshape(nw, n, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # the scale divides the product, as in the JAX package
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        bias = self.rel_pos_bias[rel_index.reshape(-1)].reshape(
            n, n, heads).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nt = mask.shape[0]
            attn = (attn.reshape(nw // nt, nt, heads, n, n)
                    + mask[None, :, None].to(attn.dtype)
                    ).reshape(nw, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
        return self.proj(out)

    def forward(self, x, window, shift, rel_index, masks, drop=None):
        """``drop``: None, or (rate, generator) for stochastic depth on
        the attention and the FFN branch, one draw each, in that order."""
        b, h, w, c = x.shape
        shortcut = x
        x = self.norm1(x)
        # pad to multiples of the window after norm1, with zeros
        # (reference swin :188-192)
        pad_b = (window - h % window) % window
        pad_r = (window - w % window) % window
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = x.shape[1:3]
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = masks(hp, wp, shift)
        wins = window_partition(x, window).reshape(-1, window * window, c)
        wins = self.attention(wins, rel_index, mask)
        x = window_reverse(wins.reshape(-1, window, window, c), window,
                           b, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x[:, :h, :w]
        if drop is not None:
            x = drop_path(x, *drop)
        x = shortcut + x
        ffn = self.fc2(L.gelu(self.fc1(self.norm2(x))))
        if drop is not None:
            ffn = drop_path(ffn, *drop)
        return x + ffn


class PatchMerge(nn.Module):
    def __init__(self, gen: torch.Generator, dim: int):
        super().__init__()
        self.reduction = L.init_linear(gen, 4 * dim, 2 * dim, bias=False)
        self.norm = L.Norm(4 * dim)

    def forward(self, x):
        """[B, H, W, C] -> [B, ceil(H/2), ceil(W/2), 2C] (reference swin
        :257-297; odd sizes padded with zeros first)."""
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: SwinConfig):
        super().__init__()
        self.proj = L.init_conv(gen, cfg.patch_size, cfg.patch_size, 3,
                                cfg.embed_dim)
        self.norm = L.Norm(cfg.embed_dim) if cfg.patch_norm else None


class _Stage(nn.Module):
    def __init__(self, gen, cfg: SwinConfig, si: int, dim: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(gen, dim, cfg.num_heads[si], cfg.window_size,
                      cfg.mlp_ratio, cfg.qkv_bias)
            for _ in range(cfg.depths[si])])
        self.downsample = (PatchMerge(gen, dim)
                           if si < len(cfg.depths) - 1 else None)


class SwinTransformer(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(gen, cfg)
        dims = [cfg.embed_dim * 2 ** i for i in range(len(cfg.depths))]
        for si, dim in enumerate(dims):
            self.add_module(f"stage{si}", _Stage(gen, cfg, si, dim))
        # per-out-level norms (reference swin :590-597)
        for i, dim in enumerate(dims):
            self.add_module(f"out_norm{i}", L.Norm(dim))
        self.register_buffer("rel_index", rel_pos_index(cfg.window_size),
                             persistent=False)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, shift: int) -> torch.Tensor:
        """The shift mask of a padded (hp, wp) map, made once per shape on
        the buffers' device (a plain tensor even under inference_mode)."""
        dev = self.rel_index.device
        key = (hp, wp, shift, dev)
        if key not in self._masks:
            with torch.inference_mode(False), torch.no_grad():
                self._masks[key] = shift_mask(hp, wp, self.cfg.window_size,
                                              shift, device=dev)
        return self._masks[key]

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """``apply_swin``: img [B, H, W, 3] -> the levels of ``out_indices``
        at strides 4/8/16/32.  ``generator``: train-time stochastic depth
        at :func:`drop_path_rates`; None (inference) is the identity.  As
        in the JAX package, a block of an even stage of depth >= 4 (one
        that the JAX package scans) draws at every rate, 0 included, and
        any other block only where its rate is > 0."""
        cfg = self.cfg
        dpr = drop_path_rates(cfg)
        gi = 0
        x = self.patch_embed.proj(img, stride=cfg.patch_size, padding=0)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        outs = []
        for si in range(len(cfg.depths)):
            stage = getattr(self, f"stage{si}")
            depth = len(stage.blocks)
            scanned = depth >= 4 and depth % 2 == 0
            for bi, blk in enumerate(stage.blocks):
                drop = None
                if generator is not None and (scanned or dpr[gi] > 0):
                    drop = (dpr[gi], generator)
                gi += 1
                # odd blocks always shift, also on maps smaller than the
                # window: the reference pads, rolls and masks
                # (swin_transformer.py:361-404)
                shift = 0 if bi % 2 == 0 else cfg.window_size // 2
                x = blk(x, cfg.window_size, shift, self.rel_index,
                        self._mask, drop)
            if si in cfg.out_indices:
                outs.append(getattr(self, f"out_norm{si}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def init_swin(gen: torch.Generator, cfg: SwinConfig) -> SwinTransformer:
    return SwinTransformer(gen, cfg)
