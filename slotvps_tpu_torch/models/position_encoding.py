"""Position embeddings (counterpart of
``slotvps_tpu/models/position_encoding.py``): the sine embedding
(reference ``PositionEmbeddingSine`` with ``normalize=True``), its
flattened form (``PositionEmbeddingSinev2``), the learned 50-bin
row/column embedding (``PositionEmbeddingLearned``) and the
relative-position variants (reference position_encoding.py:15-218:
``FullRelPos``, ``SwinRelPos``, ``RelPos``, ``DPSConvPos``).  No shipped
configuration uses the variants, and no entry point calls them, in either
package; ``utils/convert.from_jax_module`` carries their JAX parameters
across."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi,
                            dtype=torch.float32,
                            device=None) -> torch.Tensor:
    """Returns [H, W, 2*num_pos_feats] (y-features then x-features)."""
    f32 = dict(dtype=torch.float32, device=device)
    y_embed = torch.arange(1, h + 1, **f32)[:, None] * torch.ones((1, w), **f32)
    x_embed = torch.arange(1, w + 1, **f32)[None, :] * torch.ones((h, 1), **f32)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # interleave sin/cos over even/odd feature pairs (reference :253-254)
    pos_x = torch.stack((torch.sin(pos_x[:, :, 0::2]),
                         torch.cos(pos_x[:, :, 1::2])), dim=3
                        ).reshape(h, w, num_pos_feats)
    pos_y = torch.stack((torch.sin(pos_y[:, :, 0::2]),
                         torch.cos(pos_y[:, :, 1::2])), dim=3
                        ).reshape(h, w, num_pos_feats)
    return torch.cat((pos_y, pos_x), dim=-1).to(dtype)


class LearnedPositionEmbedding(nn.Module):
    """``PositionEmbeddingLearned`` (reference :309-333): one table of
    ``num_bins`` rows per axis, uniform init from ``gen``."""

    def __init__(self, gen: torch.Generator, num_pos_feats: int = 128,
                 num_bins: int = 50):
        super().__init__()
        shape = (num_bins, num_pos_feats)
        self.row_embed = nn.Parameter(torch.rand(shape, generator=gen))
        self.col_embed = nn.Parameter(torch.rand(shape, generator=gen))

    def forward(self, h: int, w: int, dtype=torch.float32) -> torch.Tensor:
        """[H, W, 2*num_pos_feats]: column features then row features
        (reference cat([x_emb, y_emb])).  A level taller or wider than the
        table raises, where the JAX package's broadcast fails."""
        bins, d = self.col_embed.shape
        if h > bins or w > bins:
            raise ValueError(f"learned position embedding: a {h}x{w} level "
                             f"exceeds the table's {bins} bins per axis")
        x_emb = self.col_embed[:w][None].expand(h, w, d)
        y_emb = self.row_embed[:h][:, None].expand(h, w, d)
        return torch.cat([x_emb, y_emb], dim=-1).to(dtype)


def sine_position_embedding_v2(h: int, w: int, num_pos_feats: int = 128,
                               temperature: float = 10000.0,
                               normalize: bool = False,
                               dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """``PositionEmbeddingSinev2`` (reference :259-306): the features of
    :func:`sine_position_embedding` flattened to [H*W, 2*num_pos_feats],
    ``normalize`` off by default."""
    return sine_position_embedding(h, w, num_pos_feats, temperature,
                                   normalize, dtype=dtype,
                                   device=device).reshape(h * w, -1)


# ---------------------------------------------------------------------------
# relative-position variants: the attention-bias modules take the
# decomposed-axis query layout q [B, h*w, P, G, 2c] (the first channel half
# attends rows, the second columns) and attn [B, G, h*w, kh*kw, P]
# ---------------------------------------------------------------------------


def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02):
    """timm's truncated normal in [-2 std, 2 std] (reference
    mmdet/core/utils/misc.py trunc_normal_)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
    return nn.Parameter(t)


def _axis_rel_table(emb: torch.Tensor, length: int) -> torch.Tensor:
    """[2*len-1, c] -> [q, k, c] by the relative index q - k + len - 1
    (reference :37-42)."""
    pos = torch.arange(length, device=emb.device)
    return emb[pos[None, :] - pos[:, None] + length - 1]


def _add_axis_logits(q, attn, abs_h, abs_w, rows: int, cols: int):
    """attn + the row half of q against ``abs_h`` [rows, kh, c] and the
    column half against ``abs_w`` [cols, kw, c]."""
    b, hw, p, g, c2 = q.shape
    kh, kw = abs_h.shape[1], abs_w.shape[1]
    qs = q.reshape(b, rows, cols, p, g, 2, c2 // 2)
    logits_h = torch.einsum("bhwpgc,hkc->bghwkp", qs[..., 0, :], abs_h)
    logits_w = torch.einsum("bhwpgc,wkc->bghwkp", qs[..., 1, :], abs_w)
    attn = attn.reshape(b, g, hw, kh, kw, p)
    attn = attn + logits_h.reshape(b, g, hw, kh, 1, p)
    attn = attn + logits_w.reshape(b, g, hw, 1, kw, p)
    return attn.reshape(b, g, hw, kh * kw, p)


class FullRelPos(nn.Module):
    """``FullRelPos`` (reference :15-48, has_map=False): one relative
    embedding a axis over the offsets [-(len-1), len-1]."""

    def __init__(self, gen: torch.Generator, h: int, w: int, dim: int):
        super().__init__()
        self.h, self.w = h, w
        self.rel_emb_h = _trunc_normal(gen, (2 * h - 1, dim // 2))
        self.rel_emb_w = _trunc_normal(gen, (2 * w - 1, dim // 2))

    def forward(self, q: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """``FullRelPos.forward`` without rois (reference :113-120): attn
        plus the per-axis relative logits."""
        return _add_axis_logits(q, attn,
                                _axis_rel_table(self.rel_emb_h, self.h),
                                _axis_rel_table(self.rel_emb_w, self.w),
                                self.h, self.w)


class SwinRelPos(nn.Module):
    """``SwinRelPos`` (reference :123-143): one bias table over the
    (2h-1) x (2w-1) relative offsets; the index is recomputed from h, w."""

    def __init__(self, gen: torch.Generator, h: int, w: int,
                 num_heads: int = 1):
        super().__init__()
        self.h, self.w = h, w
        self.bias_table = _trunc_normal(
            gen, ((2 * h - 1) * (2 * w - 1), num_heads))

    def forward(self) -> torch.Tensor:
        """[1, nH, h*w, h*w, 1] additive attention bias (reference
        :145-149)."""
        h, w = self.h, self.w
        dev = self.bias_table.device
        flat = torch.stack(torch.meshgrid(
            torch.arange(h, device=dev), torch.arange(w, device=dev),
            indexing="ij")).reshape(2, -1)
        rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) \
            + torch.tensor([h - 1, w - 1], device=dev)
        index = rel[..., 0] * (2 * w - 1) + rel[..., 1]
        bias = self.bias_table[index.reshape(-1)].reshape(h * w, h * w, -1)
        return bias.permute(2, 0, 1)[None, ..., None]


class RelPos(nn.Module):
    """``RelPos`` (reference :152-178): windowed relative embeddings over
    the 2 * win_len offsets [-win_len, win_len) of each axis."""

    def __init__(self, gen: torch.Generator, dim: int, win_len: int = 1):
        super().__init__()
        self.win_len = win_len
        self.rel_emb_h = _trunc_normal(gen, (2 * win_len, dim // 2))
        self.rel_emb_w = _trunc_normal(gen, (2 * win_len, dim // 2))

    def _onehot(self, q_len: int, k_len: int, device) -> torch.Tensor:
        """[q, k, 2 win_len]: 1 where k - q is the r-th offset (reference
        :158-168)."""
        rel = torch.arange(-self.win_len, self.win_len, device=device)
        diff = (torch.arange(k_len, device=device)[None, :]
                - torch.arange(q_len, device=device)[:, None])
        return (diff[:, :, None] == rel).float()

    def forward(self, q: torch.Tensor, attn: torch.Tensor, q_len: int,
                k_len: int) -> torch.Tensor:
        """``RelPos.forward`` (reference :180-204): q_len x q_len queries
        over k_len x k_len keys, the layouts of :class:`FullRelPos`."""
        onehot = self._onehot(q_len, k_len, q.device)
        abs_h = torch.einsum("qkr,rc->qkc", onehot, self.rel_emb_h)
        abs_w = torch.einsum("qkr,rc->qkc", onehot, self.rel_emb_w)
        return _add_axis_logits(q, attn, abs_h, abs_w, q_len, q_len)


class DPSConvPos(nn.Module):
    """``DPSConvPos`` (reference :211-218): a depthwise k x k convolution
    over the token grid, no bias; torch's kaiming-uniform init for a
    convolution with groups = dim (bound sqrt(3 / (k k)))."""

    def __init__(self, gen: torch.Generator, dim: int, k: int):
        super().__init__()
        bound = math.sqrt(3.0 / (k * k))
        self.weight = nn.Parameter(
            (torch.rand((dim, 1, k, k), generator=gen) * 2 - 1) * bound)

    def forward(self, v: torch.Tensor, h: int) -> torch.Tensor:
        """v [B, h*w, C] -> [B, h*w, C], "SAME" padding."""
        b, hw, c = v.shape
        k = self.weight.shape[-1]
        x = v.reshape(b, h, hw // h, c).permute(0, 3, 1, 2)
        x = F.pad(x, ((k - 1) // 2, k // 2, (k - 1) // 2, k // 2))
        out = F.conv2d(x, self.weight.to(v.dtype), groups=c)
        return out.permute(0, 2, 3, 1).reshape(b, hw, c)
