"""Deformable convolution v1 — the plain PyTorch version.

Counterpart of ``slotvps_tpu/ops/deform_conv.py`` ``deform_conv2d`` and the
oracle of the Hopper kernel (``ops/cuda/deform_conv.py``).  It keeps the
JAX package's halo contract exactly.  For every kernel tap k the sampling
position is

    y = oy * stride - pad + ky * dilation + offset[..., 2k]      (dy)
    x = ox * stride - pad + kx * dilation + offset[..., 2k + 1]  (dx)

* validity is tested at the UNCLAMPED position: a tap contributes iff
  ``-1 < y < H`` and ``-1 < x < W`` (the CUDA ``deformable_im2col`` rule);
* the bilinear sample is taken at the position clamped to rigid +- halo
  (``max_displacement``), exact inside the halo;
* bilinear corners outside the image read 0.

``compute_dtype=torch.bfloat16`` computes what the bf16 Pallas kernel
(``slotvps_tpu/ops/pallas/deform_conv.py`` ``_dcn_kernel``) and the bf16
Hopper kernel compute, with their three rounding points:

1. each bilinear corner weight is formed in f32 (zero for an invalid tap)
   and rounded to bf16;
2. a sample is the f32 sum over its corners of bf16 weight x bf16 input,
   rounded to bf16;
3. the output is the f32 sum over taps and input channels of bf16 sample x
   bf16 weight, rounded to the output dtype.

With the default f32 the whole computation is f32 (the XLA ``deform_conv2d``
of the JAX package) and the output takes ``x.dtype``.  Autograd through
:func:`deform_conv2d` in f32 is ``jax.grad`` of that XLA path: the offset
gradient is zero on a clamped axis and on an invalid tap.

:func:`offset_clamp_stats` measures how much an offset field clamps at a
halo.  :func:`deform_conv2d_reference` is the float64 numpy oracle of the
JAX package (no halo clamp, any stride, padding, dilation and mask).
:func:`deform_conv2d_backward` is the plain version of the backward
kernel (``slotvps_tpu/ops/pallas/deform_conv.py`` ``_dcn_bwd_kernel``, the
Hopper kernel in ``csrc/deform_conv.cu``), at the bf16 kernel's rounding
points.

Layouts as in the JAX package: x NHWC, offset NHWC with channels
``[tap0_dy, tap0_dx, tap1_dy, ...]``, weight ``[kh, kw, C_in, C_out]``.
"""

from __future__ import annotations

import numpy as np
import torch


def _bilinear_sample_4corners(x_pad, y0i, x0i, fy, fx, halo, h, w,
                              weight_dtype=torch.float32):
    """Bilinear sample of x_pad (padded by halo+2 per side) at
    (y0i+fy, x0i+fx), one gather for all four corners.  The f32 corner
    weights are rounded to ``weight_dtype``; the sum is f32."""
    pad = halo + 2
    wp = w + 2 * pad
    b, hh, ww = y0i.shape
    c = x_pad.shape[-1]
    flat = x_pad.reshape(b, -1, c)
    base = (y0i + pad) * wp + (x0i + pad)               # [B, H, W]
    # corner order: (0,0), (0,1), (1,0), (1,1)
    idx = torch.stack([base, base + 1, base + wp, base + wp + 1], dim=-1)
    wgt = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                       fy * (1 - fx), fy * fx], dim=-1)   # [B, H, W, 4]
    wgt = wgt.to(weight_dtype).float()
    vals = torch.gather(
        flat, 1, idx.reshape(b, hh * ww * 4, 1).expand(-1, -1, c)
    ).reshape(b, hh, ww, 4, c)
    return torch.einsum("bhwkc,bhwk->bhwc", vals, wgt)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, stride: int = 1, padding: int = 1,
                  dilation: int = 1,
                  max_displacement: int = 8,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Deformable conv forward (f32 math, or bf16 with the rounding points
    of the module docstring).

    x:      [B, H, W, C_in]
    offset: [B, H_out, W_out, 2*kh*kw]  ([dy, dx] per tap); taken in f32
    weight: [kh, kw, C_in, C_out]
    """
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} is not float32 or "
                         "bfloat16")
    b, h, w, c_in = x.shape
    kh, kw, wc_in, c_out = weight.shape
    if wc_in != c_in:
        raise ValueError(f"weight C_in {wc_in} != input C_in {c_in}")
    h_out = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    w_out = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    if tuple(offset.shape) != (b, h_out, w_out, 2 * kh * kw):
        raise ValueError(f"offset shape {tuple(offset.shape)}")

    halo = int(max_displacement)
    pad = halo + 2
    x_pad = torch.nn.functional.pad(x.to(compute_dtype).float(),
                                    (0, 0, pad, pad, pad, pad))
    dev = x.device
    base_y = (torch.arange(h_out, dtype=torch.float32, device=dev) * stride
              - padding)[:, None]
    base_x = (torch.arange(w_out, dtype=torch.float32, device=dev) * stride
              - padding)[None, :]
    wf = weight.to(compute_dtype).float()

    out = torch.zeros((b, h_out, w_out, c_out), dtype=torch.float32,
                      device=dev)
    for ky in range(kh):
        for kx in range(kw):
            k = ky * kw + kx
            dy = offset[..., 2 * k].float()
            dx = offset[..., 2 * k + 1].float()
            rig_y = base_y + ky * dilation
            rig_x = base_x + kx * dilation
            py = rig_y + dy
            px = rig_x + dx
            valid = (py > -1) & (py < h) & (px > -1) & (px < w)
            py = torch.minimum(torch.maximum(py, rig_y - halo), rig_y + halo)
            px = torch.minimum(torch.maximum(px, rig_x - halo), rig_x + halo)
            y0 = torch.floor(py)
            x0 = torch.floor(px)
            sample = _bilinear_sample_4corners(
                x_pad, y0.long(), x0.long(), py - y0, px - x0, halo, h, w,
                compute_dtype)
            sample = torch.where(valid[..., None], sample, 0.0)
            sample = sample.to(compute_dtype).float()
            out = out + sample @ wf[ky, kx]
    return out.to(x.dtype)


def offset_clamp_stats(offset: torch.Tensor, halo: int):
    """How much an offset field would clamp at ``halo`` (the JAX package's
    ``offset_clamp_stats``): ``offset`` [..., 2*kh*kw] ([dy, dx] per tap)
    -> ``(max_abs, clamp_rate)`` f32 scalars, the largest |offset|
    component and the share of taps with either component beyond
    ``halo``."""
    a = offset.float().abs()
    per_tap = a.reshape(*offset.shape[:-1], -1, 2).amax(dim=-1)
    return a.max(), (per_tap > halo).float().mean()


def _tap_geometry(offset, k, h, w, halo):
    """Tap k's sampling geometry at every output pixel (stride 1, pad 1):
    floor corners, fractions, validity and the not-clamped masks."""
    dev = offset.device
    ky, kx = divmod(k, 3)
    rig_y = (torch.arange(h, dtype=torch.float32, device=dev) - 1
             + ky)[:, None]
    rig_x = (torch.arange(w, dtype=torch.float32, device=dev) - 1
             + kx)[None, :]
    py = rig_y + offset[..., 2 * k].float()
    px = rig_x + offset[..., 2 * k + 1].float()
    valid = (py > -1) & (py < h) & (px > -1) & (px < w)
    # the clamp passes the derivative on the closed interval
    ncy = (py >= rig_y - halo) & (py <= rig_y + halo)
    ncx = (px >= rig_x - halo) & (px <= rig_x + halo)
    py = torch.minimum(torch.maximum(py, rig_y - halo), rig_y + halo)
    px = torch.minimum(torch.maximum(px, rig_x - halo), rig_x + halo)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    return y0.long(), x0.long(), py - y0, px - x0, valid, ncy, ncx


def deform_conv2d_backward(x: torch.Tensor, offset: torch.Tensor,
                           weight: torch.Tensor, g: torch.Tensor, halo: int,
                           compute_dtype=torch.float32):
    """Gradients of the 3x3 stride-1 pad-1 deformable conv with samples
    clamped to +-``halo``, given the output gradient ``g`` [B, H, W, Cout].

    Returns (dx [B, H, W, Cin] in ``x.dtype``, doff [B, H, W, 18] f32,
    dW [3, 3, Cin, Cout] f32).  It computes what the Pallas backward kernel
    computes, per tap k, rounding to ``compute_dtype`` where that kernel
    does:

    * ``g`` and ``W`` are rounded; ``dsample = g . W_k^T`` is summed in f32
      and rounded;
    * the corner weights ``M`` are rounded, their position derivatives
      ``dM`` stay f32: ``dM/dy`` is zero where y is clamped, ``dM/dx`` where
      x is clamped, and both on an invalid tap (no weight);
    * ``dx = sum M . dsample`` is summed in f32 (corners outside the image
      are dropped);
    * the samples ``M . x`` (``x`` rounded) are summed in f32 and rounded,
      and ``dW_k = samples^T . g`` is summed in f32;
    * ``doff = sum over corners of dM . (dsample . x_corner)``, f32 sums.
    """
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} is not float32 or "
                         "bfloat16")
    b, h, w, c_in = x.shape
    c_out = weight.shape[-1]
    if tuple(weight.shape) != (3, 3, c_in, c_out) \
            or tuple(offset.shape) != (b, h, w, 18) \
            or tuple(g.shape) != (b, h, w, c_out):
        raise ValueError(f"shapes x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, weight "
                         f"{tuple(weight.shape)}, g {tuple(g.shape)}")
    halo = int(halo)
    pad = halo + 2
    wp = w + 2 * pad
    x_pad = torch.nn.functional.pad(x.to(compute_dtype).float(),
                                    (0, 0, pad, pad, pad, pad))
    flat = x_pad.reshape(b, -1, c_in)
    dx_pad = torch.zeros_like(flat)
    gc = g.to(compute_dtype).float().reshape(b, h * w, c_out)
    wc = weight.to(compute_dtype).float()
    doff = torch.zeros((b, h, w, 18), dtype=torch.float32, device=x.device)
    dw = torch.zeros((3, 3, c_in, c_out), dtype=torch.float32,
                     device=x.device)
    for k in range(9):
        ky, kx = divmod(k, 3)
        y0, x0, fy, fx, valid, ncy, ncx = _tap_geometry(offset, k, h, w,
                                                        halo)
        vf = valid.float()
        roww = (1 - fy, fy)
        colw = ((1 - fx) * vf, fx * vf)
        gy = ncy.float()
        gx = (valid & ncx).float()
        # corner order (0,0), (0,1), (1,0), (1,1)
        corners = [(a, c) for a in (0, 1) for c in (0, 1)]
        m = torch.stack([roww[a] * colw[c] for a, c in corners], dim=-1)
        m = m.to(compute_dtype).float().reshape(b, h * w, 4)
        dmy = torch.stack([(colw[c] if a else -colw[c]) * gy
                           for a, c in corners], -1).reshape(b, h * w, 4)
        dmx = torch.stack([(roww[a] if c else -roww[a]) * gx
                           for a, c in corners], -1).reshape(b, h * w, 4)
        base = (y0 + pad) * wp + (x0 + pad)
        idx = torch.stack([base, base + 1, base + wp, base + wp + 1],
                          dim=-1).reshape(b, h * w * 4, 1).expand(-1, -1,
                                                                   c_in)
        vals = torch.gather(flat, 1, idx).reshape(b, h * w, 4, c_in)
        ds = (gc @ wc[ky, kx].T).to(compute_dtype).float()   # [B, HW, Cin]
        dx_pad.scatter_add_(
            1, idx, (m[..., None] * ds[:, :, None, :]).reshape(
                b, h * w * 4, c_in))
        samples = torch.einsum("bpjc,bpj->bpc", vals, m).to(
            compute_dtype).float()
        dw[ky, kx] = samples.reshape(-1, c_in).T @ gc.reshape(-1, c_out)
        pt = torch.einsum("bpjc,bpc->bpj", vals, ds)
        doff[..., 2 * k] = (dmy * pt).sum(-1).reshape(b, h, w)
        doff[..., 2 * k + 1] = (dmx * pt).sum(-1).reshape(b, h, w)
    dx = dx_pad.reshape(b, h + 2 * pad, wp, c_in)[:, pad:pad + h,
                                                   pad:pad + w]
    return dx.to(x.dtype), doff, dw


def deform_conv2d_reference(x, offset, weight, mask=None, stride=1,
                            padding=1, dilation=1) -> np.ndarray:
    """Slow float64 numpy reference (no halo clamp) for kernel parity
    tests: the JAX package's ``deform_conv2d_reference``.  Inputs are
    arrays (or CPU tensors) in the layouts above, ``mask`` [B, Ho, Wo,
    kh*kw] (modulated DCN); returns [B, Ho, Wo, C_out] float64."""
    x = np.asarray(x, np.float64)
    offset = np.asarray(offset, np.float64)
    weight = np.asarray(weight, np.float64)
    if mask is not None:
        mask = np.asarray(mask, np.float64)
    b, h, w, c_in = x.shape
    kh, kw, _, c_out = weight.shape
    h_out = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    w_out = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    out = np.zeros((b, h_out, w_out, c_out))

    def samp(img, py, px):
        if not (-1 < py < h and -1 < px < w):
            return np.zeros(c_in)
        y0, x0 = int(np.floor(py)), int(np.floor(px))
        fy, fx = py - y0, px - x0
        acc = np.zeros(c_in)
        for cy, wy in ((y0, 1 - fy), (y0 + 1, fy)):
            for cx, wx in ((x0, 1 - fx), (x0 + 1, fx)):
                if 0 <= cy < h and 0 <= cx < w and wy * wx != 0:
                    acc += img[cy, cx] * wy * wx
        return acc

    for bi in range(b):
        for oy in range(h_out):
            for ox in range(w_out):
                for ky in range(kh):
                    for kx in range(kw):
                        k = ky * kw + kx
                        py = oy * stride - padding + ky * dilation \
                            + offset[bi, oy, ox, 2 * k]
                        px = ox * stride - padding + kx * dilation \
                            + offset[bi, oy, ox, 2 * k + 1]
                        s = samp(x[bi], py, px)
                        if mask is not None:
                            s = s * mask[bi, oy, ox, k]
                        out[bi, oy, ox] += s @ weight[ky, kx]
    return out
