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
of the JAX package) and the output takes ``x.dtype``.

Layouts as in the JAX package: x NHWC, offset NHWC with channels
``[tap0_dy, tap0_dx, tap1_dy, ...]``, weight ``[kh, kw, C_in, C_out]``.
"""

from __future__ import annotations

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
