"""Hopper DCN kernels: library, wrappers and the autograd Function.

``csrc/deform_conv.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``: nvcc for ``sm_90a`` at first use, ctypes).  It has
four entry points, two per compute dtype: ``dcn_forward_f32`` (f32 FMA),
``dcn_forward_bf16`` (the gather on producer warps, the product on wgmma
with f32 accumulation, the bf16 Pallas kernel's rounding points, an f32 or
a bf16 output; its launch geometry is :func:`bf16_forward_geometry`), and
the backward
``dcn_backward_f32`` / ``dcn_backward_bf16`` (dx, doff and dW, each summed
in a fixed order: the same on every run).

:func:`deform_conv2d_hopper` is the differentiable DCN of the semantic
tower, the counterpart of the JAX package's ``deform_conv2d_pallas`` with
its custom VJP: a ``torch.autograd.Function`` whose forward is the forward
kernel and whose backward is :func:`dcn_backward_hopper`.  As in the JAX
package, ``x`` and the weight go to the kernel in ``compute_dtype``, the
offsets in f32 (a bf16 model's bf16 offsets widen exactly), and the output
takes ``x.dtype`` without an extra rounding; dx comes back in ``x.dtype``,
doff in the offsets' dtype, dW in the weight's.

On CPU tensors both wrappers run the plain versions
(:func:`slotvps_tpu_torch.ops.deform_conv.deform_conv2d` and
``deform_conv2d_backward``); on CUDA tensors they launch the kernel of
``compute_dtype`` or raise — there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_backward)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dcn_forward_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.dcn_forward_bf16.argtypes = [p, p, p, p, p] + [i] * 10 + [p]
    for fn in (lib.dcn_backward_f32, lib.dcn_backward_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    for fn in (lib.dcn_forward_f32, lib.dcn_forward_bf16,
               lib.dcn_backward_f32, lib.dcn_backward_bf16):
        fn.restype = i
    lib.dcn_forward_bf16_smem.argtypes = [i]
    lib.dcn_forward_bf16_smem.restype = i
    lib.dcn_error_string.argtypes = [i]
    lib.dcn_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("deform_conv", _declare)

_KEY = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# blocks the dW pass aims to put on the card (132 SMs, a few blocks each)
_DW_TARGET_BLOCKS = 528
_DW_TILE, _DW_STEP = 64, 32   # TM = TN, KP of csrc/deform_conv.cu
# the bf16 forward's pixel tiles (rows, columns), largest first: at most
# 64 pixels, the wgmma tile's rows (FM of csrc/deform_conv.cu)
_FWD_TILES = ((4, 16), (4, 8), (2, 8))
_FWD_CHUNK = 64               # input channels per chunk (FK)


class Bf16Geometry(NamedTuple):
    """Launch geometry of ``dcn_forward_bf16`` for one image."""
    tile_h: int
    tile_w: int
    n_tile: int        # output channels per block: 64, 128 or 256
    n_ctiles: int      # output-channel tiles: ceil(Cout / n_tile)
    blocks: int        # blocks per image

    def wimg_elems(self, c_in: int) -> int:
        """bf16 elements of the kernel's weight image."""
        return self.n_ctiles * 9 * -(-c_in // _FWD_CHUNK) * self.n_tile * 64


def bf16_forward_geometry(h: int, w: int, c_out: int,
                          n_sm: int) -> Bf16Geometry:
    """The bf16 forward's tile for an H x W image with Cout outputs on a
    card of ``n_sm`` SMs: all of Cout (up to 256) per block, so each sample
    is gathered once, and the largest pixel tile that still puts ``n_sm``
    blocks on the card; where even the smallest tile does not, Cout is
    split in halves (each split gathers the samples once more) until it
    does or the tile has 64 channels.  A function of the image's shape and
    the card, never of the batch, so an image's output is the same alone
    and in a batch."""
    def make(th, tw, nt):
        nct = -(-c_out // nt)
        return Bf16Geometry(th, tw, nt, nct,
                            -(-h // th) * -(-w // tw) * nct)

    n_tile = 64 if c_out <= 64 else 128 if c_out <= 128 else 256
    for th, tw in _FWD_TILES:
        geo = make(th, tw, n_tile)
        if geo.blocks >= n_sm:
            return geo
    while geo.blocks < n_sm and geo.n_tile > 64:
        geo = make(geo.tile_h, geo.tile_w, geo.n_tile // 2)
    return geo


def _check(name, x, offset, weight, halo, compute_dtype, g=None):
    """The kernels' contract; returns (B, H, W, Cin, Cout)."""
    tensors = [x, offset, weight] + ([] if g is None else [g])
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device "
                         "(or all on the CPU)")
    if compute_dtype not in _KEY:
        raise TypeError(f"{name}: compute_dtype must be float32 or bfloat16, "
                        f"got {compute_dtype}")
    if any(t.dtype not in _KEY for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(not t.is_contiguous() for t in tensors if t is not weight):
        raise ValueError(f"{name} takes contiguous activations")
    if x.ndim != 4 or weight.ndim != 4:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    b, h, w, c_in = x.shape
    kh, kw, wc_in, c_out = weight.shape
    if (kh, kw) != (3, 3) or wc_in != c_in:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)} (need [3, 3, Cin, Cout])")
    if tuple(offset.shape) != (b, h, w, 18):
        raise ValueError(f"offset {tuple(offset.shape)} != {(b, h, w, 18)}")
    if g is not None and tuple(g.shape) != (b, h, w, c_out):
        raise ValueError(f"g {tuple(g.shape)} != {(b, h, w, c_out)}")
    if compute_dtype == torch.float32 and g is None and c_out % 4:
        raise ValueError(f"Cout={c_out} must be a multiple of 4 in float32")
    if int(halo) < 0:
        raise ValueError(f"halo {halo} must be >= 0")
    return b, h, w, c_in, c_out


def _raise_on(lib, entry, rc):
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.dcn_error_string(rc).decode())


def _forward_kernel(x, offset, weight, halo, compute_dtype):
    """One launch of the forward kernel of ``compute_dtype``; the output in
    ``x.dtype``."""
    b, h, w, c_in, c_out = _check("deform_conv2d_hopper", x, offset, weight,
                                  halo, compute_dtype)
    dev = x.device
    xc = x.to(compute_dtype).contiguous()
    wc = weight.to(compute_dtype).contiguous()
    off = offset.float().contiguous()
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if compute_dtype == torch.float32:
        out = torch.empty((b, h, w, c_out), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.dcn_forward_f32(xc.data_ptr(), off.data_ptr(),
                                     wc.data_ptr(), out.data_ptr(), b, h, w,
                                     c_in, c_out, int(halo), stream)
        entry = "dcn_forward_f32"
    else:
        out_dtype = (torch.float32 if x.dtype == torch.float32
                     else torch.bfloat16)
        out = torch.empty((b, h, w, c_out), dtype=out_dtype, device=dev)
        geo = bf16_forward_geometry(
            h, w, c_out,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        wimg = torch.empty((geo.wimg_elems(c_in),), dtype=torch.bfloat16,
                           device=dev)
        with torch.cuda.device(dev):
            rc = lib.dcn_forward_bf16(
                xc.data_ptr(), off.data_ptr(), wc.data_ptr(),
                wimg.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.float32), b, h, w, c_in, c_out,
                int(halo), geo.tile_h, geo.tile_w, geo.n_tile, stream)
        entry = "dcn_forward_bf16"
    _raise_on(lib, entry, rc)
    key = _KEY[compute_dtype]
    if compute_dtype == torch.bfloat16 and out.dtype == torch.float32:
        key = "bfloat16_f32"
    deform_conv2d_hopper.launches[key] += 1
    return out.to(x.dtype)


def _dw_splits(n_pix: int, c_in: int, c_out: int) -> int:
    """Pixel ranges of the dW pass: enough blocks to fill the card, each
    range at least one step of pixels.  A function of the shape only, so
    dW's order of sums is fixed."""
    tiles = -(-9 * c_in // _DW_TILE) * -(-c_out // _DW_TILE)
    steps = -(-n_pix // _DW_STEP)
    return max(1, min(-(-_DW_TARGET_BLOCKS // tiles), steps))


def dcn_backward_hopper(x: torch.Tensor, offset: torch.Tensor,
                        weight: torch.Tensor, g: torch.Tensor, halo: int,
                        compute_dtype=torch.float32):
    """Backward of the 3x3 stride-1 pad-1 deformable conv with samples
    clamped to +-halo, from the output gradient ``g`` [B, H, W, Cout].

    Returns (dx [B, H, W, Cin] in ``x.dtype``, doff [B, H, W, 18] f32,
    dW [3, 3, Cin, Cout] f32), computed in ``compute_dtype`` at the Pallas
    backward kernel's rounding points, each the same on every run.  On the
    card it takes a scratch buffer of dsample, [B*H*W, 9, Cin] in
    ``compute_dtype`` (0.74 GB in bf16 at 2 x 200 x 400 pixels and Cin
    256).  Each kernel launch (one call: the data, dx, weight and reduction
    passes) adds one to ``dcn_backward_hopper.launches[dtype name]``."""
    if all(t.device.type == "cpu" for t in (x, offset, weight, g)):
        return deform_conv2d_backward(x, offset, weight, g, halo,
                                      compute_dtype)
    b, h, w, c_in, c_out = _check("dcn_backward_hopper", x, offset, weight,
                                  halo, compute_dtype, g)
    dev = x.device
    xc = x.to(compute_dtype).contiguous()
    wc = weight.to(compute_dtype).contiguous()
    gc = g.to(compute_dtype).contiguous()
    off = offset.float().contiguous()
    splits = _dw_splits(b * h * w, c_in, c_out)
    dx = torch.empty((b, h, w, c_in), dtype=torch.float32, device=dev)
    doff = torch.empty((b, h, w, 18), dtype=torch.float32, device=dev)
    ds = torch.empty((b * h * w * 9 * c_in,), dtype=compute_dtype, device=dev)
    part = torch.empty((splits, 9 * c_in, c_out), dtype=torch.float32,
                       device=dev)
    dw = torch.empty((3, 3, c_in, c_out), dtype=torch.float32, device=dev)
    entry = ("dcn_backward_f32" if compute_dtype == torch.float32
             else "dcn_backward_bf16")
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            xc.data_ptr(), off.data_ptr(), wc.data_ptr(), gc.data_ptr(),
            dx.data_ptr(), doff.data_ptr(), ds.data_ptr(), part.data_ptr(),
            dw.data_ptr(),
            b, h, w, c_in, c_out, int(halo), splits, stream)
    _raise_on(lib, entry, rc)
    dcn_backward_hopper.launches[_KEY[compute_dtype]] += 1
    return dx.to(x.dtype), doff, dw


dcn_backward_hopper.launches = {"float32": 0, "bfloat16": 0}


class _DeformConv2d(torch.autograd.Function):
    """The JAX package's ``_dcn_pallas`` custom VJP: forward kernel,
    backward kernel (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, offset, weight, halo, compute_dtype):
        ctx.save_for_backward(x, offset, weight)
        ctx.halo, ctx.compute_dtype = halo, compute_dtype
        if all(t.device.type == "cpu" for t in (x, offset, weight)):
            return deform_conv2d(x, offset, weight, padding=1,
                                 max_displacement=halo,
                                 compute_dtype=compute_dtype)
        return _forward_kernel(x, offset, weight, halo, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, offset, weight = ctx.saved_tensors
        dx, doff, dw = dcn_backward_hopper(x, offset, weight, g.contiguous(),
                                           ctx.halo, ctx.compute_dtype)
        return (dx, doff.to(offset.dtype), dw.to(weight.dtype), None, None)


def deform_conv2d_hopper(x: torch.Tensor, offset: torch.Tensor,
                         weight: torch.Tensor, halo: int,
                         compute_dtype=None) -> torch.Tensor:
    """3x3 stride-1 pad-1 deformable conv with samples clamped to +-halo,
    differentiable.

    x [B, H, W, Cin] and offset [B, H, W, 18] ([dy, dx] per tap),
    contiguous; weight [3, 3, Cin, Cout]; each float32 or bfloat16.
    ``compute_dtype`` (default ``x.dtype``) picks the kernel; returns
    [B, H, W, Cout] in ``x.dtype``.  Each forward kernel launch adds one to
    ``deform_conv2d_hopper.launches[name]``: "float32", "bfloat16" (bf16
    output) or "bfloat16_f32" (bf16 compute, f32 output: an f32 model's
    bf16 route); the backward counts in ``dcn_backward_hopper.launches``."""
    return _DeformConv2d.apply(x, offset, weight, int(halo),
                               compute_dtype or x.dtype)


deform_conv2d_hopper.launches = {"float32": 0, "bfloat16": 0,
                                 "bfloat16_f32": 0}
