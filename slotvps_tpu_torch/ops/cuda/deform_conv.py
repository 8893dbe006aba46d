"""Hopper DCN kernels: library, wrappers and the autograd Function.

``csrc/deform_conv.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``: nvcc for ``sm_90a`` at first use, ctypes).  It has
four entry points, two per compute dtype, each with the gather on producer
warps and the products on wgmma with f32 accumulation:
``dcn_forward_f32`` (each f32 product as three TF32 products of split
operands, the split-TF32 product; launch geometry
:func:`f32_forward_geometry`), ``dcn_forward_bf16`` (the bf16 Pallas
kernel's rounding points, an f32 or a bf16 output;
:func:`bf16_forward_geometry`), and the backward ``dcn_backward_f32`` /
``dcn_backward_bf16`` (dx, doff and dW, each summed in a fixed order: the
same on every run; data and dW passes on wgmma, split-TF32 in f32; launch
geometry :func:`f32_backward_geometry` / :func:`bf16_backward_geometry`).

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
import functools
import math
from typing import NamedTuple

import torch

from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.deform_conv import (deform_conv2d,
                                               deform_conv2d_backward)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dcn_forward_f32.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.dcn_forward_bf16.argtypes = [p] * 5 + [i] * 10 + [p]
    lib.dcn_backward_f32.argtypes = [p] * 11 + [i] * 10 + [p]
    lib.dcn_backward_bf16.argtypes = [p] * 10 + [i] * 10 + [p]
    for fn in (lib.dcn_forward_f32, lib.dcn_forward_bf16,
               lib.dcn_backward_f32, lib.dcn_backward_bf16):
        fn.restype = i
    smem = (lib.dcn_forward_f32_smem, lib.dcn_forward_bf16_smem,
            lib.dcn_bwd_dw_f32_smem, lib.dcn_bwd_dw_bf16_smem,
            lib.dcn_bwd_data_f32_smem, lib.dcn_bwd_data_bf16_smem)
    for fn in smem[:4]:
        fn.argtypes = [i]
    for fn in smem[4:]:
        fn.argtypes = [i, i]
    for fn in smem:
        fn.restype = i
    lib.dcn_error_string.argtypes = [i]
    lib.dcn_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("deform_conv", _declare)

_KEY = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# the forward's pixel tiles (rows, columns), largest first: at most 64
# pixels, the wgmma tile's rows (FM of csrc/deform_conv.cu)
_FWD_TILES = ((4, 16), (4, 8), (2, 8))
_FWD_CHUNK = 64               # bf16 input channels per chunk (FK)
_F32_CHUNK = 32               # f32 channels per chunk, a 128-byte row (TK)


class FwdGeometry(NamedTuple):
    """Launch geometry of ``dcn_forward_bf16`` / ``dcn_forward_f32`` for
    one image."""
    tile_h: int
    tile_w: int
    n_tile: int        # output channels per block: 64, 128 or 256
    n_ctiles: int      # output-channel tiles: ceil(Cout / n_tile)
    blocks: int        # blocks per image
    chunk: int = _FWD_CHUNK   # input channels per weight-image chunk
    parts: int = 1     # parts of a chunk: 2 in f32 (TF32 hi and lo)

    def wimg_elems(self, c_in: int) -> int:
        """Elements (of the compute dtype) of the kernel's weight image."""
        return (self.n_ctiles * 9 * -(-c_in // self.chunk) * self.parts
                * self.n_tile * self.chunk)


def _forward_geometry(h, w, c_out, n_sm, **image):
    def make(th, tw, nt):
        nct = -(-c_out // nt)
        return FwdGeometry(th, tw, nt, nct,
                           -(-h // th) * -(-w // tw) * nct, **image)

    n_tile = wgmma_width(min(c_out, 256))
    for th, tw in _FWD_TILES:
        geo = make(th, tw, n_tile)
        if geo.blocks >= n_sm:
            return geo
    while geo.blocks < n_sm and geo.n_tile > 64:
        geo = make(geo.tile_h, geo.tile_w, geo.n_tile // 2)
    return geo


def bf16_forward_geometry(h: int, w: int, c_out: int,
                          n_sm: int) -> FwdGeometry:
    """The bf16 forward's tile for an H x W image with Cout outputs on a
    card of ``n_sm`` SMs: all of Cout (up to 256) per block, so each sample
    is gathered once, and the largest pixel tile that still puts ``n_sm``
    blocks on the card; where even the smallest tile does not, Cout is
    split in halves (each split gathers the samples once more) until it
    does or the tile has 64 channels.  A function of the image's shape and
    the card, never of the batch, so an image's output is the same alone
    and in a batch."""
    return _forward_geometry(h, w, c_out, n_sm)


def f32_forward_geometry(h: int, w: int, c_out: int,
                         n_sm: int) -> FwdGeometry:
    """The f32 forward's tile: :func:`bf16_forward_geometry`'s rule (a
    function of H, W, Cout and the card, never of B), with 32-channel
    weight chunks in two parts."""
    return _forward_geometry(h, w, c_out, n_sm, chunk=_F32_CHUNK, parts=2)


# The bf16 backward (csrc/deform_conv.cu, "bf16 backward on wgmma"): the dW
# pass's pixel tile (BW_TH x BW_TW) and ring depth, the data pass's ring
# depth and dsample-tile pad; the least pixels a dW split sums; the shared
# memory a block may use on the card.
BWD_DW_TILE = (4, 16)
_BWD_DW_STAGES, _BWD_DATA_STAGES, _BWD_DATA_PAD = 4, 3, 8
_BWD_MIN_SPLIT = 128
MAX_SMEM = 232448
# The f32 kernels ("f32 on wgmma"): rows of the forward's A tile (TA_FWD)
# and of the dW pass's sample tile (TA_DW), pixels of a dW run (TW_RUN).
_F32_A_ROW, _F32_DW_ROW, F32_DW_RUN = 36, 72, 32


def wgmma_width(c: int) -> int:
    """The wgmma width (64, 128 or 256) that holds ``c`` <= 256 channels."""
    return 64 if c <= 64 else 128 if c <= 128 else 256


def _f32_stages(n: int) -> int:
    """Ring depth of the f32 dW pass at ``n`` output channels a block
    (tf_stages): 3 at 256, else 4."""
    return 3 if n > 128 else 4


def fwd_f32_smem(nc: int) -> int:
    """Dynamic shared memory of the f32 forward at ``nc`` output channels a
    block (``fwd_f32_smem_bytes``): alignment slack, the ring of weight
    (hi, lo) and A stages (2 at 256 channels, else 4), the consumers'
    per-tap sums, the barriers, the tile's offsets."""
    s = 2 if nc > 128 else 4
    return (1024 + s * (2 * nc * 128 + 4 * 64 * _F32_A_ROW) + 4 * 64 * nc
            + 2 * s * 8 + 4 * 64 * 18)


def bwd_data_f32_smem(nci: int, c_out: int) -> int:
    """... of the f32 data pass (``bwd_data_f32_smem_bytes``): g's tile in
    32-channel boxes, the W^T ring (2 stages at 256 input channels, else
    3), the tile's offsets, the barriers."""
    s = 2 if nci > 128 else 3
    return (1024 + -(-c_out // _F32_CHUNK) * 64 * 128 + s * 2 * nci * 128
            + 4 * 64 * 18 + (1 + s + 9) * 8)


def bwd_dw_f32_smem(nc: int) -> int:
    """... of the f32 dW pass (``bwd_dw_f32_smem_bytes``): the ring of g^T
    (hi, lo) and sample stages, its barriers."""
    s = _f32_stages(nc)
    return (1024 + s * (2 * nc * 128 + 4 * F32_DW_RUN * _F32_DW_ROW)
            + 2 * s * 8)


def bwd_dw_smem(nc: int) -> int:
    """Dynamic shared memory of the bf16 dW pass at ``nc`` output channels
    a block (``bwd_dw_smem_bytes`` of the source): the 1024-byte alignment
    slack, the ring of sample and g stages, its barriers."""
    return 1024 + _BWD_DW_STAGES * (_FWD_CHUNK + nc) * 128 \
        + 2 * _BWD_DW_STAGES * 8


def bwd_data_smem(nci: int, c_out: int) -> int:
    """... and of the bf16 data pass at ``nci`` input channels a block
    (``bwd_data_smem_bytes``): the g tile, the W^T ring, two dsample tiles,
    the tile's offsets, the barriers."""
    n_kb = -(-c_out // 64)
    return (1024 + n_kb * 64 * 128 + _BWD_DATA_STAGES * nci * 128
            + 2 * 2 * 64 * (nci + _BWD_DATA_PAD) + 4 * 64 * 18
            + (1 + _BWD_DATA_STAGES + 4) * 8)


@functools.lru_cache(maxsize=None)
def dw_splits(n_pix: int, c_in: int, n_sm: int) -> int:
    """Pixel ranges (split K) of the bf16 dW pass: the count S whose grid of
    9 * ceil(Cin / 64) row tiles x S fills the card's ``n_sm`` SMs in the
    fewest waves for the work (ceil(rows * S / n_sm) / S least; the smallest
    such S), each range at least _BWD_MIN_SPLIT pixels.  A function of the
    pixel count, Cin and the card only, so dW's order of sums is too.  No S
    beats n_sm / gcd(rows, n_sm), whose waves are all full."""
    rows = 9 * -(-c_in // 64)
    best = 1
    s_max = min(max(1, n_pix // _BWD_MIN_SPLIT), n_sm // math.gcd(rows, n_sm))
    for s in range(2, s_max + 1):
        # ceil(rows*s/n_sm)/s < ceil(rows*best/n_sm)/best, exactly
        if -(-rows * s // n_sm) * best < -(-rows * best // n_sm) * s:
            best = s
    return best


class BwdGeometry(NamedTuple):
    """Launch geometry of ``dcn_backward_bf16`` / ``dcn_backward_f32`` for
    a batch."""
    tile_h: int        # the data pass's pixel tile (<= 64 pixels)
    tile_w: int
    nci: int           # data pass: input channels a block (all of Cin)
    nc: int            # dW pass: output channels a block (all of Cout)
    row_tiles: int     # dW pass: 9 taps x ceil(Cin / 64) channel chunks
    dw_tiles: int      # dW pass: its K tiles over the batch, 4 x 16 pixel
                       # tiles in bf16, runs of 32 pixels of an image in f32
    splits: int        # dW pass: pixel ranges, each whole dW tiles
    data_blocks: int
    dtype: str = "bfloat16"

    @property
    def dw_blocks(self) -> int:
        return self.row_tiles * self.splits

    def split_ranges(self) -> list:
        """The dW tiles [lo, hi) that split s sums (the kernel's rule)."""
        t, n = self.dw_tiles, self.splits
        return [(s * t // n, (s + 1) * t // n) for s in range(n)]

    def part_elems(self, c_in: int, c_out: int) -> int:
        """f32 elements of the dW partials."""
        return self.splits * 9 * c_in * c_out

    def wimg_elems(self, c_out: int) -> int:
        """Elements (of the compute dtype) of the data pass's W^T image:
        64-channel chunks of Cout in bf16, 32-channel chunks in two parts
        in f32."""
        if self.dtype == "float32":
            return 9 * -(-c_out // _F32_CHUNK) * 2 * self.nci * _F32_CHUNK
        return 9 * -(-c_out // 64) * self.nci * 64

    def gt_elems(self, b: int, h: int, w: int, c_out: int) -> int:
        """f32 elements of g^T's two parts (the f32 dW pass's B operand):
        [2, B, Cout, H*W rounded up to 4]."""
        return 2 * b * c_out * -(-h * w // 4) * 4

    def smem(self, c_out: int) -> dict:
        """Dynamic shared memory of each wgmma pass."""
        if self.dtype == "float32":
            return {"data": bwd_data_f32_smem(self.nci, c_out),
                    "dw": bwd_dw_f32_smem(self.nc)}
        return {"data": bwd_data_smem(self.nci, c_out),
                "dw": bwd_dw_smem(self.nc)}


def _backward_geometry(b, h, w, c_in, c_out, n_sm, dtype, dw_tiles):
    if not (1 <= c_in <= 256 and 1 <= c_out <= 256):
        raise ValueError(f"the {dtype} backward takes 1 <= Cin, Cout <= "
                         f"256; got Cin={c_in}, Cout={c_out}")
    for th, tw in _FWD_TILES:
        blocks = b * -(-h // th) * -(-w // tw)
        if blocks >= n_sm:
            break
    return BwdGeometry(th, tw, wgmma_width(c_in), wgmma_width(c_out),
                       9 * -(-c_in // 64), dw_tiles,
                       dw_splits(b * h * w, c_in, n_sm), blocks, dtype)


def bf16_backward_geometry(b: int, h: int, w: int, c_in: int, c_out: int,
                           n_sm: int) -> BwdGeometry:
    """The bf16 backward's geometry on a card of ``n_sm`` SMs.  Data pass:
    all of Cin a block and the largest of the forward's pixel tiles that
    puts ``n_sm`` blocks on the card (a pixel's dsample, corner sums and
    doff do not depend on the tile).  dW pass: all of Cout a block, so each
    sample is gathered once; 4 x 16 pixel tiles; :func:`dw_splits` ranges.
    Cin and Cout up to 256 (one wgmma width)."""
    th, tw = BWD_DW_TILE
    return _backward_geometry(b, h, w, c_in, c_out, n_sm, "bfloat16",
                              b * -(-h // th) * -(-w // tw))


def f32_backward_geometry(b: int, h: int, w: int, c_in: int, c_out: int,
                          n_sm: int) -> BwdGeometry:
    """The f32 backward's geometry: :func:`bf16_backward_geometry`'s rule,
    with the dW pass's K tiles runs of 32 pixels of an image (a 128-byte
    row of g^T: TF32 reads both operands K-major, K = pixels)."""
    return _backward_geometry(b, h, w, c_in, c_out, n_sm, "float32",
                              b * -(-h * w // F32_DW_RUN))


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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if compute_dtype == torch.float32:
        out = torch.empty((b, h, w, c_out), dtype=torch.float32, device=dev)
        geo = f32_forward_geometry(h, w, c_out, n_sm)
        wimg = torch.empty((geo.wimg_elems(c_in),), dtype=torch.float32,
                           device=dev)
        with torch.cuda.device(dev):
            rc = lib.dcn_forward_f32(
                xc.data_ptr(), off.data_ptr(), wc.data_ptr(),
                wimg.data_ptr(), out.data_ptr(), b, h, w, c_in, c_out,
                int(halo), geo.tile_h, geo.tile_w, geo.n_tile, stream)
        entry = "dcn_forward_f32"
    else:
        out_dtype = (torch.float32 if x.dtype == torch.float32
                     else torch.bfloat16)
        out = torch.empty((b, h, w, c_out), dtype=out_dtype, device=dev)
        geo = bf16_forward_geometry(h, w, c_out, n_sm)
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


def dcn_backward_hopper(x: torch.Tensor, offset: torch.Tensor,
                        weight: torch.Tensor, g: torch.Tensor, halo: int,
                        compute_dtype=torch.float32):
    """Backward of the 3x3 stride-1 pad-1 deformable conv with samples
    clamped to +-halo, from the output gradient ``g`` [B, H, W, Cout].

    Returns (dx [B, H, W, Cin] in ``x.dtype``, doff [B, H, W, 18] f32,
    dW [3, 3, Cin, Cout] f32), computed in ``compute_dtype`` at the Pallas
    backward kernel's rounding points, each the same on every run.  On the
    card it takes Cin, Cout <= 256 and scratch buffers: dsample, [B*H*W, 9,
    Cin] in ``compute_dtype`` (0.74 GB in bf16 at 2 x 200 x 400 pixels and
    Cin 256), the dW partials, the W^T image, and in f32 g^T's two TF32
    parts; g is copied with rows 16 bytes apart where Cout does not give
    that (the TMA unit's rule).  Each kernel launch (one call: the data,
    dx, weight and reduction passes) adds one to
    ``dcn_backward_hopper.launches[dtype name]``."""
    if all(t.device.type == "cpu" for t in (x, offset, weight, g)):
        return deform_conv2d_backward(x, offset, weight, g, halo,
                                      compute_dtype)
    b, h, w, c_in, c_out = _check("dcn_backward_hopper", x, offset, weight,
                                  halo, compute_dtype, g)
    dev = x.device
    xc = x.to(compute_dtype).contiguous()
    wc = weight.to(compute_dtype).contiguous()
    off = offset.float().contiguous()
    dx = torch.empty((b, h, w, c_in), dtype=torch.float32, device=dev)
    doff = torch.empty((b, h, w, 18), dtype=torch.float32, device=dev)
    ds = torch.empty((b * h * w * 9 * c_in,), dtype=compute_dtype, device=dev)
    dw = torch.empty((3, 3, c_in, c_out), dtype=torch.float32, device=dev)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = (f32_backward_geometry if compute_dtype == torch.float32
           else bf16_backward_geometry)(b, h, w, c_in, c_out, n_sm)
    # g's rows a multiple of 16 bytes apart (the TMA unit's rule)
    per16 = 16 // ds.element_size()
    g_stride = -(-c_out // per16) * per16
    if g_stride == c_out:
        gc = g.to(compute_dtype).contiguous()
    else:
        gc = torch.zeros((b, h, w, g_stride), dtype=compute_dtype,
                         device=dev)
        gc[..., :c_out] = g
    wimg = torch.empty((geo.wimg_elems(c_out),), dtype=compute_dtype,
                       device=dev)
    part = torch.empty((geo.part_elems(c_in, c_out),), dtype=torch.float32,
                       device=dev)
    if compute_dtype == torch.float32:
        gt = torch.empty((geo.gt_elems(b, h, w, c_out),),
                         dtype=torch.float32, device=dev)
        entry = "dcn_backward_f32"
        with torch.cuda.device(dev):
            rc = lib.dcn_backward_f32(
                xc.data_ptr(), off.data_ptr(), wc.data_ptr(), gc.data_ptr(),
                wimg.data_ptr(), gt.data_ptr(), dx.data_ptr(),
                doff.data_ptr(), ds.data_ptr(), part.data_ptr(),
                dw.data_ptr(), b, h, w, c_in, c_out, g_stride, int(halo),
                geo.tile_h, geo.tile_w, geo.splits, stream)
    else:
        entry = "dcn_backward_bf16"
        with torch.cuda.device(dev):
            rc = lib.dcn_backward_bf16(
                xc.data_ptr(), off.data_ptr(), wc.data_ptr(), gc.data_ptr(),
                wimg.data_ptr(), dx.data_ptr(), doff.data_ptr(),
                ds.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, w, c_in,
                c_out, g_stride, int(halo), geo.tile_h, geo.tile_w,
                geo.splits, stream)
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
