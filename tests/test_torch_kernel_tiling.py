"""The launch geometry of the port's wgmma kernels, and the arithmetic of
slot attention's P.V, on the CPU.

* ``bf16_forward_geometry`` (``ops/cuda/deform_conv.py``): the bf16 DCN
  forward's pixel tile and output-channel tile.  At the 12 (level, tower
  block) shapes of a 1024x2048 frame it puts at least one block on each of
  the H100's 132 SMs; it keeps all of Cout in one block (each sample
  gathered once) except at the 32x64 level, whose 2,048 pixels need Cout
  split in two to fill the card.
* ``bf16_backward_geometry`` (``ops/cuda/deform_conv.py``): the bf16 DCN
  backward's data-pass tile and dW-pass split K.  At the 12 shapes of the
  800x1600 training crop both passes fill the card; the dW splits are a
  function of B*H*W, Cin and the SM count only, each a run of whole 4 x 16
  pixel tiles; the partials and the W^T image follow the geometry; both
  passes fit in a block's shared memory for Cin and Cout in {20, 24, 128,
  256}.
* ``f32_forward_geometry`` and ``f32_backward_geometry``: the split-TF32
  f32 kernels' tiles.  The forward keeps the bf16 forward's rule (a
  function of H, W, Cout and the card, never of B) with its 32-channel
  weight chunks in two parts; the backward's data pass and splits follow
  the bf16 backward's, its dW pass's K tiles are runs of 32 pixels of an
  image.  At the 12 frame shapes the forward puts >= 132 blocks on the
  card, at the 12 training shapes the data and dW passes fill it, split
  ranges are whole runs, and every f32 kernel fits in a block's shared
  memory for Cin and Cout in {20, 24, 128, 256}; Cin or Cout > 256 is
  refused.
* ``sa_grid`` (``ops/cuda/slot_attention.py``): the number of pixel runs G
  is a function of P and the card, not of B.
* The kernel's p.v splits the f32 softmax p into three bf16 parts
  (``csrc/slot_attention.cu``): the parts sum back to p exactly for p in
  [2**-100, 1], and a torch emulation of the kernel's arithmetic (bf16
  parts, f32 sums) is within chip_smoke's SA_RTOL (1e-4 of max|ref|) of the
  float64 reference and of the JAX package's Pallas kernel (interpret
  mode) on the same numpy inputs, at L = 100 and P = 2048.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu_torch.ops.cuda.deform_conv import (
    BWD_DW_TILE, F32_DW_RUN, MAX_SMEM, FwdGeometry, bf16_backward_geometry,
    bf16_forward_geometry, bwd_data_f32_smem, bwd_data_smem,
    bwd_dw_f32_smem, bwd_dw_smem, dw_splits, f32_backward_geometry,
    f32_forward_geometry, fwd_f32_smem)
from slotvps_tpu_torch.ops.cuda.slot_attention import TILE_PIXELS, sa_grid

SMS = 132
SA_RTOL = 1e-4
# (H, W) of the FPN levels P2..P5 of a 1024x2048 frame and of the 800x1600
# training crop; (Cin, Cout) of the semantic tower's three blocks
FRAME_LEVELS = ((256, 512), (128, 256), (64, 128), (32, 64))
TRAIN_LEVELS = ((200, 400), (100, 200), (50, 100), (25, 50))
BLOCKS = ((256, 256), (256, 128), (128, 128))
FRAME_SHAPES = [(h, w, ci, co) for h, w in FRAME_LEVELS for ci, co in BLOCKS]


@pytest.mark.parametrize("h,w,c_in,c_out", FRAME_SHAPES)
def test_dcn_tile_fills_the_card_at_every_frame_shape(h, w, c_in, c_out):
    geo = bf16_forward_geometry(h, w, c_out, SMS)
    assert geo.blocks >= SMS
    assert geo.blocks == (-(-h // geo.tile_h) * -(-w // geo.tile_w)
                          * geo.n_ctiles)
    assert geo.tile_h * geo.tile_w <= 64 and geo.n_tile in (64, 128, 256)
    assert geo.n_tile * geo.n_ctiles >= c_out
    # each sample gathered once, except at the 32x64 level (two halves)
    assert geo.n_ctiles == (2 if (h, w) == (32, 64) else 1)


@pytest.mark.parametrize("h,w", TRAIN_LEVELS)
def test_dcn_tile_at_the_training_levels(h, w):
    for _, c_out in BLOCKS:
        geo = bf16_forward_geometry(h, w, c_out, SMS)
        assert geo.blocks >= SMS
        assert geo.n_ctiles == (2 if (h, w) == (25, 50) else 1)


@pytest.mark.parametrize("h,w,c_in,c_out", [(13, 70, 20, 20), (5, 7, 8, 6),
                                            (9, 40, 20, 20), (3, 3, 300, 300)])
def test_dcn_geometry_of_ragged_shapes(h, w, c_in, c_out):
    """Small or ragged shapes: the smallest tile, Cout in 64-wide tiles
    (past 256 too), and a weight image of whole 64-channel chunks."""
    geo = bf16_forward_geometry(h, w, c_out, SMS)
    assert (geo.tile_h, geo.tile_w, geo.n_tile) == (2, 8, 64)
    assert geo.n_ctiles == -(-c_out // 64)
    assert geo.wimg_elems(c_in) == (geo.n_ctiles * 9 * -(-c_in // 64)
                                    * 64 * 64)


def test_dcn_geometry_takes_the_largest_tile_that_fills_the_card():
    assert bf16_forward_geometry(256, 512, 256, SMS) == FwdGeometry(
        4, 16, 256, 1, 2048)
    assert bf16_forward_geometry(64, 128, 256, SMS) == FwdGeometry(
        4, 8, 256, 1, 256)
    # a card with fewer SMs keeps the larger tile at 64x128
    assert bf16_forward_geometry(64, 128, 256, 100).tile_w == 16


TRAIN_SHAPES = [(h, w, ci, co) for h, w in TRAIN_LEVELS
                for ci, co in BLOCKS]


@pytest.mark.parametrize("h,w,c_in,c_out", TRAIN_SHAPES)
def test_dcn_backward_fills_the_card_at_every_training_shape(h, w, c_in,
                                                             c_out):
    """The bf16 backward at B = 2 (reference + current frame): the data
    pass puts a block on every SM, all of Cin a block; the dW pass keeps
    all of Cout in a block (each sample gathered once), and its grid of
    row tiles x splits fills whole waves of the card: every SM in each
    wave but, at the 25x50 level's 128 -> 128 block, 126 of the 132 in its
    one wave (a second wave of smaller splits would take longer)."""
    geo = bf16_backward_geometry(2, h, w, c_in, c_out, SMS)
    assert geo.data_blocks >= SMS
    assert geo.data_blocks == 2 * -(-h // geo.tile_h) * -(-w // geo.tile_w)
    assert geo.tile_h * geo.tile_w <= 64 and geo.nci >= c_in
    assert geo.nc >= c_out and geo.nc in (64, 128, 256)
    waves = -(-geo.dw_blocks // SMS)
    fill = geo.dw_blocks / (waves * SMS)
    assert fill == 1.0 or (fill > 0.95 and waves == 1), (geo, fill)
    assert fill == 1.0 or (h, w, c_in) == (25, 50, 128)


@pytest.mark.parametrize("shapes", [
    [(2, 200, 400), (1, 400, 400), (4, 100, 400), (8, 100, 200)],
    [(2, 25, 50), (1, 50, 50), (2, 50, 25)],
    [(1, 9, 40), (2, 9, 20), (1, 18, 20)],
])
def test_dcn_backward_splits_depend_on_the_pixel_count_only(shapes):
    """dW's pixel ranges (and so its order of sums) follow B*H*W, Cin and
    the card, not the batch, the image's height and width, or Cout."""
    for c_in in (20, 128, 256):
        splits = {bf16_backward_geometry(b, h, w, c_in, c_out, SMS).splits
                  for b, h, w in shapes for c_out in (24, 128, 256)}
        assert len(splits) == 1
        b, h, w = shapes[0]
        assert splits == {dw_splits(b * h * w, c_in, SMS)}


@pytest.mark.parametrize("b,h,w,c_in,c_out", [
    (2, 200, 400, 256, 256), (2, 25, 50, 128, 128), (2, 13, 70, 256, 256),
    (1, 9, 40, 20, 24), (1, 5, 7, 8, 4)])
def test_dcn_backward_split_ranges_are_whole_tiles(b, h, w, c_in, c_out):
    """The splits cover the batch's 4 x 16 tiles in order, each split a
    non-empty run of whole tiles, the splits at least 128 pixels apart (one
    split below that); the partials hold one 9*Cin x Cout block per split."""
    geo = bf16_backward_geometry(b, h, w, c_in, c_out, SMS)
    th, tw = BWD_DW_TILE
    assert geo.dw_tiles == b * -(-h // th) * -(-w // tw)
    ranges = geo.split_ranges()
    assert len(ranges) == geo.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == geo.dw_tiles
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    assert geo.splits == 1 or b * h * w >= 128 * geo.splits
    assert geo.part_elems(c_in, c_out) == geo.splits * 9 * c_in * c_out
    assert geo.wimg_elems(c_out) == 9 * -(-c_out // 64) * geo.nci * 64


@pytest.mark.parametrize("c_in", [20, 24, 128, 256])
@pytest.mark.parametrize("c_out", [20, 24, 128, 256])
def test_dcn_backward_shared_memory_fits(c_in, c_out):
    """Both wgmma passes fit in a block's 232,448 bytes (the data pass: g
    tile, a 3-stage W^T ring, two dsample tiles; the dW pass: a 4-stage
    ring of sample and g stages), and the sizes follow the widths."""
    geo = bf16_backward_geometry(2, 25, 50, c_in, c_out, SMS)
    smem = geo.smem(c_out)
    assert smem["data"] <= MAX_SMEM and smem["dw"] <= MAX_SMEM
    assert smem == {"data": bwd_data_smem(geo.nci, c_out),
                    "dw": bwd_dw_smem(geo.nc)}
    assert bwd_dw_smem(256) == 1024 + 4 * (8192 + 32768) + 64
    assert bwd_data_smem(256, 256) == (1024 + 4 * 8192 + 3 * 32768
                                       + 2 * 64 * 264 * 2 + 64 * 18 * 4
                                       + 8 * 8)


def test_dcn_backward_geometry_refuses_wide_channels():
    for c_in, c_out in ((257, 64), (64, 300), (0, 8)):
        with pytest.raises(ValueError, match="Cin, Cout <= 256"):
            bf16_backward_geometry(1, 8, 8, c_in, c_out, SMS)


@pytest.mark.parametrize("h,w,c_in,c_out", FRAME_SHAPES)
def test_f32_forward_fills_the_card_at_every_frame_shape(h, w, c_in, c_out):
    """The f32 forward's tile is the bf16 forward's (>= 132 blocks, all of
    Cout a block but at the 32x64 level), its weight image 32-channel
    chunks in two parts, its shared memory within a block's."""
    geo = f32_forward_geometry(h, w, c_out, SMS)
    assert geo[:5] == bf16_forward_geometry(h, w, c_out, SMS)[:5]
    assert geo.blocks >= SMS and (geo.chunk, geo.parts) == (32, 2)
    assert geo.n_ctiles == (2 if (h, w) == (32, 64) else 1)
    assert geo.wimg_elems(c_in) == (geo.n_ctiles * 9 * -(-c_in // 32) * 2
                                    * geo.n_tile * 32)
    assert fwd_f32_smem(geo.n_tile) <= MAX_SMEM


def test_f32_forward_shared_memory():
    """2 ring stages of 2 x 32 KB of weights and a 9,216-byte A tile at
    256 output channels a block, 4 below, then the consumers' per-tap sums
    (64 x Cout f32), the barriers and the tile's offsets."""
    assert fwd_f32_smem(256) == (1024 + 2 * (65536 + 9216) + 65536 + 32
                                 + 4608)
    assert fwd_f32_smem(128) == (1024 + 4 * (32768 + 9216) + 32768 + 64
                                 + 4608)
    assert fwd_f32_smem(64) == (1024 + 4 * (16384 + 9216) + 16384 + 64
                                + 4608)
    assert max(fwd_f32_smem(n) for n in (64, 128, 256)) <= MAX_SMEM


@pytest.mark.parametrize("h,w,c_in,c_out", TRAIN_SHAPES)
def test_f32_backward_fills_the_card_at_every_training_shape(h, w, c_in,
                                                            c_out):
    """The f32 backward at B = 2: the data pass puts a block on every SM
    with all of Cin a block; the dW pass keeps all of Cout a block and
    fills whole waves (the bf16 splits: P5 128 -> 128 one wave of 126)."""
    geo = f32_backward_geometry(2, h, w, c_in, c_out, SMS)
    assert geo.dtype == "float32"
    assert geo.data_blocks >= SMS and geo.nci >= c_in and geo.nc >= c_out
    assert geo.dw_tiles == 2 * -(-h * w // F32_DW_RUN)
    waves = -(-geo.dw_blocks // SMS)
    fill = geo.dw_blocks / (waves * SMS)
    assert fill == 1.0 or (fill > 0.95 and waves == 1), (geo, fill)
    bf = bf16_backward_geometry(2, h, w, c_in, c_out, SMS)
    assert (geo.tile_h, geo.tile_w, geo.splits) == (bf.tile_h, bf.tile_w,
                                                    bf.splits)


@pytest.mark.parametrize("b,h,w,c_in,c_out", [
    (2, 200, 400, 256, 256), (2, 25, 50, 128, 128), (2, 13, 70, 256, 256),
    (1, 9, 40, 20, 24), (1, 5, 7, 8, 4), (2, 6, 9, 24, 20)])
def test_f32_backward_split_ranges_are_whole_runs(b, h, w, c_in, c_out):
    """The splits cover the batch's runs of 32 pixels in order, each split
    a non-empty range of whole runs; the scratch sizes follow: the W^T
    image (32-channel chunks of Cout, two parts), g^T's two parts with H*W
    rounded up to 4 (16-byte rows for the TMA unit), the partials."""
    geo = f32_backward_geometry(b, h, w, c_in, c_out, SMS)
    ranges = geo.split_ranges()
    assert len(ranges) == geo.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == geo.dw_tiles
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    assert geo.wimg_elems(c_out) == 9 * -(-c_out // 32) * 2 * geo.nci * 32
    assert geo.gt_elems(b, h, w, c_out) == 2 * b * c_out * -(-h * w // 4) * 4
    assert geo.part_elems(c_in, c_out) == geo.splits * 9 * c_in * c_out


@pytest.mark.parametrize("shapes", [
    [(2, 200, 400), (1, 400, 400), (4, 100, 400)],
    [(2, 25, 50), (1, 50, 50), (2, 50, 25)],
])
def test_f32_backward_tiles_do_not_depend_on_the_batch(shapes):
    """The dW splits (and so dW's order of sums) follow B*H*W, Cin and the
    card; a dW run is 32 pixels of one image whatever B."""
    for c_in in (20, 128, 256):
        geos = [f32_backward_geometry(b, h, w, c_in, c_out, SMS)
                for b, h, w in shapes for c_out in (24, 128, 256)]
        assert len({g.splits for g in geos}) == 1
        for (b, h, w), g in zip([s for s in shapes for _ in range(3)], geos):
            assert g.dw_tiles == b * -(-h * w // F32_DW_RUN)


@pytest.mark.parametrize("c_in", [20, 24, 128, 256])
@pytest.mark.parametrize("c_out", [20, 24, 128, 256])
def test_f32_backward_shared_memory_fits(c_in, c_out):
    """The data pass (g's tile in 32-channel boxes, 2 W^T stages of 2 x 32
    KB at 256 input channels, else 3) and the dW pass (3 stages of 2 x 32
    KB of g^T and a 9,216-byte sample tile at 256 output channels, else 4)
    fit in a block's 232,448 bytes."""
    geo = f32_backward_geometry(2, 25, 50, c_in, c_out, SMS)
    smem = geo.smem(c_out)
    assert smem == {"data": bwd_data_f32_smem(geo.nci, c_out),
                    "dw": bwd_dw_f32_smem(geo.nc)}
    assert smem["data"] <= MAX_SMEM and smem["dw"] <= MAX_SMEM
    assert bwd_data_f32_smem(256, 256) == (1024 + 8 * 8192 + 2 * 65536
                                           + 4608 + 12 * 8)
    assert bwd_dw_f32_smem(256) == 1024 + 3 * (65536 + 9216) + 48


def test_f32_backward_geometry_refuses_wide_channels():
    for c_in, c_out in ((257, 64), (64, 300), (0, 8)):
        with pytest.raises(ValueError, match="Cin, Cout <= 256"):
            f32_backward_geometry(1, 8, 8, c_in, c_out, SMS)


@pytest.mark.parametrize("n_pix", [1, 33, 2048, 4133, 8192, 32768, 131072])
def test_sa_runs_do_not_depend_on_the_batch(n_pix):
    n_tiles = -(-n_pix // TILE_PIXELS)
    grids = [sa_grid(b, n_pix, SMS) for b in (1, 2, 3)]
    assert [gr[2] for gr in grids] == [1, 2, 3]
    assert len({gr[:2] for gr in grids}) == 1
    n_runs = grids[0][0]
    assert 1 <= n_runs <= n_tiles and 2 * n_runs <= SMS
    assert n_runs == min(n_tiles, SMS // 2)


def _split3(p):
    """The kernel's parts of an f32 p: hi = bf16(p), mid = bf16(p - hi),
    lo = bf16(p - hi - mid), each residual taken in f32."""
    hi = p.to(torch.bfloat16)
    r1 = p - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_three_bf16_parts_sum_back_to_p():
    rng = np.random.default_rng(0)
    p = np.concatenate([
        rng.random(100_000), np.exp2(-rng.uniform(0, 100, 100_000)),
        [0.0, 1.0, 0.5, 1 - 2.0 ** -24, 2.0 ** -100, 0.999999, 1 / 3]])
    pt = torch.from_numpy(p).float()
    hi, mid, lo = _split3(pt)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, pt.double())
    # each part is the bf16 rounding of what is left
    assert torch.equal(hi, pt.to(torch.bfloat16))
    assert bool((mid.double().abs() <= hi.double().abs() * 2.0 ** -8).all())


def _emulated_kernel(q, k, v):
    """The kernel's arithmetic on [L, C] / [P, C] bf16: f32 scores, the f32
    softmax over slots with one reciprocal a pixel, and p.v as the three
    bf16 parts' exact products summed in f32."""
    s = q.float() @ k.float().T                         # [L, P]
    e = torch.exp(s - s.amax(dim=0, keepdim=True))
    p = e * (1.0 / e.sum(dim=0, keepdim=True))
    out = torch.zeros((q.shape[0], v.shape[1]), dtype=torch.float32)
    for part in _split3(p):
        out = out + part.float() @ v.float()
    return out


def test_split_p_v_matches_the_reference_and_the_pallas_kernel():
    from slotvps_tpu.ops.pallas.slot_attention import slot_attention_pallas

    rng = np.random.default_rng(1)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal(shape),
                                    jnp.bfloat16).astype(jnp.float32))
               for shape in ((100, 256), (2048, 256), (2048, 256)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = _emulated_kernel(tq, tk, tv)
    s = torch.from_numpy(q).double() @ torch.from_numpy(k).double().T
    ref = torch.softmax(s, dim=0) @ torch.from_numpy(v).double()
    scale = float(ref.abs().max())
    assert float((ours.double() - ref).abs().max()) <= SA_RTOL * scale
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.asarray(slot_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tile=256))
    assert float(np.abs(ours.numpy() - jax_out).max()) <= SA_RTOL * scale
