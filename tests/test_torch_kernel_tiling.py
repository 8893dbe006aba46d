"""The launch geometry of the port's wgmma kernels, and the arithmetic of
slot attention's P.V, on the CPU.

* ``bf16_forward_geometry`` (``ops/cuda/deform_conv.py``): the bf16 DCN
  forward's pixel tile and output-channel tile.  At the 12 (level, tower
  block) shapes of a 1024x2048 frame it puts at least one block on each of
  the H100's 132 SMs; it keeps all of Cout in one block (each sample
  gathered once) except at the 32x64 level, whose 2,048 pixels need Cout
  split in two to fill the card.
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

from slotvps_tpu_torch.ops.cuda.deform_conv import (Bf16Geometry,
                                                    bf16_forward_geometry)
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
    assert bf16_forward_geometry(256, 512, 256, SMS) == Bf16Geometry(
        4, 16, 256, 1, 2048)
    assert bf16_forward_geometry(64, 128, 256, SMS) == Bf16Geometry(
        4, 8, 256, 1, 256)
    # a card with fewer SMs keeps the larger tile at 64x128
    assert bf16_forward_geometry(64, 128, 256, 100).tile_w == 16


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
