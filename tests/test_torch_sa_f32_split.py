"""The arithmetic of the f32 slot-attention kernel's split-TF32 products, on
the CPU.

``csrc/slot_attention.cu`` (``slot_attn_f32_kernel<NQ>``) runs both
products of the f32 slot attention on the tensor cores as three TF32
products of split operands, a = hi + lo with hi = tf32(a) and
lo = tf32(a - hi) (``cvt.rna``: 10 mantissa bits, ties away from zero),
A.B = Ahi.Bhi + Ahi.Blo + Alo.Bhi:

* the scores S^T = k . q^T, q's slots padded to NQ = 64, 104 or 128, in
  k8 steps over the 256 channels, the accumulators restarted every 64
  channels and the four pieces summed in f32;
* the softmax over the L valid slots of each pixel in f32, as the two
  warpgroups take it: slots [0, N0) and [N0, NQ), each with its own max m_w
  and sum z_w, p = exp(s - m_w) * (exp(m_w - m) / z); p = 0 for pixels
  past P;
* out = v^T . p in k8 steps over the pixels of 64-pixel tiles, restarted
  every 4 tiles of a block's run (the runs of ``sa_f32_grid``); the pieces
  of a run summed in f32, then the runs' partials in order.

The tensor cores' own sums are modelled as one truncation toward zero to
f32 a k8 product (the eight exact products added to the accumulator), the
behaviour that made the f32 DCN kernels restart their sums
(``csrc/deform_conv.cu``).  The emulation is held within chip_smoke's
SA_F32_RTOL (1e-5 of max|ref|) of a float64 evaluation and of the plain
version at L = 100 with unit-normal inputs like chip_smoke's, and of the
JAX package's f32 ``slot_attention_pallas`` in interpret mode; one TF32
pass misses that tolerance, and so do sums without the restarts over a
long run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slotvps_tpu.ops.pallas.slot_attention import slot_attention_pallas
from slotvps_tpu_torch.ops.cuda.slot_attention import (TILE_PIXELS,
                                                       f32_slots, sa_f32_grid)
from slotvps_tpu_torch.ops.slot_attention import slot_attention
from tests.test_torch_dcn_f32_split import split

SA_F32_RTOL = 1e-5
C = 256
SMS = 132
SCORE_RESTART = 64     # channels between the scores' restarts
PV_RESTART = 4         # tiles between the p.v restarts


def trunc32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_step(acc, a_parts, b_parts, passes, product):
    """One k8 step of the split product: each of its ``passes`` wgmma adds
    eight exact products (``product(a, b)`` of two float64 parts) to the
    accumulator and truncates; ``acc`` is None at a restart."""
    ah, al = a_parts
    bh, bl = b_parts
    for a, b in ((ah, bh), (ah, bl), (al, bh), (al, bl))[:passes]:
        prod = product(a, b)
        acc = trunc32(prod) if acc is None else trunc32(acc.double() + prod)
    return acc


def emulated_kernel(q, k, v, passes=3, restarts=True, n_sm=SMS):
    """The f32 kernel's arithmetic on one image: q [L, C], k and v [P, C]
    f32 -> out [L, C] f32."""
    n_slots, n_pix = q.shape[0], k.shape[0]
    nq = f32_slots(n_slots)
    qp = torch.zeros((nq, C))
    qp[:n_slots] = q
    qh, ql = (t.double() for t in split(qp))
    kh, kl = (t.double() for t in split(k))
    # scores [P, NQ], k8 steps over the channels
    total, acc = None, None
    for st in range(C // 8):
        sl = slice(8 * st, 8 * st + 8)
        if restarts and st % (SCORE_RESTART // 8) == 0:
            acc = None
        acc = mma_step(acc, (kh, kl), (qh, ql), passes,
                       lambda a, b: a[:, sl] @ b[:, sl].T)
        if restarts and (st + 1) % (SCORE_RESTART // 8) == 0:
            total = acc if total is None else total + acc
    s = total if restarts else acc
    # the softmax as the two warpgroups take it: slots [0, n0) and [n0,
    # NQ), each with its own max m_w and sum z_w; p = exp(s - m_w) *
    # (exp(m_w - m) / z)
    valid = torch.arange(nq) < n_slots
    s = torch.where(valid, s, torch.tensor(-float("inf")))
    n0 = {64: 32, 104: 56, 128: 64}[nq]
    parts = []
    for sl in (slice(0, n0), slice(n0, nq)):
        m_w = s[:, sl].amax(dim=1, keepdim=True)
        e = torch.where(valid[sl], torch.exp(s[:, sl] - m_w), 0.0)
        parts.append((m_w, e, e.sum(dim=1, keepdim=True)))
    m = torch.maximum(parts[0][0], parts[1][0])
    z = parts[0][2] * torch.exp(parts[0][0] - m) + \
        parts[1][2] * torch.exp(parts[1][0] - m)
    p = torch.cat([e * (torch.exp(m_w - m) / z) for m_w, e, _ in parts], 1)
    # out^T [NQ, C] = p^T . v, restarted every PV_RESTART tiles of a run
    n_tiles = -(-n_pix // TILE_PIXELS)
    pad = n_tiles * TILE_PIXELS
    pp = torch.zeros((pad, nq))
    vp = torch.zeros((pad, C))
    pp[:n_pix], vp[:n_pix] = p, v
    ph, pl = (t.double().reshape(n_tiles, TILE_PIXELS, nq)
              for t in split(pp))
    vh, vl = (t.double().reshape(n_tiles, TILE_PIXELS, C)
              for t in split(vp))
    g_runs = sa_f32_grid(1, n_pix, n_sm)[0]
    out = torch.zeros((nq, C))
    for g in range(g_runs):
        run, acc = None, None
        t0, t1 = g * n_tiles // g_runs, (g + 1) * n_tiles // g_runs
        for t in range(t0, t1):
            if restarts and (t - t0) % PV_RESTART == 0:
                acc = None
            for st in range(TILE_PIXELS // 8):
                sl = slice(8 * st, 8 * st + 8)
                acc = mma_step(acc, (vh[t], vl[t]), (ph[t], pl[t]), passes,
                               lambda a, b: b[sl].T @ a[sl])
            if restarts and ((t - t0 + 1) % PV_RESTART == 0 or t + 1 == t1):
                run = acc if run is None else run + acc
        out = out + (run if restarts else acc)
    return out[:n_slots]


def _inputs(seed, n_slots, n_pix):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((n_slots, C), (n_pix, C), (n_pix, C))]


def _f64(q, k, v):
    s = torch.from_numpy(q).double() @ torch.from_numpy(k).double().T
    return torch.softmax(s, dim=0) @ torch.from_numpy(v).double()


@pytest.mark.parametrize("n_slots, n_pix", [(100, 8192), (100, 2048),
                                            (1, 300), (105, 777)])
def test_emulated_kernel_matches_float64_and_the_plain_version(n_slots,
                                                               n_pix):
    q, k, v = _inputs(n_slots + n_pix, n_slots, n_pix)
    ours = emulated_kernel(*(torch.from_numpy(a) for a in (q, k, v)))
    ref = _f64(q, k, v)
    scale = float(ref.abs().max())
    assert float((ours.double() - ref).abs().max()) <= SA_F32_RTOL * scale
    plain = slot_attention(*(torch.from_numpy(a)[None] for a in (q, k, v)))[0]
    assert float((ours - plain).abs().max()) <= SA_F32_RTOL * scale


def test_emulated_kernel_matches_the_pallas_kernel():
    q, k, v = _inputs(5, 100, 300)
    ours = emulated_kernel(*(torch.from_numpy(a) for a in (q, k, v)))
    with pltpu.force_tpu_interpret_mode():
        jax_out = np.asarray(slot_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tile=128))
    scale = float(np.abs(jax_out).max())
    assert float(np.abs(ours.numpy() - jax_out).max()) <= SA_F32_RTOL * scale


def test_one_tf32_pass_misses_the_tolerance():
    q, k, v = _inputs(6, 100, 2048)
    ours = emulated_kernel(*(torch.from_numpy(a) for a in (q, k, v)),
                           passes=1)
    ref = _f64(q, k, v)
    assert float((ours.double() - ref).abs().max()) > \
        SA_F32_RTOL * float(ref.abs().max())


def test_sums_without_restarts_miss_the_tolerance_over_a_long_run():
    """One block a run of 128 tiles (a card of 2 SMs): the truncating sums
    over 256 channels and 8192 pixels, never restarted, miss the tolerance
    that the restarted sums keep."""
    q, k, v = _inputs(7, 100, 8192)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    ref = _f64(q, k, v)
    tol = SA_F32_RTOL * float(ref.abs().max())
    kept = emulated_kernel(*args, n_sm=2)
    assert float((kept.double() - ref).abs().max()) <= tol
    never = emulated_kernel(*args, restarts=False, n_sm=2)
    assert float((never.double() - ref).abs().max()) > tol
