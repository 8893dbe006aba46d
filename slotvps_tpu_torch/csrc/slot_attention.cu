// Slot-softmax cross-attention (the Retriever's core) for Hopper, bf16 or
// f32 in, f32 out.
//
// Replaces the TPU kernel slotvps_tpu/ops/pallas/slot_attention.py:_kernel
// (slot_attention_pallas, called by retriever_attention_pallas).  It
// computes what slotvps_tpu_torch/ops/slot_attention.py:slot_attention
// computes, for q [B, L, C] and k, v [B, P, C], L <= 128, C = 256: bf16
// below (sa_forward_bf16), f32 (split-TF32) further down (sa_forward_f32):
//
//   out[b, l, :] = sum_p softmax over l (q[b, l] . k[b, p]) * v[b, p, :]
//
// The scores are f32 sums of the exact bf16 products; the softmax over the
// L slots is per pixel, in f32, with expf (no fast math); the
// probabilities stay f32 in the product with v (below: as three exact bf16
// parts); out is f32.  Each pixel's softmax is complete in itself, so
// pixels are tiled freely: no online rescaling.
//
// What bounds it on the card: one 1024x2048 frame runs it 14 times (7
// decoder stages x 2 frames) over P = 2048 .. 131072 pixels, ~0.71 GB of k
// and v (0.21 ms of HBM).  q.k is 2*L*C*sum(P) = ~35 GFLOP of bf16 products
// with f32 sums, the tensor cores' type.  p.v keeps p in f32: here p is
// split exactly into three bf16 parts, hi = bf16(p), mid = bf16(p - hi),
// lo = bf16(p - hi - mid) (8 + 8 + 8 significant bits hold p's 24, so hi +
// mid + lo == p), and p.v is the three bf16 products hi.v + mid.v + lo.v,
// each exact, summed in f32 on the tensor cores: the same function up to
// the order of f32 sums, 3 x 35 GFLOP of tensor-core work.  So the bound is
// the larger of ~140 GFLOP at 989 TFLOP/s (~0.14 ms) and the HBM time of k
// and v (~0.21 ms): bytes.
//
// Design.  Pass 1: grid (G, 2, B); block (g, half, b) owns a contiguous
// run of 64-pixel tiles and output channels half*128 .. +127 (two blocks
// per run keep the P.V accumulators at 128 registers a thread; each
// recomputes the run's scores, which are cheap on the tensor cores).  One
// producer warp lands, by TMA (3-D tensor maps, 128-byte swizzle, zeros
// past P and L), q once ([NQ slots x 256] bf16, NQ = 64 or 128 >= L) and
// per tile the k tile [64 x 256] and the v tile [64 x 128] into two-stage
// rings with full / empty mbarriers; k's stage is freed as soon as the
// scores are taken, so the next k tile lands during the softmax and P.V.
// One consumer warpgroup per tile:
//   1. S^T [64 pixels x NQ slots] = k_tile . q^T on wgmma (m64nNQk16, 16
//      steps over the 256 channels, f32 accumulators in registers);
//   2. the softmax in registers: a pixel row's slots lie in one quad of
//      lanes (hopper.cuh's accumulator layout), so its max and sum are two
//      shuffles each; slots >= L are masked out, pixels >= P get p = 0;
//      p = exp * (1 / sum): one IEEE division a pixel (a division a slot
//      took two thirds of the kernel's time, measured on the H100);
//   3. p's three bf16 parts go to shared memory as [pixels][slots] tiles;
//   4. out^T's half [NQ slots x 128 channels] += P^T . v on wgmma, A = P^T
//      and B = v both read in the MN-major (transposed) layout: per 16
//      pixels the hi, mid and lo products in that order.
// What bounds it now (kernel_variants.py, H100, P = 131072, 0.21 ms): the
// consumer warpgroup's f32 work at one block per SM, expf first (~0.09
// ms); the P.V products take ~0.035 ms (the mid and lo parts ~0.02 of it)
// and q.k hides behind the rest.  The 128-slot instance keeps 255
// registers and spills ~100 bytes; rolling the P.V loop removes the spill
// for 3 % but has ptxas insert wgmma fences, so the loops stay unrolled.
// The block writes its [L, 128] partial sum.  Pass 2 sums the G partials
// of each (b, l, c) in order g = 0 .. G-1, so the result is the same from
// run to run (no f32 atomics); G depends on P and the SM count only, so an
// image gives the same bits alone and in a batch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CH = 256;          // channels
constexpr int TP = 64;           // pixels per tile (the wrapper's
                                 // TILE_PIXELS)
constexpr int CHH = 128;         // output channels per block
constexpr int SA_CONS = 128;     // the consumer warpgroup
constexpr int SA_THREADS = SA_CONS + 32;   // + one producer warp
constexpr int K_BYTES = TP * CH * 2;       // one k tile, 32 KB
constexpr int V_BYTES = TP * CHH * 2;      // one v tile, 16 KB

// shared memory: q, the k ring, the v ring, p's three parts, barriers
template <int NQ>
struct SaSmem {
  static constexpr int q_bytes = NQ * CH * 2;
  static constexpr int p_bytes = TP * NQ * 2;   // one part
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + 2 * K_BYTES;
  static constexpr int p_off = v_off + 2 * V_BYTES;
  static constexpr int bar_off = p_off + 3 * p_bytes;
  static constexpr size_t bytes = 1024 + bar_off + 9 * 8;
};

template <int NQ>
__global__ void __launch_bounds__(SA_THREADS, 1)
slot_attn_partial_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         float* __restrict__ part, int L, int P,
                         int n_tiles) {
  using namespace hopper;
  using Sm = SaSmem<NQ>;
  constexpr int MT = NQ / 64;   // slot blocks of P.V (m64 each)
  extern __shared__ unsigned char sa_raw[];
  unsigned char* sm =
      sa_raw + ((1024 - (smem_addr(sa_raw) & 1023)) & 1023);
  unsigned char* s_q = sm;                 // [4][NQ][128 B], K-major
  unsigned char* s_k = sm + Sm::k_off;     // [2][4][64][128 B], K-major
  unsigned char* s_v = sm + Sm::v_off;     // [2][2][64][128 B], MN-major
  unsigned char* s_p = sm + Sm::p_off;     // [3][NQ/64][64][128 B], MN-major
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Sm::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_full = bars + 5;
  uint64_t* v_empty = bars + 7;

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int half = blockIdx.y;
  const int b = blockIdx.z;
  const int t_lo = (int)((long)g * n_tiles / G);
  const int n_my = (int)((long)(g + 1) * n_tiles / G) - t_lo;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], SA_CONS);
      mbar_init(&v_empty[s], SA_CONS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= SA_CONS) {
    // ---- producer warp: one lane issues every copy
    if (tid == SA_CONS) {
      mbar_arrive_expect_tx(q_full, Sm::q_bytes);
      for (int kb = 0; kb < 4; ++kb)
        tma_load_3d(s_q + kb * NQ * 128, &qmap, 64 * kb, 0, b, q_full);
      for (int i = 0; i < n_my; ++i) {
        const int s = i & 1;
        const uint32_t ph = (i >> 1) & 1;
        const int px0 = (t_lo + i) * TP;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&k_full[s], K_BYTES);
        for (int kb = 0; kb < 4; ++kb)
          tma_load_3d(s_k + s * K_BYTES + kb * TP * 128, &kmap, 64 * kb, px0,
                      b, &k_full[s]);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&v_full[s], V_BYTES);
        for (int mb = 0; mb < 2; ++mb)
          tma_load_3d(s_v + s * V_BYTES + mb * TP * 128, &vmap,
                      CHH * half + 64 * mb, px0, b, &v_full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  float S[NQ / 2];           // S^T tile: pixel rows, slot columns
  float o[MT][CHH / 2];      // out^T half: slot rows, channel columns
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < CHH / 2; ++i) o[t][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_my; ++i) {
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const int px0 = (t_lo + i) * TP;

    // 1. scores on the tensor cores
    mbar_wait(&k_full[s], ph);
    const unsigned char* kt = s_k + s * K_BYTES;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < CH / 16; ++st) {
      const int kb = st >> 2;
      const int off = 32 * (st & 3);
      wgmma<NQ, 0, 0>(S, desc128(kt + kb * TP * 128 + off, 16, 1024),
                      desc128(s_q + kb * NQ * 128 + off, 16, 1024), st > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    mbar_arrive(&k_empty[s]);
    named_sync(1, SA_CONS);   // the previous tile's P.V is done everywhere

    // 2. per-pixel softmax over the L slots, 3. p's parts to shared memory
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      const bool live = px0 + row < P;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * q4 + e < L) mx = fmaxf(mx, S[4 * j + 2 * h + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * h + e;
          S[r] = 8 * j + 2 * q4 + e < L ? expf(S[r] - mx) : 0.f;
          z += S[r];
        }
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      const float rz = 1.f / z;   // one division a pixel, not one a slot
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        uint32_t w3[3];
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          pv[e] = live ? S[4 * j + 2 * h + e] * rz : 0.f;
        // hi, mid, lo: each residual is exact in f32
        const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[0], pv[1]);
        const float r0 = pv[0] - __low2float(hi);
        const float r1 = pv[1] - __high2float(hi);
        const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            r0 - __low2float(mid), r1 - __high2float(mid));
        w3[0] = *reinterpret_cast<const uint32_t*>(&hi);
        w3[1] = *reinterpret_cast<const uint32_t*>(&mid);
        w3[2] = *reinterpret_cast<const uint32_t*>(&lo);
        const int off = (j >> 3) * TP * 128 + row * 128 +
                        (((j & 7) ^ (row & 7)) << 4) + 4 * q4;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<uint32_t*>(s_p + c * Sm::p_bytes + off) = w3[c];
      }
    }
    fence_proxy_async();
    named_sync(1, SA_CONS);

    // 4. P^T . v on the tensor cores, hi, mid, lo per 16 pixels
    mbar_wait(&v_full[s], ph);
    const unsigned char* vt = s_v + s * V_BYTES;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < TP / 16; ++st) {
      const uint64_t db = desc128(vt + 2048 * st, TP * 128, 1024);
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          wgmma<CHH, 1, 1>(
              o[t],
              desc128(s_p + c * Sm::p_bytes + t * TP * 128 + 2048 * st,
                      TP * 128, 1024),
              db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&v_empty[s]);
  }
#pragma unroll
  for (int t = 0; t < MT; ++t) fence_regs(o[t]);

  // this block's partial sum part[b][g][l][half*128 + c]
  float* pb = part + ((size_t)b * G + g) * L * CH + CHH * half;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 64 * t + 16 * warp + (lane >> 2) + 8 * h;
      if (l >= L) continue;
#pragma unroll
      for (int j = 0; j < CHH / 8; ++j)
        *reinterpret_cast<float2*>(pb + (size_t)l * CH + 8 * j + 2 * q4) =
            make_float2(o[t][4 * j + 2 * h], o[t][4 * j + 2 * h + 1]);
    }
}

// out[b][l][c] = sum over g = 0 .. G-1, in that order, of part[b][g][l][c].
__global__ void slot_attn_reduce_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int B, int L,
                                        int G) {
  const size_t n = (size_t)B * L * CH;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const size_t b = e / ((size_t)L * CH);
  const size_t lc = e % ((size_t)L * CH);
  const float* pb = part + b * G * L * CH + lc;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += pb[(size_t)g * L * CH];
  out[e] = s;
}

// ---------------------------------------------------------------------------
// f32: q, k and v f32, both products split-TF32 on wgmma.
//
// The same function in f32 (the JAX kernel's f32 instance): f32 scores, the
// per-pixel softmax over the valid slots, f32 sums of p.v, f32 out.  One
// 1024x2048 frame runs it 14 times, sum(P) = 692,224: k and v are 1.42 GB
// (0.42 ms of HBM); the products are 4*L*C*sum(P) = 70.9 GFLOP, 1.06 ms on
// the f32 pipes (67 TFLOP/s) or, as three TF32 products each (below), 0.43
// ms on the tensor cores (494.7 TFLOP/s): bytes and tensor-core work bound
// it about equally.
//
// Arithmetic: deform_conv.cu's split-TF32 product (hopper.cuh mma3),
// a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and A.B = Ahi.Bhi +
// Ahi.Blo + Alo.Bhi with f32 sums.  The tensor cores' own f32 sums truncate,
// an error that grows with the number of sums and with the sum, so the
// scores restart their accumulators every 64 channels (F_FLUSH chunks) and
// add the four pieces in f32, and p.v restarts every F_PV_FLUSH tiles (256
// pixels) and adds each piece to f32 running sums.  A torch emulation of
// this arithmetic (tests/test_torch_sa_f32_split.py) puts the result ~3e-6
// of max|out| from the plain version at L = 100, P = 131072; without the
// p.v restarts ~1e-5, chip_smoke's tolerance.  TF32 wgmma reads both
// operands K-major, so:
//   - scores: S^T [64 pixels x N slots] = k_tile . q^T; A = the k tile, read
//     into registers and split there; B = q as stored, [slot][channel],
//     split once a call (sa_qsplit_kernel) into an image of 32-channel
//     chunks, hi and lo, 128-byte swizzled;
//   - out [channels x N slots] = v^T . p; A = v^T, read from the v tile into
//     registers and split there; B = p as the softmax writes it, [slot]
//     [pixel], hi and lo.
// N pads L to a multiple of 8: NQ = 64, 104 or 128 (L = 100 -> 104).
//
// Design.  q's two parts are NQ x 2 KB (208 KB at NQ = 104) and do not fit
// beside a k tile, a v tile and p, so q streams: each ring stage holds a
// 32-channel chunk of q's image (hi and lo, one bulk copy, from L2) and
// the k tile's same 32 channels (TMA, f32 3-D map, zeros past P).  Grid
// (G, 1, B) from sa_f32_grid: block (g, b) owns a run of 64-pixel tiles
// and all 256 output channels, so each score is computed once.  Two
// consumer warpgroups and no producer warps (a producer would cut each
// thread's registers to 168: warps are allocated in fours); thread 0
// issues every copy (full / empty mbarriers): a ring stage's next chunk
// once both warpgroups have released it, and the next tile's v tile (TMA,
// one stage) as soon as this tile's p.v is done, so it lands during the
// next tile's scores.  Per tile:
//   1. scores: warpgroup w takes slots [w*N0, ..) (N0 / N1 = 32 / 32, 56 /
//      48, 64 / 64): per chunk, 4 k8 steps of 3 wgmma m64nNwk8, A fragments
//      from the k chunk (the q image stores each 8-channel group in the
//      order 0 2 4 6 1 3 5 7, so a fragment's columns q and q+4 are
//      neighbouring channels: one 8-byte load); restarted every F_FLUSH
//      chunks, the pieces summed in registers;
//   2. the softmax in registers: a pixel's slots lie in one quad of lanes of
//      each warpgroup; each warpgroup takes its own row max m_w and sum of
//      exp z_w, the two trade them in shared memory once; slots >= L
//      masked, pixels >= P get p = 0, p = exp(s - m_w) * (exp(m_w - m) /
//      z): one IEEE division a pixel;
//   3. p's TF32 parts to shared memory, [slot][pixel], 128-byte swizzled;
//   4. out [128 channels x NQ] of warpgroup w (channels w*128 .., two m64
//      blocks) += v^T . p: 8 k8 steps of 3 wgmma m64nNQk8 a block, A
//      fragments from the v tile (rows r and r+8 of the product are
//      neighbouring channels: one 8-byte load), two steps' fragments
//      loaded and split while the last two steps' products run.
// The p.v accumulators restart every F_PV_FLUSH tiles: each piece goes to
// the block's partial sum part[b][g][l][c] in global memory (L2), stored
// by the first flush and added by the later ones with f32 atomic adds
// (two floats an atomic).
// Each address is written by one thread only, in program order, so the
// sums are the same from run to run; slot_attn_reduce_kernel then sums the
// G partials in order, as for bf16.  (A second set of accumulators for the
// running sums does not fit beside the scores: a tile's p.v accumulators
// take NQ registers a thread.)
// Registers: out's accumulators NQ a thread, the scores' pieces and sums
// NQ / 2, a chunk's fragments 32 (ptxas: 255 at NQ = 104 and 128, which
// spills 588 bytes; 223 at 64).
// What bounds it (kernel_variants.py slot_attention_f32, H100 at 700 W, P =
// 131072, L = 100, 0.257 ms against 0.085 of tensor-core work): the two
// warpgroups run in lockstep through the softmax exchange, so the products
// (scores ~0.05 ms, p.v ~0.06) do not overlap the CUDA-core work: the
// flush's atomics ~0.025, expf ~0.03, the k fragments' loads and splits
// ~0.02, p's stores ~0.015, the v splits ~0.015, q's copies ~0.013.
constexpr int F_CONS = 256;               // two warpgroups; thread 0 also
                                          // issues the copies
constexpr int F_KC = 32;                  // channels of a chunk (128 bytes)
constexpr int F_NCH = CH / F_KC;          // chunks a tile
constexpr int F_FLUSH = 2;                // chunks between score restarts
constexpr int F_PV_FLUSH = 4;             // tiles between p.v restarts

// the slots of warpgroup 0's scores, the ring's depth and the shared memory:
// the ring (q chunk hi, lo, then the k chunk), the v tile, p's hi and lo
// parts, the warpgroups' row max and row sum, barriers
template <int NQ>
struct SaF32 {
  static constexpr int n0 = NQ == 104 ? 56 : NQ / 2;
  static constexpr int n1 = NQ - n0;
  static constexpr int stages = NQ == 64 ? 4 : NQ == 104 ? 3 : 2;
  static constexpr int q_bytes = 2 * NQ * F_KC * 4;
  static constexpr int stage = q_bytes + TP * F_KC * 4;
  static constexpr int v_bytes = TP * CH * 4;
  static constexpr int p_part = TP * NQ * 4;   // [2 x 32 pixels][NQ][128 B]
  static constexpr int v_off = stages * stage;
  static constexpr int p_off = v_off + v_bytes;
  static constexpr int red_off = p_off + 2 * p_part;
  static constexpr int bar_off = red_off + 4 * TP * 4;
  static constexpr size_t bytes = 1024 + bar_off + (2 * stages + 2) * 8;
};

// q [B, L, 256] f32 -> the scores' B image [B][F_NCH][2][NQ][32] f32: for
// each image and 32-channel chunk, q's hi then lo part (hopper.cuh
// split_tf32) of rows n < NQ (zeros from L), each row 128-byte swizzled,
// each 8-channel group stored in the order 0 2 4 6 1 3 5 7.  One thread a
// 16-byte unit.
__global__ void sa_qsplit_kernel(const float* __restrict__ q,
                                 uint4* __restrict__ img, int L, int NQ,
                                 int n_units) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_units) return;
  const int n = (e >> 3) % NQ;
  int rest = (e >> 3) / NQ;
  const int part = rest & 1;
  rest >>= 1;
  const int c = rest % F_NCH;
  const int b = rest / F_NCH;
  const int unit = (e & 7) ^ (n & 7);   // the positions 4 unit .. +3 it holds
  uint32_t word[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = (4 * unit + t) & 7;
    const int ch = F_KC * c + ((4 * unit + t) & ~7) +
                   (i < 4 ? 2 * i : 2 * i - 7);
    const float v = n < L ? q[((size_t)b * L + n) * CH + ch] : 0.f;
    uint32_t hi, lo;
    hopper::split_tf32(v, hi, lo);
    word[t] = part ? lo : hi;
  }
  img[e] = make_uint4(word[0], word[1], word[2], word[3]);
}

// A consumer warpgroup (wg) of the f32 kernel: slots [n_off, n_off + NW) of
// the scores and channels wg*128 .. +127 of out, over the block's tiles
// t_lo .. t_lo + n_my - 1 (see the design note above).
template <int NQ, int NW>
__device__ __forceinline__ void sa_f32_consumer(
    unsigned char* sm, const CUtensorMap* kmap, const CUtensorMap* vmap,
    const float* __restrict__ qimg, float* __restrict__ part, int L, int P,
    int t_lo, int n_my, int b, int g, int G, int wg, int n_off) {
  using namespace hopper;
  using Sm = SaF32<NQ>;
  constexpr int S = Sm::stages;
  constexpr int MB = 2;        // m64 blocks of out: 128 channels
  constexpr int PVG = 2;       // p.v k8 steps a group
  const int tid = threadIdx.x;
  const int w4 = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int r0 = 16 * w4 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sm::bar_off);
  uint64_t* empty = full + S;
  uint64_t* v_full = full + 2 * S;
  uint64_t* v_empty = v_full + 1;
  float* red_mx = reinterpret_cast<float*>(sm + Sm::red_off);   // [2][TP]
  float* red_z = red_mx + 2 * TP;                                // [2][TP]
  unsigned char* s_p = sm + Sm::p_off;
  const float* vt = reinterpret_cast<const float*>(sm + Sm::v_off);
  // out's rows r0 and r0 + 8 of m64 block mb are channels cl + 64 mb and
  // cl + 64 mb + 1; their place in the v tile ([8][TP][32] f32, 128-byte
  // swizzled): column block (cl + 64 mb) / 32, unit v_unit
  const int cl = 128 * wg + 16 * w4 + 2 * (lane >> 2);
  const int v_base = (cl >> 5) * TP * 32 + (cl & 3);
  const int v_unit = (cl & 31) >> 2;
  float* pb = part + ((size_t)b * G + g) * L * CH + cl;
  // the copies, issued by thread 0: chunk u of the run (tile u / F_NCH) into
  // its ring stage, tile i's v into the v stage
  const bool issuer = tid == 0;
  const int n_chunks = n_my * F_NCH;
  auto issue_chunk = [&](int u) {
    const int s = u % S;
    const int c = u % F_NCH;
    mbar_arrive_expect_tx(&full[s], Sm::stage);
    bulk_load(sm + s * Sm::stage,
              qimg + ((size_t)b * F_NCH + c) * (Sm::q_bytes / 4), Sm::q_bytes,
              &full[s]);
    tma_load_3d(sm + s * Sm::stage + Sm::q_bytes, kmap, F_KC * c,
                (t_lo + u / F_NCH) * TP, b, &full[s]);
  };
  auto issue_v = [&](int i) {
    mbar_arrive_expect_tx(v_full, Sm::v_bytes);
    for (int cb = 0; cb < CH / F_KC; ++cb)
      tma_load_3d(sm + Sm::v_off + cb * TP * 128, vmap, F_KC * cb,
                  (t_lo + i) * TP, b, v_full);
  };
  if (issuer) {
    for (int u = 0; u < S && u < n_chunks; ++u) issue_chunk(u);
    issue_v(0);
  }

  float o[MB][NQ / 2];
  for (int i = 0; i < n_my; ++i) {
    const int px0 = (t_lo + i) * TP;

    // 1. S^T [64 pixels x NW slots], chunk by chunk
    float sc[NW / 2], s_sum[NW / 2];
#pragma unroll 1
    for (int c = 0; c < F_NCH; ++c) {
      const int u = i * F_NCH + c;
      const int s = u % S;
      mbar_wait(&full[s], (u / S) & 1);
      const unsigned char* stg = sm + s * Sm::stage;
      const float* kt = reinterpret_cast<const float*>(stg + Sm::q_bytes);
      uint32_t ah[F_KC / 8][4], al[F_KC / 8][4];
#pragma unroll
      for (int st = 0; st < F_KC / 8; ++st) {
        const int ch = 8 * st + 2 * q4;   // columns q4, q4 + 4 of the step
        float v[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          const float2 x = *reinterpret_cast<const float2*>(
              kt + row * 32 + ((((ch >> 2) ^ (row & 7)) << 2) | (ch & 3)));
          v[h] = x.x;
          v[2 + h] = x.y;
        }
        split_frag(v, ah[st], al[st]);
      }
      const unsigned char* qh = stg + n_off * 128;
      const unsigned char* ql = qh + NQ * 128;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < F_KC / 8; ++st)
        mma3<NW>(sc, ah[st], al[st], qh + 32 * st, ql + 32 * st,
                 c % F_FLUSH > 0 || st > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int st = 0; st < F_KC / 8; ++st) {
        fence_regs(ah[st]);
        fence_regs(al[st]);
      }
      mbar_arrive(&empty[s]);
      if (issuer && u + S < n_chunks) {   // the stage's next chunk
        mbar_wait(&empty[s], (u / S) & 1);
        issue_chunk(u + S);
      }
      if (c % F_FLUSH == F_FLUSH - 1) {   // a restart: the piece to the sum
        fence_regs(sc);
#pragma unroll
        for (int r = 0; r < NW / 2; ++r)
          s_sum[r] = c == F_FLUSH - 1 ? sc[r] : s_sum[r] + sc[r];
      }
    }

    // 2. the softmax over the L slots of each pixel row: each warpgroup's
    // own max and sum of exp, traded once; p = exp(s - m_w) * (exp(m_w -
    // m) / z) with m the row's max and z its sum (one IEEE division a row)
    float m_own[2];   // this warpgroup's row max, m_w
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (n_off + 8 * j + 2 * q4 + e < L)
            mx = fmaxf(mx, s_sum[4 * j + 2 * h + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * h + e;
          s_sum[r] =
              n_off + 8 * j + 2 * q4 + e < L ? expf(s_sum[r] - mx) : 0.f;
          z += s_sum[r];
        }
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      if (q4 == 0) {
        red_mx[wg * TP + row] = mx;
        red_z[wg * TP + row] = z;
      }
      m_own[h] = mx;
    }
    named_sync(1, F_CONS);

    // 3. p's TF32 parts: element (slot n, pixel row) of part c at c * p_part
    // + (row / 32) * NQ * 128 + n * 128 + the swizzled place of row % 32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      // warpgroup 0 holds slot 0, so m is finite; a warpgroup without a
      // valid slot has m_w = -inf and z_w = 0, and its p is 0
      const float m0 = red_mx[row], m1 = red_mx[TP + row];
      const float m = fmaxf(m0, m1);
      const float z =
          red_z[row] * expf(m0 - m) + red_z[TP + row] * expf(m1 - m);
      const float rz = px0 + row < P ? expf(m_own[h] - m) / z : 0.f;
      const int pr = row & 31;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_off + 8 * j + 2 * q4 + e;
          uint32_t hi, lo;
          split_tf32(s_sum[4 * j + 2 * h + e] * rz, hi, lo);
          const int off = (row >> 5) * NQ * 128 + n * 128 +
                          ((((pr >> 2) ^ (n & 7)) << 4) | ((pr & 3) << 2));
          *reinterpret_cast<uint32_t*>(s_p + off) = hi;
          *reinterpret_cast<uint32_t*>(s_p + Sm::p_part + off) = lo;
        }
    }
    fence_proxy_async();
    named_sync(1, F_CONS);

    // 4. out [128 channels x NQ] += v^T . p, PVG k8 steps a group: a
    // group's A fragments are loaded and split while the last group's
    // products run
    mbar_wait(v_full, i & 1);
    const bool restart = i % F_PV_FLUSH == 0;
    uint32_t vh[2][PVG][MB][4], vl[2][PVG][MB][4];
    auto v_frags = [&](int sg, int buf) {
#pragma unroll
      for (int k = 0; k < PVG; ++k)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          float v[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // pixel columns q4 and q4 + 4
            const int px = 8 * (sg + k) + q4 + 4 * h;
            const float2 x = *reinterpret_cast<const float2*>(
                vt + v_base + 2 * mb * TP * 32 + px * 32 +
                ((v_unit ^ (px & 7)) << 2));
            v[2 * h] = x.x;
            v[2 * h + 1] = x.y;
          }
          split_frag(v, vh[buf][k][mb], vl[buf][k][mb]);
        }
    };
    auto v_done = [&](int buf) {
#pragma unroll
      for (int k = 0; k < PVG; ++k)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          fence_regs(vh[buf][k][mb]);
          fence_regs(vl[buf][k][mb]);
        }
    };
#pragma unroll
    for (int gr = 0; gr < TP / 8 / PVG; ++gr) {
      const int buf = gr & 1;
      if (gr >= 2) {   // the group that used this buffer is done
        wgmma_wait<1>();
        v_done(buf);
      }
      v_frags(gr * PVG, buf);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < PVG; ++k) {
        const int st = gr * PVG + k;
        const unsigned char* ph =
            s_p + (st >> 2) * NQ * 128 + 32 * (st & 3);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          mma3<NQ>(o[mb], vh[buf][k][mb], vl[buf][k][mb], ph,
                   ph + Sm::p_part, !restart || st > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    v_done(0);
    v_done(1);
    mbar_arrive(v_empty);
    if (issuer && i + 1 < n_my) {   // the next tile's v
      mbar_wait(v_empty, i & 1);
      issue_v(i + 1);
    }

    // a flush: the piece to part[b][g][l][cl + 64 mb + {0, 1}], stored by
    // the first flush, added by the later ones (this thread's addresses
    // are its own)
    if ((i + 1) % F_PV_FLUSH == 0 || i + 1 == n_my) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(o[mb]);
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * j + 2 * q4 + e;
            if (n >= L) continue;
            float* dst = pb + (size_t)n * CH + 64 * mb;
            const float a = o[mb][4 * j + e], c = o[mb][4 * j + 2 + e];
            if (i < F_PV_FLUSH)
              *reinterpret_cast<float2*>(dst) = make_float2(a, c);
            else
              atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, c));
          }
      }
    }
  }
}

template <int NQ>
__global__ void __launch_bounds__(F_CONS, 1)
slot_attn_f32_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const float* __restrict__ qimg,
                     float* __restrict__ part, int L, int P, int n_tiles) {
  using namespace hopper;
  using Sm = SaF32<NQ>;
  constexpr int S = Sm::stages;
  extern __shared__ unsigned char saf_raw[];
  unsigned char* sm =
      saf_raw + ((1024 - (smem_addr(saf_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Sm::bar_off);
  uint64_t* empty = full + S;
  uint64_t* v_full = full + 2 * S;
  uint64_t* v_empty = v_full + 1;

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.z;
  const int t_lo = (int)((long)g * n_tiles / G);
  const int n_my = (int)((long)(g + 1) * n_tiles / G) - t_lo;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_CONS);
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, F_CONS);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128)
    sa_f32_consumer<NQ, Sm::n0>(sm, &kmap, &vmap, qimg, part, L, P, t_lo,
                                n_my, b, g, G, 0, 0);
  else
    sa_f32_consumer<NQ, Sm::n1>(sm, &kmap, &vmap, qimg, part, L, P, t_lo,
                                n_my, b, g, G, 1, Sm::n0);
}

// the padded slot count of the f32 kernel's instance for L slots
inline int f32_slots(int L) { return L <= 64 ? 64 : L <= 104 ? 104 : 128; }

template <int NQ>
cudaError_t launch_f32(const float* q, const CUtensorMap& km,
                       const CUtensorMap& vm, float* part, float* qimg,
                       int B, int L, int P, int G, cudaStream_t s) {
  const int n_units = B * F_NCH * 2 * NQ * 8;
  sa_qsplit_kernel<<<(n_units + 255) / 256, 256, 0, s>>>(
      q, reinterpret_cast<uint4*>(qimg), L, NQ, n_units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = SaF32<NQ>::bytes;
  err = cudaFuncSetAttribute(slot_attn_f32_kernel<NQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  slot_attn_f32_kernel<NQ><<<dim3(G, 1, B), F_CONS, smem, s>>>(
      km, vm, qimg, part, L, P, (P + TP - 1) / TP);
  return cudaGetLastError();
}

// A 3-D map of a [B, rows, 256] bf16 or f32 tensor; boxes of 128 bytes of
// channels (64 bf16 or 32 f32) x box_rows rows of one batch element,
// 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* base, int B, int rows,
              int box_rows, bool f32 = false) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const int esz = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)CH, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)CH * esz,
                                 (cuuint64_t)rows * CH * esz};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esz), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NQ>
cudaError_t launch_partial(const CUtensorMap& qm, const CUtensorMap& km,
                           const CUtensorMap& vm, float* part, int B, int L,
                           int P, int G, cudaStream_t s) {
  const size_t smem = SaSmem<NQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      slot_attn_partial_kernel<NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  slot_attn_partial_kernel<NQ><<<dim3(G, 2, B), SA_THREADS, smem, s>>>(
      qm, km, vm, part, L, P, (P + TP - 1) / TP);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of pass 1 for L <= 64 (nq = 64) or L <= 128.
extern "C" int sa_smem_bytes(int nq) {
  return nq == 64 ? (int)SaSmem<64>::bytes : (int)SaSmem<128>::bytes;
}

// q [B, L, 256], k and v [B, P, 256] bf16, 16-byte aligned; out [B, L, 256]
// f32; part [B, G, L, 256] f32 scratch, 1 <= G <= ceil(P / 64).  Launches
// both passes on `stream`; returns cudaGetLastError() as an int (0 =
// launched; cudaErrorInvalidValue for a shape it does not take or a tensor
// map the driver refuses).
extern "C" int sa_forward_bf16(const void* q, const void* k, const void* v,
                               void* out, void* part, int B, int L, int P,
                               int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L < 1 || L > 128 || P < 1 || G < 1 || G > (P + TP - 1) / TP)
    return (int)cudaErrorInvalidValue;
  const int nq = L <= 64 ? 64 : 128;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, L, nq) || !make_map(&km, k, B, P, TP) ||
      !make_map(&vm, v, B, P, TP))
    return (int)cudaErrorInvalidValue;
  float* pt = static_cast<float*>(part);
  cudaError_t err = nq == 64 ? launch_partial<64>(qm, km, vm, pt, B, L, P, G, s)
                             : launch_partial<128>(qm, km, vm, pt, B, L, P, G,
                                                   s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * CH;
  slot_attn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, L, G);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the f32 pass 1 at nq = 64, 104 or 128 padded
// slots (L <= 64, <= 104, <= 128).
extern "C" int sa_f32_smem_bytes(int nq) {
  return nq == 64    ? (int)SaF32<64>::bytes
         : nq == 104 ? (int)SaF32<104>::bytes
                     : (int)SaF32<128>::bytes;
}

// sa_forward_bf16's contract with f32 q [B, L, 256], k and v [B, P, 256];
// part holds the partials [B, G, L, 256] f32 and after them q's split image
// [B, 8, 2, NQ, 32] f32 (NQ = 64, 104 or 128 as L <= 64, 104, 128).
extern "C" int sa_forward_f32(const void* q, const void* k, const void* v,
                              void* out, void* part, int B, int L, int P,
                              int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L < 1 || L > 128 || P < 1 || G < 1 || G > (P + TP - 1) / TP)
    return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  if (!make_map(&km, k, B, P, TP, true) || !make_map(&vm, v, B, P, TP, true))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* pt = static_cast<float*>(part);
  float* qimg = pt + (size_t)B * G * L * CH;
  const int nq = f32_slots(L);
  cudaError_t err =
      nq == 64    ? launch_f32<64>(qf, km, vm, pt, qimg, B, L, P, G, s)
      : nq == 104 ? launch_f32<104>(qf, km, vm, pt, qimg, B, L, P, G, s)
                  : launch_f32<128>(qf, km, vm, pt, qimg, B, L, P, G, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * CH;
  slot_attn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      pt, static_cast<float*>(out), B, L, G);
  return (int)cudaGetLastError();
}

extern "C" const char* sa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
