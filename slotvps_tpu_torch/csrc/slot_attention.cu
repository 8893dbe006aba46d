// Slot-softmax cross-attention (the Retriever's core) for Hopper, bf16 or
// f32 in, f32 out.
//
// Replaces the TPU kernel slotvps_tpu/ops/pallas/slot_attention.py:_kernel
// (slot_attention_pallas, called by retriever_attention_pallas).  It
// computes what slotvps_tpu_torch/ops/slot_attention.py:slot_attention
// computes, for q [B, L, C] and k, v [B, P, C], L <= 128, C = 256: bf16
// below (sa_forward_bf16), f32 further down (sa_forward_f32):
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
// f32: q, k and v f32, every product an exact f32 FMA on the CUDA cores.
//
// The same function in f32 (the JAX kernel's f32 instance): f32 scores, the
// per-pixel softmax over the valid slots, f32 sums of p.v, f32 out.  One
// 1024x2048 frame runs it 14 times, sum(P) = 692,224: k and v are 1.42 GB
// (0.42 ms of HBM) and 4*L*C*sum(P) = 70.9 GFLOP of FMA work (1.06 ms at
// 67 TFLOP/s), so operations bound it.
//
// Design: the bf16 kernel's structure, a grid of pixel runs (G, 1, B) from
// sa_f32_grid (G = one run an SM), pass 1 writing part[b][g][l][c] and
// slot_attn_reduce_kernel summing the G partials in order.  256 threads a
// block, one block an SM (shared memory), all 256 channels a block, so
// each score is computed once:
//   - q [NQ x 256] once a block, zeros past L;
//   - per 64-pixel tile, the k tile [64 x 256] by cp.async into the tile
//     buffer (zeros past P); each FMA step reads q and k as float4s over 4
//     channels (rows XOR-swizzled per 16 bytes, so that 8 neighbouring rows
//     sit in 8 bank groups);
//   - S [NQ x 64] in registers, thread (pg, sg) = (tid / 16, tid % 16)
//     holding slots sg + 16 i and pixels pg + 16 j;
//   - the v tile [64 x 256] into the same buffer once the scores are taken,
//     landing during the softmax;
//   - the softmax in registers: a pixel's NQ slots lie in 16 lanes of one
//     warp, so its max and sum are four shuffles each; p goes to its own
//     buffer as [pixel][slot];
//   - out^T [NQ x 256] in registers, thread (cg, sg) holding slots
//     4 sg + 64 a + {0..3} and channels 4 cg + 64 e + {0..3}: per pixel,
//     NQ / 64 float4s of p and four of v feed NQ / 2 FMAs.
// What bounds it (kernel_variants.py slot_attention_f32, H100, P = 131072,
// 0.53 ms): the FMA pipes of one block of 8 warps an SM; the scores and
// p.v take ~0.21 ms each, ~60 % of the FMA peak on 128 padded slots; the
// copies not hidden ~0.04 ms, expf ~0.03.  Shared memory:
// 4 * (NQ + 64 + NQ / 4) * 256 B, 224 KB at NQ = 128.
constexpr int F_THREADS = 256;

template <int NQ>
struct SaF32Smem {
  static constexpr int q_floats = NQ * CH;
  static constexpr int t_floats = TP * CH;     // the k tile, then the v tile
  static constexpr int p_floats = TP * NQ;
  static constexpr size_t bytes =
      4 * (size_t)(q_floats + t_floats + p_floats);
};

// float4 index of (row, 4 f) in a [rows][256] f32 tile, swizzled
__device__ __forceinline__ int swz4(int row, int f) {
  return row * (CH / 4) + (f ^ (row & 7));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [px0, px0 + 64) of a [P, 256] f32 tensor into a swizzled tile,
// zeros past P; one cp.async group
__device__ __forceinline__ void load_tile_f32(float4* dst, const float* src,
                                              int px0, int P, int tid) {
  for (int i = tid; i < TP * CH / 4; i += F_THREADS) {
    const int r = i / (CH / 4), f = i % (CH / 4);
    const bool in = px0 + r < P;
    cp_async16(&dst[swz4(r, f)], in ? src + (size_t)(px0 + r) * CH + 4 * f
                                     : src,
               in ? 16 : 0);
  }
  cp_async_commit();
}

template <int NQ>
__global__ void __launch_bounds__(F_THREADS, 1)
slot_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ part,
                     int L, int P, int n_tiles) {
  constexpr int NS = NQ / 16;   // slots a thread holds in S
  constexpr int NA = NQ / 64;   // groups of 4 slots a thread holds in out
  extern __shared__ float4 saf_raw[];
  float4* s_q = saf_raw;                             // [NQ][64] swizzled
  float4* s_t = s_q + SaF32Smem<NQ>::q_floats / 4;   // [TP][64] swizzled
  float* s_p = reinterpret_cast<float*>(s_t + SaF32Smem<NQ>::t_floats / 4);

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.z;
  const int t_lo = (int)((long)g * n_tiles / G);
  const int n_my = (int)((long)(g + 1) * n_tiles / G) - t_lo;
  const float* kb = k + (size_t)b * P * CH;
  const float* vb = v + (size_t)b * P * CH;

  {
    const float4* qb = reinterpret_cast<const float4*>(q + (size_t)b * L * CH);
    for (int i = tid; i < NQ * CH / 4; i += F_THREADS) {
      const int r = i / (CH / 4), f = i % (CH / 4);
      s_q[swz4(r, f)] = r < L ? qb[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (n_my > 0) load_tile_f32(s_t, kb, t_lo * TP, P, tid);

  const int sg = tid & 15;    // slot group (both products)
  const int pg = tid >> 4;    // pixel group (scores)
  const int cg = tid >> 4;    // channel group (p.v)
  float o[NA][4][16];         // out: [a][slot 0..3][channel 0..15]
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 16; ++c) o[a][s][c] = 0.f;

  for (int i = 0; i < n_my; ++i) {
    const int px0 = (t_lo + i) * TP;
    cp_async_wait_all();  // this thread's part of the k tile has landed
    __syncthreads();      // ... every thread's; q too on the first tile

    // 1. S[a][j] = q[sg + 16 a] . k[pg + 16 j], channels in order
    float S[NS][4];
#pragma unroll
    for (int a = 0; a < NS; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[a][j] = 0.f;
#pragma unroll 2
    for (int f = 0; f < CH / 4; ++f) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_t[swz4(pg + 16 * j, f)];
#pragma unroll
      for (int a = 0; a < NS; ++a) {
        const float4 qv = s_q[swz4(sg + 16 * a, f)];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          S[a][j] = fmaf(qv.x, kv[j].x, S[a][j]);
          S[a][j] = fmaf(qv.y, kv[j].y, S[a][j]);
          S[a][j] = fmaf(qv.z, kv[j].z, S[a][j]);
          S[a][j] = fmaf(qv.w, kv[j].w, S[a][j]);
        }
      }
    }
    __syncthreads();      // every thread is done with the k tile
    load_tile_f32(s_t, vb, px0, P, tid);   // v lands during the softmax

    // 2. the softmax over the valid slots of each pixel, p to shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int px = pg + 16 * j;
      float mx = -INFINITY;
#pragma unroll
      for (int a = 0; a < NS; ++a)
        if (sg + 16 * a < L) mx = fmaxf(mx, S[a][j]);
#pragma unroll
      for (int m = 1; m < 16; m <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, m));
      float z = 0.f;
#pragma unroll
      for (int a = 0; a < NS; ++a) {
        S[a][j] = sg + 16 * a < L ? expf(S[a][j] - mx) : 0.f;
        z += S[a][j];
      }
#pragma unroll
      for (int m = 1; m < 16; m <<= 1)
        z += __shfl_xor_sync(0xffffffffu, z, m);
      const float rz = px0 + px < P ? 1.f / z : 0.f;
#pragma unroll
      for (int a = 0; a < NS; ++a) s_p[px * NQ + sg + 16 * a] = S[a][j] * rz;
    }
    cp_async_wait_all();  // this thread's part of the v tile has landed
    __syncthreads();      // p and v are in place for every thread

    // 3. out^T[slots][channels] += p^T . v, pixels in order
    const float4* p4 = reinterpret_cast<const float4*>(s_p);
#pragma unroll 2
    for (int px = 0; px < TP; ++px) {
      float4 pv[NA], vv[4];
#pragma unroll
      for (int a = 0; a < NA; ++a) pv[a] = p4[px * (NQ / 4) + sg + 16 * a];
#pragma unroll
      for (int e = 0; e < 4; ++e) vv[e] = s_t[swz4(px, cg + 16 * e)];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float ps[4] = {pv[a].x, pv[a].y, pv[a].z, pv[a].w};
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[a][s][4 * e + 0] = fmaf(ps[s], vv[e].x, o[a][s][4 * e + 0]);
            o[a][s][4 * e + 1] = fmaf(ps[s], vv[e].y, o[a][s][4 * e + 1]);
            o[a][s][4 * e + 2] = fmaf(ps[s], vv[e].z, o[a][s][4 * e + 2]);
            o[a][s][4 * e + 3] = fmaf(ps[s], vv[e].w, o[a][s][4 * e + 3]);
          }
      }
    }
    __syncthreads();      // every thread is done with p and v
    if (i + 1 < n_my) load_tile_f32(s_t, kb, px0 + TP, P, tid);
  }

  // this block's partial sum part[b][g][l][c]
  float* pb = part + ((size_t)b * G + g) * L * CH;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int l = 4 * sg + 64 * a + s;
      if (l >= L) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(pb + (size_t)l * CH + 4 * cg + 64 * e) =
            make_float4(o[a][s][4 * e], o[a][s][4 * e + 1],
                        o[a][s][4 * e + 2], o[a][s][4 * e + 3]);
    }
}

template <int NQ>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* part, int B, int L, int P, int G,
                       cudaStream_t s) {
  const size_t smem = SaF32Smem<NQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      slot_attn_f32_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  slot_attn_f32_kernel<NQ><<<dim3(G, 1, B), F_THREADS, smem, s>>>(
      q, k, v, part, L, P, (P + TP - 1) / TP);
  return cudaGetLastError();
}

// A 3-D map of a [B, rows, 256] bf16 tensor; boxes of 64 channels x
// box_rows rows of one batch element, 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* base, int B, int rows,
              int box_rows) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)CH, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)CH * 2,
                                 (cuuint64_t)rows * CH * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
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

// Dynamic shared memory of the f32 pass 1 for L <= 64 (nq = 64) or L <= 128.
extern "C" int sa_f32_smem_bytes(int nq) {
  return nq == 64 ? (int)SaF32Smem<64>::bytes : (int)SaF32Smem<128>::bytes;
}

// sa_forward_bf16's contract with f32 q [B, L, 256], k and v [B, P, 256].
extern "C" int sa_forward_f32(const void* q, const void* k, const void* v,
                              void* out, void* part, int B, int L, int P,
                              int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (L < 1 || L > 128 || P < 1 || G < 1 || G > (P + TP - 1) / TP)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* pt = static_cast<float*>(part);
  cudaError_t err = L <= 64 ? launch_f32<64>(qf, kf, vf, pt, B, L, P, G, s)
                            : launch_f32<128>(qf, kf, vf, pt, B, L, P, G, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * CH;
  slot_attn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      pt, static_cast<float*>(out), B, L, G);
  return (int)cudaGetLastError();
}

extern "C" const char* sa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
