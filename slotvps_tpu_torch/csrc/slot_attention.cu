// Slot-softmax cross-attention (the Retriever's core) for Hopper, bf16 in,
// f32 out.
//
// Replaces the TPU kernel slotvps_tpu/ops/pallas/slot_attention.py:_kernel
// (slot_attention_pallas, called by retriever_attention_pallas).  It
// computes what slotvps_tpu_torch/ops/slot_attention.py:slot_attention
// computes, for q [B, L, C] and k, v [B, P, C] bf16, L <= 128, C = 256:
//
//   out[b, l, :] = sum_p softmax over l (q[b, l] . k[b, p]) * v[b, p, :]
//
// The scores are f32 sums of the exact bf16 products; the softmax over the
// L slots is per pixel, in f32, with expf (no fast math); the
// probabilities stay f32 in the product with v; out is f32.  Each pixel's
// softmax is complete in itself, so pixels are tiled freely: no online
// rescaling.
//
// What bounds it on the card: one 1024x2048 frame runs it 14 times (7
// decoder stages x 2 frames) over P = 2048 .. 131072 pixels, 4*L*C*sum(P)
// = ~71 GFLOP and ~0.71 GB of k and v (0.21 ms of HBM).  Half the flops,
// q.k, take bf16 inputs with f32 sums: the tensor cores' type, 0.036 ms at
// 989 TFLOP/s.  The other half, p.v, keeps p in f32 (rounding p to bf16
// would change the function): 0.53 ms of f32 FMA at 67 TFLOP/s.  So the
// card's bound is ~0.57 ms, set by p.v.  This kernel runs q.k in f32 FMA
// as well, outside the tensor cores, which the bound does not grant it.
//
// Design (simple first).  Pass 1: grid (G, B), G <= the SM count; block g
// owns a contiguous run of T-pixel tiles and keeps q^T (bf16, padded to 128
// slots with zeros) in shared memory.  Per tile it stages k^T, computes the
// [128, T] scores (each thread a 4x4 register tile), takes the per-pixel
// softmax (one warp per pixel, shuffles), and accumulates P [128, T] x v
// [T, C] into registers: thread t holds slots 64*(t/128) .. +63 of the two
// channels 2*(t%128), 2*(t%128)+1.  It writes its [L, C] partial sum.
// Pass 2 sums the G partials of each (b, l, c) in order g = 0 .. G-1, so
// the result is the same from run to run (no f32 atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 128;        // slots, padded
constexpr int CH = 256;          // channels
constexpr int T = 32;            // pixels per tile
constexpr int NT = 256;          // threads per block
constexpr int KLD = T + 4;       // k^T row, bf16 (8-byte aligned rows)
constexpr int SLD = LMAX + 4;    // score / probability row, f32
constexpr size_t kQBytes = sizeof(__nv_bfloat16) * CH * LMAX;
constexpr size_t kKBytes = sizeof(__nv_bfloat16) * CH * KLD;
constexpr size_t kSBytes = sizeof(float) * T * SLD;
constexpr size_t kSmemBytes = kQBytes + kKBytes + kSBytes;

// Four bf16 values (8 bytes) widened to f32.
__device__ __forceinline__ void unpack4(uint2 u, float f[4]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

__global__ void __launch_bounds__(NT, 1)
slot_attn_partial_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         float* __restrict__ part, int L, int P,
                         int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qT = reinterpret_cast<__nv_bfloat16*>(smem);  // [CH][LMAX]
  __nv_bfloat16* kT =
      reinterpret_cast<__nv_bfloat16*>(smem + kQBytes);          // [CH][KLD]
  float* S = reinterpret_cast<float*>(smem + kQBytes + kKBytes);  // [T][SLD]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int b = blockIdx.y;
  const __nv_bfloat16* qb = q + (size_t)b * L * CH;
  const __nv_bfloat16* kb = k + (size_t)b * P * CH;
  const __nv_bfloat16* vb = v + (size_t)b * P * CH;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // q^T, slot fastest (conflict-free stores; q is small and L2-resident)
  for (int e = tid; e < CH * LMAX; e += NT) {
    const int l = e % LMAX;
    const int c = e / LMAX;
    qT[c * LMAX + l] = l < L ? qb[(size_t)l * CH + c] : zero;
  }

  const int lg = tid & 31;           // score tile: slots 4*lg .. 4*lg+3
  const int pg = tid >> 5;           //             pixels 4*pg .. 4*pg+3
  const int cp = tid & 127;          // P x v: channels 2*cp, 2*cp+1
  const int lh = tid >> 7;           //        slots 64*lh .. 64*lh+63
  float acc[64][2];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i][0] = acc[i][1] = 0.f;

  const long t_lo = (long)g * n_tiles / G;
  const long t_hi = (long)(g + 1) * n_tiles / G;
  for (long tile = t_lo; tile < t_hi; ++tile) {
    const int pix0 = (int)(tile * T);
    __syncthreads();   // q^T staged / previous tile consumed
    // k^T tile: pairs of channels of one pixel per thread (coalesced)
    for (int e = tid; e < T * (CH / 2); e += NT) {
      const int p = e / (CH / 2);
      const int c = 2 * (e % (CH / 2));
      __nv_bfloat162 kv = __halves2bfloat162(zero, zero);
      if (pix0 + p < P)
        kv = *reinterpret_cast<const __nv_bfloat162*>(
            kb + (size_t)(pix0 + p) * CH + c);
      kT[c * KLD + p] = kv.x;
      kT[(c + 1) * KLD + p] = kv.y;
    }
    __syncthreads();

    // scores S[p][l] = sum_c q[l][c] k[p][c], f32
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      float qf[4], kf[4];
      unpack4(*reinterpret_cast<const uint2*>(qT + c * LMAX + 4 * lg), qf);
      unpack4(*reinterpret_cast<const uint2*>(kT + c * KLD + 4 * pg), kf);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qf[i], kf[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) S[(4 * pg + j) * SLD + 4 * lg + i] = s[i][j];
    __syncthreads();

    // per-pixel softmax over the L slots: warp w takes pixels 4w .. 4w+3
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int p = 4 * warp + pp;
      float* row = S + p * SLD;
      float val[4];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int l = lane + 32 * u;
        val[u] = l < L ? row[l] : -INFINITY;
        mx = fmaxf(mx, val[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float z = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        val[u] = lane + 32 * u < L ? expf(val[u] - mx) : 0.f;
        z += val[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        z += __shfl_xor_sync(0xffffffffu, z, o);
      const bool live = pix0 + p < P;
#pragma unroll
      for (int u = 0; u < 4; ++u) row[lane + 32 * u] = live ? val[u] / z : 0.f;
    }
    __syncthreads();

    // acc[l][c] += P[l][p] * v[p][c] over the tile's live pixels
    const int n_live = min(T, P - pix0);
    for (int p = 0; p < n_live; ++p) {
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
          vb + (size_t)(pix0 + p) * CH + 2 * cp);
      const float v0 = __bfloat162float(v2.x);
      const float v1 = __bfloat162float(v2.y);
      const float* prow = S + p * SLD + 64 * lh;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 pr = *reinterpret_cast<const float4*>(prow + 4 * i);
        acc[4 * i + 0][0] = fmaf(pr.x, v0, acc[4 * i + 0][0]);
        acc[4 * i + 0][1] = fmaf(pr.x, v1, acc[4 * i + 0][1]);
        acc[4 * i + 1][0] = fmaf(pr.y, v0, acc[4 * i + 1][0]);
        acc[4 * i + 1][1] = fmaf(pr.y, v1, acc[4 * i + 1][1]);
        acc[4 * i + 2][0] = fmaf(pr.z, v0, acc[4 * i + 2][0]);
        acc[4 * i + 2][1] = fmaf(pr.z, v1, acc[4 * i + 2][1]);
        acc[4 * i + 3][0] = fmaf(pr.w, v0, acc[4 * i + 3][0]);
        acc[4 * i + 3][1] = fmaf(pr.w, v1, acc[4 * i + 3][1]);
      }
    }
  }

  // this block's partial sum part[b][g][l][c]
  float* pb = part + ((size_t)b * G + g) * L * CH;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int l = 64 * lh + i;
    if (l < L)
      *reinterpret_cast<float2*>(pb + (size_t)l * CH + 2 * cp) =
          make_float2(acc[i][0], acc[i][1]);
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

}  // namespace

// Pixels per tile of pass 1 (the wrapper sizes the partial-sum buffer).
extern "C" int sa_tile_pixels() { return T; }

// q [B, L, 256], k and v [B, P, 256] bf16; out [B, L, 256] f32; part
// [B, G, L, 256] f32 scratch, 1 <= G <= ceil(P / T).  Launches both passes
// on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int sa_forward_bf16(const void* q, const void* k, const void* v,
                               void* out, void* part, int B, int L, int P,
                               int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      slot_attn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (P + T - 1) / T;
  slot_attn_partial_kernel<<<dim3(G, B), NT, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(part), L, P,
      n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * CH;
  slot_attn_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), B, L, G);
  return (int)cudaGetLastError();
}

extern "C" const char* sa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
