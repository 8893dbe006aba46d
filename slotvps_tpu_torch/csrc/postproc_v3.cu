// Fused panoptic post-processing for Hopper: theta, claim, argmax, repair
// and the semantic argmax (sseg).
//
// Replaces the TPU kernels of slotvps_tpu/ops/pallas/postproc_v3.py:
// theta_v3, claim_v3, argmax_v3 (per_tile=True), repair_v3 and sseg_v3.
// Each kernel
// computes exactly what its plain version in
// slotvps_tpu_torch/ops/postproc_v3.py computes.  Masks are slot-major at
// low resolution, m [K, h, w] f32; every full-resolution map is row-major
// [H, W] = [4h, 4w].  The [K, H, W] upsampled stack never exists: each
// kernel rebuilds the upsampled values it needs from the low-res rows.
//
// Bit-exact upsample.  The claim and argmax decisions compare upsampled
// values with theta and with each other, so a kernel's upsampled value must
// equal the plain version's bit for bit.  The plain version (torch, ops/
// interpolate.py) computes each phase as two separately rounded products
// and one rounded sum, rows first, then columns, with replicated edges.
// lerp_phase() below does the same with __fmul_rn/__fadd_rn, which the
// compiler never contracts into an FMA.  expf/logf are the accurate
// libdevice functions (no --use_fast_math).
//
// Row tiles: hb = gcd(8, h) low-res rows (4*hb full-res rows), T = h/hb,
// as in the JAX kernels; per-tile areas are [T, K] int32.
//
// What bounds them on the card (H100 SXM published peaks at 700 W: 3.35 TB/s
// of HBM, 67 TFLOP/s of f32 outside the tensor cores), at K = 64,
// h x w = 256 x 512 (a 1024x2048 frame); chip_smoke.py computes each bound
// from its run's data:
//   theta  reads the masks once (K*h*w*4 B = 33.6 MB) and writes theta
//          (8.4 MB): ~13 us of bytes at 3.35 TB/s.  Its arithmetic is
//          ~2M pixels x K slots x (3 flops + 1 expf) and is the larger
//          bound; staging the row-interpolated values of K slots in shared
//          memory leaves 3 flops per (pixel, slot) for the column phase.
//   claim  is sequential over the valid thing slots: slot i's keep decision
//          needs whole-map counts taken after every earlier claim.  One
//          launch per slot applies the previous slot's claim and counts
//          (block reductions, one atomic per block, the last block decides
//          via an atomic ticket); the int8 owner map (2 MB) and theta
//          (8.4 MB) stay in the 50 MB L2 across launches.  No host sync
//          inside the loop.  Bound: one pass over theta and owner per slot
//          from device memory, ~3.7 us per slot; in practice the launch
//          gaps dominate.  A cooperative persistent kernel with
//          grid.sync() between slots would remove the gaps, but it ties the
//          grid to the blocks that fit on the card at once and needs the
//          cooperative launch API; the plain launches were chosen as the
//          simple first version (their measured cost is in PERF.md).
//   argmax reads the masks and the owner map, writes m_id (8.4 MB) and
//          per-tile areas; arithmetic as theta without the expf.  Areas use
//          a shared-memory histogram with warp-aggregated atomics
//          (__match_any_sync), since large regions give long runs of one id.
//   repair is argmax on the dirty tiles only; clean tiles copy m1 and their
//          area row through (typically 1-2 of 32 tiles are dirty, so the
//          copy, 16.8 MB of traffic, is most of its time).  Launched over
//          all tiles with an early copy-and-return on clean ones: no
//          compacted tile list, no extra host sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SW = 32;          // low-res columns per block strip
constexpr int FW = 4 * SW;      // full-res columns per block strip
constexpr int NT = 4 * FW;      // threads: 4 row phases x FW columns
constexpr int SC = SW + 2;      // staged low-res columns, with both halos
constexpr int CT = 256;         // claim kernel threads per block
constexpr float NEG = -1e30f;

// Phase p of the x4 bilinear upsample mixes (prev, cent, next) samples as
// torch's _upsample_int_axis does, with off = (2p-3)/8: off < 0 ->
// (-off)*prev + (1+off)*cent, off > 0 -> (1-off)*cent + off*next.  Both
// are wx*x + wc*cent with x = prev (p < 2) or next (p >= 2); IEEE addition
// commutes, so one form serves all four phases.
__device__ __forceinline__ float mix(float wx, float x, float wc, float cent) {
  return __fadd_rn(__fmul_rn(wx, x), __fmul_rn(wc, cent));
}

__device__ __forceinline__ float phase_wx(int p) {
  return (p == 0 || p == 3) ? 0.375f : 0.125f;
}

__device__ __forceinline__ float phase_wc(int p) {
  return (p == 0 || p == 3) ? 0.625f : 0.875f;
}

__device__ __forceinline__ float lerp_phase(int p, float prev, float cent,
                                            float next) {
  return mix(phase_wx(p), p < 2 ? prev : next, phase_wc(p), cent);
}

// Shared-memory layout of the staged kernels (theta, argmax/repair).
__host__ __device__ inline size_t staged_smem_bytes(int K) {
  return sizeof(float) * (size_t)K * 4 * SC   // R[K][4][SC]
         + sizeof(int) * (size_t)K            // per-block histogram
         + 2 * (size_t)K;                     // two per-slot flag arrays
}

// R[(k*4 + pr)*SC + c] = row phase pr of low-res row i at local column c,
// where c = 0 is column j0-1 and c = SW+1 is column j0+SW (both clamped).
// Element (k, row, col) of m lies at m[k*sk + row*sr + col*sc]: slot-major
// [K, h, w] masks (sk = h*w, sr = w, sc = 1) or NHWC [h, w, K] logits
// (sk = 1, sr = w*K, sc = K).
__device__ void stage_rows(const float* __restrict__ m, int K, int h, int w,
                           size_t sk, size_t sr, size_t sc, int i, int j0,
                           float* R) {
  const int ip = max(i - 1, 0);
  const int in = min(i + 1, h - 1);
  for (int e = threadIdx.x; e < K * SC; e += blockDim.x) {
    const int k = e / SC;
    const int c = e % SC;
    const int jj = min(max(j0 - 1 + c, 0), w - 1);
    const float* mk = m + (size_t)k * sk + (size_t)jj * sc;
    const float prev = mk[(size_t)ip * sr];
    const float cent = mk[(size_t)i * sr];
    const float next = mk[(size_t)in * sr];
    float* r = R + (size_t)k * 4 * SC + c;
#pragma unroll
    for (int p = 0; p < 4; ++p) r[p * SC] = lerp_phase(p, prev, cent, next);
  }
}

__device__ __forceinline__ void stage_rows(const float* __restrict__ m,
                                           int K, int h, int w, int i, int j0,
                                           float* R) {
  stage_rows(m, K, h, w, (size_t)h * w, (size_t)w, 1, i, j0, R);
}

// Per-thread column phase of the staged kernels: its weights and which
// staged column (local jl or jl + 2) is its outer sample.  Computed once,
// so the warp's four column phases do not diverge inside the slot loop.
struct ColPhase {
  float wx, wc;
  int xo;
  __device__ explicit ColPhase(int pc)
      : wx(phase_wx(pc)), wc(phase_wc(pc)), xo(pc < 2 ? 0 : 2) {}
};

// Upsampled value of slot k at the calling thread's pixel (row phase pr,
// local low-res column jl) from the staged rows.
__device__ __forceinline__ float staged_value(const float* R, int k, int pr,
                                              int jl, const ColPhase& cp) {
  const float* r = R + ((size_t)k * 4 + pr) * SC + jl;
  return mix(cp.wx, r[cp.xo], cp.wc, r[1]);
}

__global__ void __launch_bounds__(NT)
theta_kernel(const float* __restrict__ m, const uint8_t* __restrict__ valid,
             float log_thr, float* __restrict__ out, int K, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* R = reinterpret_cast<float*>(smem);
  uint8_t* s_valid =
      reinterpret_cast<uint8_t*>(R + (size_t)K * 4 * SC) + sizeof(int) * K;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * SW;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_valid[k] = valid[k];
  stage_rows(m, K, h, w, i, j0, R);
  __syncthreads();

  const int pr = threadIdx.x / FW;
  const int xl = threadIdx.x % FW;
  const int jl = xl >> 2;
  const ColPhase cp(xl & 3);
  if (j0 + jl >= w) return;
  float mx = -INFINITY;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float v = s_valid[k] ? staged_value(R, k, pr, jl, cp) : NEG;
    mx = fmaxf(mx, v);
  }
  // invalid slots add exp(-1e30 - mx) = 0 (or, with no valid slot at all,
  // leave theta at -1e30 whatever z is): skip them
  float z = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k)
    if (s_valid[k])
      z = __fadd_rn(z, expf(__fsub_rn(staged_value(R, k, pr, jl, cp), mx)));
  const size_t W4 = 4 * (size_t)w;
  out[(size_t)(4 * i + pr) * W4 + 4 * j0 + xl] =
      __fadd_rn(__fadd_rn(log_thr, mx), logf(fmaxf(z, 1e-30f)));
}

// Masked argmax + per-tile areas; with `dirty` non-null, one repair
// iteration: clean tiles copy m1 (and, from one block per tile, their area
// row) and return.
__global__ void __launch_bounds__(NT)
argmax_kernel(const float* __restrict__ m, const int8_t* __restrict__ owner,
              const uint8_t* __restrict__ kept,
              const uint8_t* __restrict__ is_thing,
              const uint8_t* __restrict__ dirty,
              const int32_t* __restrict__ m1,
              const int32_t* __restrict__ areas_prev,
              int32_t* __restrict__ m_id, int32_t* __restrict__ areas, int K,
              int h, int w, int hb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* R = reinterpret_cast<float*>(smem);
  int* hist = reinterpret_cast<int*>(R + (size_t)K * 4 * SC);
  uint8_t* s_kept = reinterpret_cast<uint8_t*>(hist + K);
  uint8_t* s_thing = s_kept + K;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * SW;
  const int t = i / hb;
  const int pr = threadIdx.x / FW;
  const int xl = threadIdx.x % FW;
  const int jl = xl >> 2;
  const ColPhase cp(xl & 3);
  const bool inside = j0 + jl < w;
  const size_t W4 = 4 * (size_t)w;
  const size_t pix = (size_t)(4 * i + pr) * W4 + 4 * j0 + xl;

  if (dirty != nullptr && !dirty[t]) {
    // no pixel of this tile had its winner removed: the argmax over a
    // subset that still holds the max is unchanged
    if (inside) m_id[pix] = m1[pix];
    if (blockIdx.x == 0 && i % hb == 0)
      for (int k = threadIdx.x; k < K; k += blockDim.x)
        areas[(size_t)t * K + k] = areas_prev[(size_t)t * K + k];
    return;
  }

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    hist[k] = 0;
    s_kept[k] = kept[k];
    s_thing[k] = is_thing[k];
  }
  stage_rows(m, K, h, w, i, j0, R);
  __syncthreads();

  int id = -1;
  if (inside) {
    const int o = owner[pix];
    float best = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float v = staged_value(R, k, pr, jl, cp);
      if (s_thing[k] && o != k) v = 0.f;   // things count where they own
      if (!s_kept[k]) v = NEG;
      if (k == 0 || v > best) {            // ties -> first slot
        best = v;
        id = k;
      }
    }
    m_id[pix] = id;
  }
  // warp-aggregated histogram: one shared atomic per distinct id per warp
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  if (id >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[id], __popc(peers));
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (hist[k]) atomicAdd(&areas[(size_t)t * K + k], hist[k]);
}

// The semantic map: per full-res pixel, the first channel holding the max
// of the x4-upsampled logits (torch.argmax's tie rule; the TPU kernel's
// `vals >= mx` then min index).  x is NHWC [h, w, C] f32.
__global__ void __launch_bounds__(NT)
sseg_kernel(const float* __restrict__ x, int64_t* __restrict__ out, int C,
            int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* R = reinterpret_cast<float*>(smem);
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * SW;
  stage_rows(x, C, h, w, 1, (size_t)w * C, (size_t)C, i, j0, R);
  __syncthreads();

  const int pr = threadIdx.x / FW;
  const int xl = threadIdx.x % FW;
  const int jl = xl >> 2;
  const ColPhase cp(xl & 3);
  if (j0 + jl >= w) return;
  float best = 0.f;
  int id = 0;
  for (int k = 0; k < C; ++k) {
    const float v = staged_value(R, k, pr, jl, cp);
    if (k == 0 || v > best) {            // ties -> first channel
      best = v;
      id = k;
    }
  }
  out[(size_t)(4 * i + pr) * (4 * (size_t)w) + 4 * j0 + xl] = id;
}

// Upsampled values of slot mk at the 4 full-res pixels (Y, 4j .. 4j+3).
__device__ __forceinline__ void upsample_quad(const float* __restrict__ mk,
                                              int h, int w, int Y, int j,
                                              float v[4]) {
  const int i = Y >> 2;
  const int pr = Y & 3;
  const int ip = max(i - 1, 0);
  const int in = min(i + 1, h - 1);
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int jj = min(max(j - 1 + c, 0), w - 1);
    r[c] = lerp_phase(pr, mk[(size_t)ip * w + jj], mk[(size_t)i * w + jj],
                      mk[(size_t)in * w + jj]);
  }
#pragma unroll
  for (int pc = 0; pc < 4; ++pc) v[pc] = lerp_phase(pc, r[0], r[1], r[2]);
}

__device__ __forceinline__ int block_sum(int x, int* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) total += s_red[wi];
  return total;   // valid in thread 0 only
}

// One step of the greedy claim loop.  scratch: [K] pixel counts, [K]
// same-class overlaps, [K] block tickets, then `pending` = 1 + the slot
// whose claim is still to be applied (0 = none).  Launch `slot` applies the
// pending claim and, if `slot` is a valid thing (flags[slot]), counts n and
// ovl for it; its last block decides keep[slot] and sets `pending`.  The
// launch with slot = -1 only applies the pending claim.
__global__ void __launch_bounds__(CT)
claim_kernel(const float* __restrict__ m, const float* __restrict__ theta,
             const int32_t* __restrict__ labels,
             const uint8_t* __restrict__ flags, float frac, int K, int h,
             int w, int slot, int8_t* __restrict__ owner,
             uint8_t* __restrict__ keep, int32_t* scratch) {
  __shared__ int s_labels[128];
  __shared__ int s_red[2][CT / 32];
  if (slot >= 0 && !flags[slot]) return;     // the whole launch is a no-op
  int32_t* cnt_n = scratch;
  int32_t* cnt_o = scratch + K;
  int32_t* ticket = scratch + 2 * K;
  int32_t* pending = scratch + 3 * K;
  const int p = *pending - 1;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_labels[k] = labels[k];
  __syncthreads();

  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int W4 = 4 * w;
  const size_t n_quads = (size_t)4 * h * w;
  int n = 0, ovl = 0;
  if (q < n_quads) {
    const int Y = (int)(q / w);
    const int j = (int)(q % w);
    const size_t base = (size_t)Y * W4 + 4 * j;
    const float4 th = *reinterpret_cast<const float4*>(theta + base);
    const float thv[4] = {th.x, th.y, th.z, th.w};
    char4 o4 = *reinterpret_cast<const char4*>(owner + base);
    int o[4] = {o4.x, o4.y, o4.z, o4.w};
    bool changed = false;
    float v[4];
    if (p >= 0) {
      upsample_quad(m + (size_t)p * h * w, h, w, Y, j, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (o[c] < 0 && v[c] >= thv[c]) {
          o[c] = p;
          changed = true;
        }
    }
    if (slot >= 0) {
      const int cls = s_labels[slot];
      upsample_quad(m + (size_t)slot * h * w, h, w, Y, j, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v[c] >= thv[c]) {
          ++n;
          if (o[c] >= 0 && s_labels[o[c]] == cls) ++ovl;
        }
    }
    if (changed)
      *reinterpret_cast<char4*>(owner + base) =
          make_char4((signed char)o[0], (signed char)o[1], (signed char)o[2],
                     (signed char)o[3]);
  }
  if (slot < 0) return;

  const int bn = block_sum(n, s_red[0]);
  const int bo = block_sum(ovl, s_red[1]);
  if (threadIdx.x == 0) {
    atomicAdd(&cnt_n[slot], bn);
    atomicAdd(&cnt_o[slot], bo);
    __threadfence();
    const int done = atomicAdd(&ticket[slot], 1);
    if (done == (int)gridDim.x - 1) {          // the last block decides
      const int tn = atomicAdd(&cnt_n[slot], 0);
      const int to = atomicAdd(&cnt_o[slot], 0);
      const bool degenerate = tn == 0 || (size_t)tn == n_quads * 4;
      const bool reject =
          degenerate ||
          __fdiv_rn(__int2float_rn(to), __int2float_rn(max(tn, 1))) > frac;
      keep[slot] = reject ? 0 : 1;
      *pending = reject ? 0 : slot + 1;
    }
  }
}

cudaError_t set_smem(const void* fn, int K) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)staged_smem_bytes(K));
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched).  The Python wrapper checks shapes, types, contiguity
// and K <= 127, and allocates (and zeroes, where said) every output.

// theta [4h, 4w] f32.
extern "C" int pp_theta(const void* m, const void* valid, float log_thr,
                        void* out, int K, int h, int w, void* stream) {
  cudaError_t err = set_smem((const void*)theta_kernel, K);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  theta_kernel<<<grid, NT, staged_smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float*>(m), static_cast<const uint8_t*>(valid),
      log_thr, static_cast<float*>(out), K, h, w);
  return (int)cudaGetLastError();
}

// The claim loop over slots lo .. hi-1 (every valid thing slot must lie in
// that range; others are skipped on the device), then one launch that
// applies the last claim: hi - lo + 1 launches.  Initializes owner to -1,
// keep to 0 and scratch (3K + 1 int32) to 0 on the stream.
extern "C" int pp_claim(const void* m, const void* theta, const void* labels,
                        const void* flags, float frac, int K, int h, int w,
                        int lo, int hi, void* owner, void* keep,
                        void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(owner, 0xff, (size_t)16 * h * w, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(keep, 0, (size_t)K, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (3 * (size_t)K + 1),
                          s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((size_t)4 * h * w + CT - 1) / CT);
  for (int slot = lo; slot <= hi; ++slot) {
    claim_kernel<<<blocks, CT, 0, s>>>(
        static_cast<const float*>(m), static_cast<const float*>(theta),
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(flags), frac, K, h, w,
        slot < hi ? slot : -1, static_cast<int8_t*>(owner),
        static_cast<uint8_t*>(keep), static_cast<int32_t*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// m_id [4h, 4w] int32 and areas [T, K] int32 (zeroed by the caller).
extern "C" int pp_argmax(const void* m, const void* owner, const void* kept,
                         const void* is_thing, void* m_id, void* areas, int K,
                         int h, int w, int hb, void* stream) {
  cudaError_t err = set_smem((const void*)argmax_kernel, K);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  argmax_kernel<<<grid, NT, staged_smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float*>(m), static_cast<const int8_t*>(owner),
      static_cast<const uint8_t*>(kept), static_cast<const uint8_t*>(is_thing),
      nullptr, nullptr, nullptr, static_cast<int32_t*>(m_id),
      static_cast<int32_t*>(areas), K, h, w, hb);
  return (int)cudaGetLastError();
}

// One small-area-filter iteration; areas [T, K] int32 zeroed by the caller.
extern "C" int pp_repair(const void* m, const void* owner, const void* m1,
                         const void* kept, const void* is_thing,
                         const void* dirty, const void* areas_prev,
                         void* m_id, void* areas, int K, int h, int w, int hb,
                         void* stream) {
  cudaError_t err = set_smem((const void*)argmax_kernel, K);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  argmax_kernel<<<grid, NT, staged_smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float*>(m), static_cast<const int8_t*>(owner),
      static_cast<const uint8_t*>(kept), static_cast<const uint8_t*>(is_thing),
      static_cast<const uint8_t*>(dirty), static_cast<const int32_t*>(m1),
      static_cast<const int32_t*>(areas_prev), static_cast<int32_t*>(m_id),
      static_cast<int32_t*>(areas), K, h, w, hb);
  return (int)cudaGetLastError();
}

// The semantic map [4h, 4w] int64 of NHWC logits x [h, w, C] f32.
extern "C" int pp_sseg(const void* x, void* out, int C, int h, int w,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)sseg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * (size_t)C * 4 * SC));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  sseg_kernel<<<grid, NT, sizeof(float) * (size_t)C * 4 * SC,
                (cudaStream_t)stream>>>(static_cast<const float*>(x),
                                        static_cast<int64_t*>(out), C, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* pp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
