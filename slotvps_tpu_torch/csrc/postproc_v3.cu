// Fused panoptic post-processing for Hopper: theta, claim, argmax, repair
// and the semantic argmax (sseg).
//
// Replaces the TPU kernels of slotvps_tpu/ops/pallas/postproc_v3.py:
// theta_v3, claim_v3, argmax_v3 (per_tile=True, and top2=True), repair_v3,
// hist_v3 and sseg_v3; and, through the *_hwk entries, those of
// slotvps_tpu/ops/pallas/postproc_fused.py: theta_pallas, claim_scan_fused
// and argmax_areas_pallas.
// Each kernel
// computes exactly what its plain version in
// slotvps_tpu_torch/ops/postproc_v3.py (or ops/postproc_fused.py) computes.
// Masks are at low resolution, slot-major m [K, h, w] f32 or, for the
// postproc_fused.py functions, K-minor m [h, w, K] f32 (a Layout of strides
// says which; no transposed copy is made); every full-resolution map is
// row-major [H, W] = [4h, 4w].  The [K, H, W] upsampled stack never exists:
// each kernel rebuilds the upsampled values it needs from the low-res rows.
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
//          With top2 it also writes the runner-up m2_id (8.4 MB): a second
//          pass over the staged values with the winner excluded, ~3 more
//          flops per (pixel, slot).
//   hist   reads an int32 id map once (8.4 MB) and writes K counts: ~2.5 us
//          of bytes.  The same warp-aggregated shared histogram, one global
//          atomic per slot per block.
//   repair is argmax on the dirty tiles only; clean tiles copy m1 and their
//          area row through (typically 1-2 of 32 tiles are dirty, so the
//          copy, 16.8 MB of traffic, is most of its time).  Launched over
//          all tiles with an early copy-and-return on clean ones: no
//          compacted tile list, no extra host sync.
// The K-minor entries run the same kernels with other strides.  theta and
// argmax stage a block's low-res rows with neighbouring threads on
// neighbouring slots (the slots of a pixel are contiguous), so their
// bounds are the slot-major ones.  The claim kernel reads the 3x3 low-res
// neighbourhood of one slot per pixel quad: in K-minor memory each read
// uses 4 of a 32-byte sector, so a launch moves ~8x the plane's bytes
// (~4 MB at 256x512, mostly from L2 while the masks fit in it).  argmax's
// areas are the whole map's: one row tile of h low-res rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int SW = 32;          // low-res columns per block strip
constexpr int FW = 4 * SW;      // full-res columns per block strip
constexpr int NT = 4 * FW;      // threads: 4 row phases x FW columns
constexpr int SC = SW + 2;      // staged low-res columns, with both halos
constexpr int CT = 256;         // claim kernel threads per block
constexpr int HT = 256;         // hist kernel threads per block
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

// Where element (k, row, col) of a [K, h, w]-indexed input lies:
// m[k*sk + row*sr + col*sc].  Slot-major [K, h, w] masks: (h*w, w, 1);
// K-minor [h, w, K] masks or NHWC [h, w, C] logits: (1, w*K, K).
struct Layout {
  size_t sk, sr, sc;
};

__host__ __device__ inline Layout slot_major(int K, int h, int w) {
  return Layout{(size_t)h * w, (size_t)w, 1};
}

__host__ __device__ inline Layout k_minor(int K, int h, int w) {
  return Layout{1, (size_t)w * K, (size_t)K};
}

// R[(k*4 + pr)*SC + c] = row phase pr of low-res row i at local column c,
// where c = 0 is column j0-1 and c = SW+1 is column j0+SW (both clamped).
// Neighbouring threads read neighbouring addresses: along the columns of a
// slot-major input, along the slots of a K-minor one.
__device__ void stage_rows(const float* __restrict__ m, int K, int h, int w,
                           Layout L, int i, int j0, float* R) {
  const int ip = max(i - 1, 0);
  const int in = min(i + 1, h - 1);
  const bool slots_inner = L.sk == 1;
  for (int e = threadIdx.x; e < K * SC; e += blockDim.x) {
    const int k = slots_inner ? e % K : e / SC;
    const int c = slots_inner ? e / K : e % SC;
    const int jj = min(max(j0 - 1 + c, 0), w - 1);
    const float* mk = m + (size_t)k * L.sk + (size_t)jj * L.sc;
    const float prev = mk[(size_t)ip * L.sr];
    const float cent = mk[(size_t)i * L.sr];
    const float next = mk[(size_t)in * L.sr];
    float* r = R + (size_t)k * 4 * SC + c;
#pragma unroll
    for (int p = 0; p < 4; ++p) r[p * SC] = lerp_phase(p, prev, cent, next);
  }
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
theta_kernel(const float* __restrict__ m, Layout L,
             const uint8_t* __restrict__ valid, float log_thr,
             float* __restrict__ out, int K, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* R = reinterpret_cast<float*>(smem);
  uint8_t* s_valid =
      reinterpret_cast<uint8_t*>(R + (size_t)K * 4 * SC) + sizeof(int) * K;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * SW;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_valid[k] = valid[k];
  stage_rows(m, K, h, w, L, i, j0, R);
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

// Masked argmax + per-tile areas; with `m2_id` non-null also the runner-up
// (the first slot holding the max once the winner's value is -1e30, as
// argmax_v3(top2=True) takes it); with `dirty` non-null, one repair
// iteration: clean tiles copy m1 (and, from one block per tile, their area
// row) and return.
__global__ void __launch_bounds__(NT)
argmax_kernel(const float* __restrict__ m, Layout L,
              const int8_t* __restrict__ owner,
              const uint8_t* __restrict__ kept,
              const uint8_t* __restrict__ is_thing,
              const uint8_t* __restrict__ dirty,
              const int32_t* __restrict__ m1,
              const int32_t* __restrict__ areas_prev,
              int32_t* __restrict__ m_id, int32_t* __restrict__ m2_id,
              int32_t* __restrict__ areas, int K, int h, int w, int hb) {
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
  stage_rows(m, K, h, w, L, i, j0, R);
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
    if (m2_id != nullptr) {
      float best2 = 0.f;
      int id2 = 0;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float v = staged_value(R, k, pr, jl, cp);
        if (s_thing[k] && o != k) v = 0.f;
        if (!s_kept[k] || k == id) v = NEG;
        if (k == 0 || v > best2) {
          best2 = v;
          id2 = k;
        }
      }
      m2_id[pix] = id2;
    }
  }
  // warp-aggregated histogram: one shared atomic per distinct id per warp
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  if (id >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[id], __popc(peers));
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (hist[k]) atomicAdd(&areas[(size_t)t * K + k], hist[k]);
}

// Per-slot pixel counts of an int32 id map of n entries (ids outside
// [0, K) are not counted): each thread reads 4 ids per step, the warp
// aggregates equal ids (__match_any_sync) into one shared atomic, and each
// block adds its histogram with one global atomic per slot.  The loop runs
// the same number of steps in every thread of a block, so every lane takes
// part in each __match_any_sync.
__global__ void __launch_bounds__(HT)
hist_kernel(const int32_t* __restrict__ m_id, size_t n, int K,
            int32_t* __restrict__ areas) {
  extern __shared__ int hist[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const size_t step = (size_t)gridDim.x * blockDim.x * 4;
  for (size_t base = (size_t)blockIdx.x * blockDim.x * 4; base < n;
       base += step) {
    const size_t i = base + 4 * (size_t)threadIdx.x;
    int ids[4];
    if (i + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(m_id + i);
      ids[0] = v.x;
      ids[1] = v.y;
      ids[2] = v.z;
      ids[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) ids[c] = i + c < n ? m_id[i + c] : -1;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int id = ids[c] >= 0 && ids[c] < K ? ids[c] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, id);
      if (id >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&hist[id], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (hist[k]) atomicAdd(&areas[k], hist[k]);
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
  stage_rows(x, C, h, w, k_minor(C, h, w), i, j0, R);
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

// Upsampled values of the slot whose element (row, col) lies at
// mk[row*L.sr + col*L.sc] at the 4 full-res pixels (Y, 4j .. 4j+3).
__device__ __forceinline__ void upsample_quad(const float* __restrict__ mk,
                                              Layout L, int h, int w, int Y,
                                              int j, float v[4]) {
  const int i = Y >> 2;
  const int pr = Y & 3;
  const int ip = max(i - 1, 0);
  const int in = min(i + 1, h - 1);
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* col = mk + (size_t)min(max(j - 1 + c, 0), w - 1) * L.sc;
    r[c] = lerp_phase(pr, col[(size_t)ip * L.sr], col[(size_t)i * L.sr],
                      col[(size_t)in * L.sr]);
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
claim_kernel(const float* __restrict__ m, Layout L,
             const float* __restrict__ theta,
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
      upsample_quad(m + (size_t)p * L.sk, L, h, w, Y, j, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (o[c] < 0 && v[c] >= thv[c]) {
          o[c] = p;
          changed = true;
        }
    }
    if (slot >= 0) {
      const int cls = s_labels[slot];
      upsample_quad(m + (size_t)slot * L.sk, L, h, w, Y, j, v);
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

int launch_theta(const void* m, Layout L, const void* valid, float log_thr,
                 void* out, int K, int h, int w, void* stream) {
  cudaError_t err = set_smem((const void*)theta_kernel, K);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  theta_kernel<<<grid, NT, staged_smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float*>(m), L, static_cast<const uint8_t*>(valid),
      log_thr, static_cast<float*>(out), K, h, w);
  return (int)cudaGetLastError();
}

// The claim loop: one launch per slot of the sequence (slots[0 .. n-1] if
// `slots` is not null, else lo .. lo+n-1), in that order, then one launch
// that applies the last claim: n + 1 launches.  Every valid thing slot must
// be in the sequence; other slots in it are skipped on the device.
// Initializes owner to -1, keep to 0 and scratch (3K + 1 int32) to 0 on the
// stream.
int claim_loop(const void* m, Layout L, const void* theta, const void* labels,
               const void* flags, float frac, int K, int h, int w,
               const int* slots, int lo, int n, void* owner, void* keep,
               void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(owner, 0xff, (size_t)16 * h * w, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(keep, 0, (size_t)K, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (3 * (size_t)K + 1),
                          s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((size_t)4 * h * w + CT - 1) / CT);
  for (int t = 0; t <= n; ++t) {
    const int slot = t == n ? -1 : (slots != nullptr ? slots[t] : lo + t);
    claim_kernel<<<blocks, CT, 0, s>>>(
        static_cast<const float*>(m), L, static_cast<const float*>(theta),
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(flags), frac, K, h, w, slot,
        static_cast<int8_t*>(owner), static_cast<uint8_t*>(keep),
        static_cast<int32_t*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch_argmax(const void* m, Layout L, const void* owner,
                  const void* kept, const void* is_thing, void* m_id,
                  void* m2_id, void* areas, int K, int h, int w, int hb,
                  void* stream) {
  cudaError_t err = set_smem((const void*)argmax_kernel, K);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + SW - 1) / SW, h);
  argmax_kernel<<<grid, NT, staged_smem_bytes(K), (cudaStream_t)stream>>>(
      static_cast<const float*>(m), L, static_cast<const int8_t*>(owner),
      static_cast<const uint8_t*>(kept), static_cast<const uint8_t*>(is_thing),
      nullptr, nullptr, nullptr, static_cast<int32_t*>(m_id),
      static_cast<int32_t*>(m2_id), static_cast<int32_t*>(areas), K, h, w,
      hb);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched).  The Python wrapper checks shapes, types, contiguity
// and K <= 127, and allocates (and zeroes, where said) every output.  The
// *_hwk entries take K-minor masks m [h, w, K] (postproc_fused.py's
// layout), the others slot-major m [K, h, w].

// theta [4h, 4w] f32.
extern "C" int pp_theta(const void* m, const void* valid, float log_thr,
                        void* out, int K, int h, int w, void* stream) {
  return launch_theta(m, slot_major(K, h, w), valid, log_thr, out, K, h, w,
                      stream);
}

extern "C" int pp_theta_hwk(const void* m, const void* valid, float log_thr,
                            void* out, int K, int h, int w, void* stream) {
  return launch_theta(m, k_minor(K, h, w), valid, log_thr, out, K, h, w,
                      stream);
}

// The claim loop over slots lo .. hi-1 (every valid thing slot must lie in
// that range): hi - lo + 1 launches.
extern "C" int pp_claim(const void* m, const void* theta, const void* labels,
                        const void* flags, float frac, int K, int h, int w,
                        int lo, int hi, void* owner, void* keep,
                        void* scratch, void* stream) {
  return claim_loop(m, slot_major(K, h, w), theta, labels, flags, frac, K, h,
                    w, nullptr, lo, hi - lo, owner, keep, scratch, stream);
}

// The claim loop over the n slots of the host array `slots` (the valid
// thing slots, ascending): n + 1 launches.
extern "C" int pp_claim_hwk(const void* m, const void* theta,
                            const void* labels, const void* flags, float frac,
                            int K, int h, int w, const int* slots, int n,
                            void* owner, void* keep, void* scratch,
                            void* stream) {
  return claim_loop(m, k_minor(K, h, w), theta, labels, flags, frac, K, h, w,
                    slots, 0, n, owner, keep, scratch, stream);
}

// m_id [4h, 4w] int32, areas [T, K] int32 (zeroed by the caller) and, when
// m2_id is not null, the runner-up map [4h, 4w] int32.
extern "C" int pp_argmax(const void* m, const void* owner, const void* kept,
                         const void* is_thing, void* m_id, void* m2_id,
                         void* areas, int K, int h, int w, int hb,
                         void* stream) {
  return launch_argmax(m, slot_major(K, h, w), owner, kept, is_thing, m_id,
                       m2_id, areas, K, h, w, hb, stream);
}

// m_id [4h, 4w] int32 and the whole map's areas [K] int32 (zeroed by the
// caller): one row tile of h low-res rows.
extern "C" int pp_argmax_hwk(const void* m, const void* owner,
                             const void* kept, const void* is_thing,
                             void* m_id, void* areas, int K, int h, int w,
                             void* stream) {
  return launch_argmax(m, k_minor(K, h, w), owner, kept, is_thing, m_id,
                       nullptr, areas, K, h, w, h, stream);
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
      static_cast<const float*>(m), slot_major(K, h, w),
      static_cast<const int8_t*>(owner), static_cast<const uint8_t*>(kept),
      static_cast<const uint8_t*>(is_thing), static_cast<const uint8_t*>(dirty),
      static_cast<const int32_t*>(m1), static_cast<const int32_t*>(areas_prev),
      static_cast<int32_t*>(m_id),
      nullptr, static_cast<int32_t*>(areas), K, h, w, hb);
  return (int)cudaGetLastError();
}

// Per-slot counts areas [K] int32 (zeroed by the caller) of an int32 id
// map of n entries, 16-byte aligned; at most 1024 blocks, each looping.
extern "C" int pp_hist(const void* m_id, long long n, int K, void* areas,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(int) * (size_t)K));
  if (err != cudaSuccess) return (int)err;
  const long long per_block = 4LL * HT;
  const int n_blocks = (int)std::max(
      1LL, std::min(1024LL, (n + per_block - 1) / per_block));
  hist_kernel<<<n_blocks, HT, sizeof(int) * (size_t)K,
                (cudaStream_t)stream>>>(static_cast<const int32_t*>(m_id),
                                        (size_t)n, K,
                                        static_cast<int32_t*>(areas));
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
