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
//   theta  reads the valid slots' masks once (40 of 64: 21 MB) and writes
//          theta (8.4 MB): ~9 us of bytes at 3.35 TB/s.  Its arithmetic is
//          ~2M pixels x valid slots x (3 flops + 1 expf) and is the larger
//          bound; staging the row-interpolated values of the valid slots in
//          shared memory leaves 3 flops per (pixel, slot) for the column
//          phase, one pass with a running max.  At K = 64, 40 valid
//          (kernel_variants.py theta, H100 at 700 W) it takes 0.069 ms,
//          issue-bound in that pass (expf ~0.023 of it; staging alone
//          0.024, ~0.011 of it exposed); the earlier kernel (a block a
//          low-res row, all K slots staged, two passes) took 0.20 ms: the
//          max pass 0.07, expf 0.03, exposed staging 0.02.
//   claim  is sequential over the valid thing slots: slot i's keep decision
//          needs whole-map counts taken after every earlier claim.  One
//          persistent cooperative launch a call (claim_loop.cuh): a block
//          a streaming multiprocessor owns a run of full-res pixels, keeps
//          its owner tile and a bit word a pixel in shared memory, and
//          builds the words of up to 32 valid things in one pass (below);
//          then one step a valid thing (claim, count, one atomic a block)
//          with a grid-wide barrier between steps.  Bound: the valid
//          things' masks and theta read once, the owner map written once,
//          and the upsample of each valid thing: ~0.01 ms; the ~n_claim
//          barriers (1-3 us each) come on top of it.  The earlier kernel
//          (one launch a slot, each re-reading theta, the owner map and
//          two slots' neighbourhoods) took 0.52-0.60 ms at K = 64
//          (PERF.md).
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
// The K-minor entries run the same kernels with other strides.  theta,
// argmax and the claim's bits pass stage a block's low-res rows with
// neighbouring threads on neighbouring slots (the slots of a pixel are
// contiguous), so their bounds are the slot-major ones.  argmax's areas are
// the whole map's: one row tile of h low-res rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "claim_loop.cuh"

namespace {

constexpr int SW = 32;          // low-res columns per block strip
constexpr int FW = 4 * SW;      // full-res columns per block strip
constexpr int NT = 4 * FW;      // threads: 4 row phases x FW columns
constexpr int SC = SW + 2;      // staged low-res columns, with both halos
constexpr int CSW = 256;        // low-res columns of a claim strip
constexpr int CSC = CSW + 2;    // staged columns of a claim strip
constexpr int STAGE_U = 4;      // staged entries a thread loads at once
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

// Shared-memory layout of the staged kernels (argmax/repair).
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

// theta: a block owns TH_RB low-res rows x TH_CW low-res columns, a thread
// one (row phase, row, low-res column): the four full-res pixels of that
// column's phases.  The block lists the valid slots in slot order (a
// ballot over valid[], no host sync) and stages them TH_CH at a time: one
// read of rows i0-1 .. i0+TH_RB (the block's rows share their prev and
// next rows) into registers, the row phases of each block row into shared
// memory; the next chunk's reads are issued before the current chunk is
// taken, so they land during its arithmetic.  Each thread reads three
// staged values a slot (its column and both neighbours), forms the four
// column phases with the plain version's arithmetic and folds each into a
// running max and sum of exp in one pass: z = z * exp(mx - v) + 1 where v
// is a new max, else z + exp(v - mx), one expf a (pixel, slot).
constexpr int TH_CW = 32;                    // low-res columns a block
constexpr int TH_RB = 2;                     // low-res rows a block
constexpr int TH_THREADS = 4 * TH_RB * TH_CW;
constexpr int TH_CH = 16;                    // valid slots staged at a time
constexpr int TH_SC = TH_CW + 2;             // staged columns, both halos
constexpr int TH_UNITS = (TH_CH * TH_SC + TH_THREADS - 1) / TH_THREADS;

__global__ void __launch_bounds__(TH_THREADS, 4)
theta_kernel(const float* __restrict__ m, Layout L,
             const uint8_t* __restrict__ valid, float log_thr,
             float* __restrict__ out, int K, int h, int w) {
  // R[buf][slot of the chunk][block row][row phase][staged column]
  __shared__ float R[2][TH_CH][TH_RB][4][TH_SC];
  __shared__ uint8_t s_list[128];
  __shared__ int s_cnt[TH_THREADS / 32];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TH_RB;
  const int j0 = blockIdx.x * TH_CW;

  // the valid slots in slot order
  const bool f = tid < K && valid[tid];
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  if ((tid & 31) == 0) s_cnt[tid >> 5] = __popc(bal);
  __syncthreads();
  int n_valid = 0, pos = __popc(bal & ((1u << (tid & 31)) - 1));
  for (int wi = 0; wi < TH_THREADS / 32; ++wi) {
    if (wi < (tid >> 5)) pos += s_cnt[wi];
    n_valid += s_cnt[wi];
  }
  if (f) s_list[pos] = (uint8_t)tid;

  // low-res rows i0-1 .. i0+TH_RB, clamped
  size_t rows[TH_RB + 2];
#pragma unroll
  for (int a = 0; a < TH_RB + 2; ++a)
    rows[a] = (size_t)min(max(i0 - 1 + a, 0), h - 1) * L.sr;
  const bool slots_inner = L.sk == 1;
  float raw[TH_UNITS][TH_RB + 2];
  // the raw rows of staging unit (slot t of the chunk at c0, column c):
  // neighbouring threads on neighbouring columns of slot-major masks, on
  // neighbouring slots of K-minor ones
  auto load = [&](int c0, int nc) {
#pragma unroll
    for (int u = 0; u < TH_UNITS; ++u) {
      const int e = tid + u * TH_THREADS;
      if (e >= nc * TH_SC) continue;
      const int t = slots_inner ? e % nc : e / TH_SC;
      const int c = slots_inner ? e / nc : e % TH_SC;
      const int jj = min(max(j0 - 1 + c, 0), w - 1);
      const float* mk =
          m + (size_t)s_list[c0 + t] * L.sk + (size_t)jj * L.sc;
#pragma unroll
      for (int a = 0; a < TH_RB + 2; ++a) raw[u][a] = mk[rows[a]];
    }
  };
  auto store = [&](int buf, int nc) {
#pragma unroll
    for (int u = 0; u < TH_UNITS; ++u) {
      const int e = tid + u * TH_THREADS;
      if (e >= nc * TH_SC) continue;
      const int t = slots_inner ? e % nc : e / TH_SC;
      const int c = slots_inner ? e / nc : e % TH_SC;
#pragma unroll
      for (int r = 0; r < TH_RB; ++r)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          R[buf][t][r][p][c] =
              lerp_phase(p, raw[u][r], raw[u][r + 1], raw[u][r + 2]);
    }
  };

  const int jl = tid % TH_CW;
  const int pr = (tid / TH_CW) & 3;
  const int r = tid / (4 * TH_CW);
  const bool inside = i0 + r < h && j0 + jl < w;
  const int n_chunks = (n_valid + TH_CH - 1) / TH_CH;
  float mx[4], z[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mx[c] = NEG;   // with no valid slot theta stays at about -1e30
    z[c] = 0.f;
  }
  __syncthreads();   // s_list is complete
  if (n_chunks > 0) {
    load(0, min(TH_CH, n_valid));
    store(0, min(TH_CH, n_valid));
  }
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int nc = min(TH_CH, n_valid - ch * TH_CH);
    const int nc_next = min(TH_CH, n_valid - (ch + 1) * TH_CH);
    if (nc_next > 0) load((ch + 1) * TH_CH, nc_next);
    if (inside) {
#pragma unroll 4
      for (int t = 0; t < nc; ++t) {
        const float* x = &R[ch & 1][t][r][pr][jl];
        const float x0 = x[0], x1 = x[1], x2 = x[2];
        // the column phases 0..3: mix(wx, prev or next, wc, cent)
        const float v[4] = {mix(0.375f, x0, 0.625f, x1),
                            mix(0.125f, x0, 0.875f, x1),
                            mix(0.125f, x2, 0.875f, x1),
                            mix(0.375f, x2, 0.625f, x1)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float d = v[c] - mx[c];
          const float e = expf(-fabsf(d));
          z[c] = d > 0.f ? fmaf(z[c], e, 1.f) : z[c] + e;
          mx[c] = fmaxf(mx[c], v[c]);
        }
      }
    }
    if (nc_next > 0) store((ch + 1) & 1, nc_next);
    __syncthreads();
  }
  if (!inside) return;
  float th[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    th[c] = __fadd_rn(__fadd_rn(log_thr, mx[c]), logf(fmaxf(z[c], 1e-30f)));
  const size_t W4 = 4 * (size_t)w;
  *reinterpret_cast<float4*>(out + (size_t)(4 * (i0 + r) + pr) * W4 +
                             4 * (j0 + jl)) =
      make_float4(th[0], th[1], th[2], th[3]);
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

static_assert(claim::THREADS == 4 * CSW,
              "a claim strip is one full-res pixel a thread");

// Slot-major or K-minor low-res masks and the full-res theta they are
// binarized against: the claim kernel's planes.
struct ThetaPlanes {
  const float* m;
  Layout L;
  const float* theta;
  int h, w;
};

// The words of steps cbase .. cbase+nbits-1 (one video): "slot t of the
// chunk has up_t >= theta here".  A low-res row i of the block's run at a
// time, in strips of CSW low-res columns (4*CSW full-res pixels, one a
// thread): the chunk's four row phases of the strip's columns (and both
// halos) are staged from one read of rows i-1, i, i+1 (STAGE_U entries a
// thread with their loads issued together; neighbouring threads on
// neighbouring slots of K-minor masks, on neighbouring columns of
// slot-major ones); then each thread forms, for each of the strip's
// full-res rows 4i..4i+3 in the run, its pixel's column phase of every
// slot of the chunk with the plain version's arithmetic and compares it
// with theta (read once a chunk).
template <typename Word>
__device__ void bits_theta(const claim::Args& a, const claim::Block<Word>& s,
                           const ThetaPlanes& tp, int cbase, int nbits) {
  const int nb = min(nbits, s.cnt[0] - cbase);
  if (nb <= 0 || s.np == 0) return;
  const uint8_t* list = s.list + cbase;
  float* R = reinterpret_cast<float*>(s.stage);   // [nb][4][CSC]
  Word* wd = s.bits(0);
  const int W4 = 4 * tp.w;
  const bool slots_inner = tp.L.sk == 1;
  const float inv_nb = 1.0f / nb;   // (e + 0.5) * inv_nb: exact e / nb here
  const int p1 = s.p0 + s.np;
  for (int i = s.p0 / W4 / 4; 4 * i * W4 < p1; ++i) {
    const int ip = max(i - 1, 0);
    const int in = min(i + 1, tp.h - 1);
    // the run's pixels [q0, q1) in full-res rows 4i .. 4i+3: the low-res
    // columns of that part of one row, or all of them
    const int q0 = max(s.p0, 4 * i * W4);
    const int q1 = min(p1, 4 * (i + 1) * W4);
    const int y0 = q0 / W4, y1 = (q1 - 1) / W4;
    const int j_lo = y0 == y1 ? (q0 - y0 * W4) >> 2 : 0;
    const int j_hi = y0 == y1 ? ((q1 - 1 - y0 * W4) >> 2) + 1 : tp.w;
    for (int j0 = j_lo; j0 < j_hi; j0 += CSW) {
      __syncthreads();                     // the last strip's reads are done
      for (int e0 = threadIdx.x; e0 < nb * CSC; e0 += STAGE_U * blockDim.x) {
        float v[STAGE_U][3];
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u) {
          const int e = e0 + u * blockDim.x;
          if (e >= nb * CSC) continue;
          const int q = slots_inner ? (int)((e + 0.5f) * inv_nb) : e / CSC;
          const int t = slots_inner ? e - q * nb : q;
          const int c = slots_inner ? q : e - q * CSC;
          const int jj = min(max(j0 - 1 + c, 0), tp.w - 1);
          const float* mk =
              tp.m + (size_t)list[t] * tp.L.sk + (size_t)jj * tp.L.sc;
          v[u][0] = mk[(size_t)ip * tp.L.sr];
          v[u][1] = mk[(size_t)i * tp.L.sr];
          v[u][2] = mk[(size_t)in * tp.L.sr];
        }
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u) {
          const int e = e0 + u * blockDim.x;
          if (e >= nb * CSC) continue;
          const int q = slots_inner ? (int)((e + 0.5f) * inv_nb) : e / CSC;
          const int t = slots_inner ? e - q * nb : q;
          const int c = slots_inner ? q : e - q * CSC;
          float* r = R + (size_t)t * 4 * CSC + c;
#pragma unroll
          for (int pr = 0; pr < 4; ++pr)
            r[pr * CSC] = lerp_phase(pr, v[u][0], v[u][1], v[u][2]);
        }
      }
      __syncthreads();
      const int X = 4 * j0 + threadIdx.x;
      if (X >= W4) continue;
      const int jl = threadIdx.x >> 2;
      const ColPhase cp(threadIdx.x & 3);
#pragma unroll 1
      for (int pr = 0; pr < 4; ++pr) {
        const int pix = (4 * i + pr) * W4 + X;
        if (pix < s.p0 || pix >= p1) continue;
        const float th = tp.theta[pix];
        unsigned v = 0;
        for (int t = 0; t < nb; ++t) {
          const float* r = R + ((size_t)t * 4 + pr) * CSC + jl;
          if (mix(cp.wx, r[cp.xo], cp.wc, r[1]) >= th) v |= 1u << t;
        }
        wd[pix - s.p0] = (Word)v;
      }
    }
  }
  __syncthreads();
}

template <typename Word>
__global__ void __launch_bounds__(claim::THREADS, 1)
claim_kernel(claim::Args a, ThetaPlanes tp) {
  extern __shared__ __align__(16) unsigned char smem[];
  claim::run_groups<Word>(a, smem, [&](const claim::Block<Word>& s,
                                       int cbase, int nbits) {
    bits_theta(a, s, tp, cbase, nbits);
  });
}

cudaError_t set_smem(const void* fn, int K) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)staged_smem_bytes(K));
}

int launch_theta(const void* m, Layout L, const void* valid, float log_thr,
                 void* out, int K, int h, int w, void* stream) {
  dim3 grid((w + TH_CW - 1) / TH_CW, (h + TH_RB - 1) / TH_RB);
  theta_kernel<<<grid, TH_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(m), L, static_cast<const uint8_t*>(valid),
      log_thr, static_cast<float*>(out), K, h, w);
  return (int)cudaGetLastError();
}

// The claim loop over the valid thing slots in [lo, hi), in one
// cooperative launch of `blocks` blocks at the wrapper's claim_geometry
// (run full-res pixels a block, `chunk` slots a bits pass, the owner tile
// and the words in shared memory or not).  labels [K] int64, valid and
// thing [K] bool.  Writes owner [4h, 4w] and keep [K] bool; counts is 3K
// int32 (zeroed here); words holds 16hw rounded up to 16 words of 1, 2 or
// 4 bytes (by chunk) when they do not live in shared memory.
int claim_launch(const void* m, Layout L, const void* theta,
                 const void* labels, const void* valid, const void* thing,
                 float frac, int K, int h, int w, int lo, int hi, int blocks,
                 int run, int chunk, int own_smem, int bits_smem, void* owner,
                 void* keep, void* counts, void* words, void* stream) {
  const int HW = 16 * h * w;
  if (chunk < 1 || chunk > claim::MAX_CHUNK || run % 16 ||
      (long long)blocks * run < HW)
    return (int)cudaErrorInvalidValue;
  claim::Args a{};
  a.labels = static_cast<const int64_t*>(labels);
  a.valid = static_cast<const uint8_t*>(valid);
  a.thing = static_cast<const uint8_t*>(thing);
  a.frac = frac;
  a.B = 1;
  a.K = K;
  a.HW = HW;
  a.group = 1;
  a.lo = lo;
  a.hi = hi;
  a.run = run;
  a.chunk = chunk;
  a.own_smem = own_smem != 0;
  a.bits_smem = bits_smem != 0;
  a.stage_per_slot = (int)(sizeof(float) * 4 * CSC);
  a.owner = static_cast<int8_t*>(owner);
  a.keep = static_cast<uint8_t*>(keep);
  a.counts = static_cast<int32_t*>(counts);
  a.words = words;
  a.words_stride = ((size_t)HW + 15) / 16 * 16;
  const ThetaPlanes tp{static_cast<const float*>(m), L,
                       static_cast<const float*>(theta), h, w};
  const void* kernel = chunk <= 8    ? (const void*)claim_kernel<uint8_t>
                       : chunk <= 16 ? (const void*)claim_kernel<uint16_t>
                                     : (const void*)claim_kernel<uint32_t>;
  return (int)claim::launch(kernel, a, blocks, (cudaStream_t)stream, &tp);
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

// The claim loop over the valid thing slots in [lo, hi): one launch (see
// claim_launch).
extern "C" int pp_claim(const void* m, const void* theta, const void* labels,
                        const void* valid, const void* thing, float frac,
                        int K, int h, int w, int lo, int hi, int blocks,
                        int run, int chunk, int own_smem, int bits_smem,
                        void* owner, void* keep, void* counts, void* words,
                        void* stream) {
  return claim_launch(m, slot_major(K, h, w), theta, labels, valid, thing,
                      frac, K, h, w, lo, hi, blocks, run, chunk, own_smem,
                      bits_smem, owner, keep, counts, words, stream);
}

extern "C" int pp_claim_hwk(const void* m, const void* theta,
                            const void* labels, const void* valid,
                            const void* thing, float frac, int K, int h,
                            int w, int lo, int hi, int blocks, int run,
                            int chunk, int own_smem, int bits_smem,
                            void* owner, void* keep, void* counts,
                            void* words, void* stream) {
  return claim_launch(m, k_minor(K, h, w), theta, labels, valid, thing, frac,
                      K, h, w, lo, hi, blocks, run, chunk, own_smem,
                      bits_smem, owner, keep, counts, words, stream);
}

// Shared memory of one block of the claim kernel at this geometry (the
// wrapper's claim_smem must say the same).
extern "C" long long pp_claim_smem(int K, int run, int chunk, int own_smem,
                                   int bits_smem) {
  return (long long)claim::claim_smem_bytes(1, K, run, chunk, own_smem != 0,
                                            bits_smem != 0,
                                            (int)(sizeof(float) * 4 * CSC));
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
