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
//   argmax needs the kept stuff slots' masks, a kept thing's mask only
//          under the pixels it owns (elsewhere a thing counts 0.0), and the
//          owner map, and writes m_id (8.4 MB) and per-tile areas: ~0.005
//          ms of bytes at K = 64 (10 kept stuff slots, 29 kept things), the
//          larger bound.  So the kernel stages and visits only the kept
//          stuff slots (the tiled shape below) and forms a pixel's one
//          thing value, its owner's, from the owner's rows in global
//          memory.
//          With top2 it keeps the best two entries and writes the runner-up
//          m2_id (8.4 MB more).  Areas: a shared histogram, one atomic a
//          warp where its 128 pixels hold one id, one global atomic per
//          slot a block.  At K = 64, 40 valid (kernel_variants.py argmax,
//          H100 at 700 W): 0.037 ms, of which the staging and the fixed
//          work of a block (the lists, the owner map, the stores) ~0.031
//          with no pass, the owner's upsample ~0.010, the areas ~0.003;
//          top2 0.055, the K-minor entry at 100 valid 0.108 (its reads: a
//          pixel's 100 slots lie in one 400-byte record).
//          The earlier kernel (a block a low-res row, all K slots staged
//          and visited with selects, one atomic per slot per block) took
//          0.137 ms, top2 0.239, K-minor 0.215.
//   hist   reads an int32 id map once (8.4 MB) and writes K counts: ~2.5 us
//          of bytes.  A thread owns 16 contiguous ids and issues its four
//          16-byte loads before it uses any; a warp whose 512 ids are one
//          id makes one shared atomic, otherwise a thread one per run of
//          equal ids; one wave of blocks, one global atomic per slot a
//          block; the C entry zeroes the counts.  Alone at 2 MP, K = 64
//          (kernel_variants.py hist, H100 at 700 W): an argmax map 0.0043
//          ms, one id 0.0029, random ids 0.0050 (K = 4096: 0.0097); the
//          earlier kernel (4 ids a thread a step, four __match_any_sync,
//          at most 1024 blocks) took 0.0073 / 0.0038 / 0.0159 / 0.0257.
//   repair is argmax on the dirty tiles only; clean tiles copy m1 and their
//          area row through (typically 1-2 of 32 tiles are dirty, so the
//          copy, 16.8 MB of traffic, ~5 us, is most of its bound).
//          Launched over all tiles with an early copy-and-return on clean
//          ones: no compacted tile list, no extra host sync.  0.013 ms with
//          2 of 32 tiles dirty (0.026 before).
//   sseg   reads the [h, w, 19] logits once (10 MB) and writes the int64
//          map (16.8 MB): 0.008 ms of bytes; its pass, ~6 instructions a
//          (pixel, channel), is about as long at full issue.  The tiled
//          shape with every channel staged in one chunk: 0.026 ms (0.034
//          before), no pass 0.019: a block's staging, pass and stores run
//          in turn, and 5 blocks an SM do not hide that.
// The K-minor entries run the same kernels with other strides.  theta,
// argmax and the claim's bits pass stage a block's low-res rows with
// neighbouring threads on neighbouring slots (the slots of a pixel are
// contiguous), so their bounds are the slot-major ones.  argmax's areas are
// the whole map's: one row tile of h low-res rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "claim_loop.cuh"

namespace {

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

// The four column phases of one staged row phase: x = its values at the
// low-res columns jl-1, jl, jl+1.
__device__ __forceinline__ void col_phases(const float* x, float v[4]) {
  const float x0 = x[0], x1 = x[1], x2 = x[2];
  v[0] = mix(0.375f, x0, 0.625f, x1);
  v[1] = mix(0.125f, x0, 0.875f, x1);
  v[2] = mix(0.125f, x2, 0.875f, x1);
  v[3] = mix(0.375f, x2, 0.625f, x1);
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

// The tiled kernels (theta, argmax / repair, sseg): a block owns RB low-res
// rows i0 .. i0+RB-1 x CW low-res columns j0 .., a thread one (block row,
// row phase, low-res column): the four full-res pixels of that column's
// phases, read and written as one 4- or 16-byte word each.  Warp = one
// (row, phase) of 32 columns.  The slots a kernel needs (theta the valid
// ones, argmax the kept stuff slots, sseg every channel) are staged CH at
// a time: each (slot, column, halo column) of rows i0-1 .. i0+RB (clamped)
// is read once into registers, and the row phases of each block row go to
// shared memory; run_chunks() reads the next chunk's rows before the pass
// over the current chunk, so those loads land during its arithmetic.
constexpr int CW = 32;          // low-res columns a block
constexpr int SCW = CW + 2;     // staged columns, both halos

template <int RB, int CH>
struct Stager {
  static constexpr int THREADS = 4 * RB * CW;
  static constexpr int UNITS = (CH * SCW + THREADS - 1) / THREADS;
  using Tile = float[CH][RB][4][SCW];   // [slot][block row][phase][column]

  const float* m;
  Layout L;
  int j0, w;
  size_t rows[RB + 2];
  float raw[UNITS][RB + 2];

  __device__ Stager(const float* m_, Layout L_, int i0, int j0_, int h,
                    int w_)
      : m(m_), L(L_), j0(j0_), w(w_) {
#pragma unroll
    for (int a = 0; a < RB + 2; ++a)
      rows[a] = (size_t)min(max(i0 - 1 + a, 0), h - 1) * L.sr;
  }

  // staging unit e of a chunk of nc slots: (slot t of the chunk, column c);
  // neighbouring threads on neighbouring columns of slot-major masks, on
  // neighbouring slots of K-minor ones
  __device__ void unit(int e, int nc, int& t, int& c) const {
    const bool slots_inner = L.sk == 1;
    t = slots_inner ? e % nc : e / SCW;
    c = slots_inner ? e / nc : e % SCW;
  }

  // the raw rows of the chunk's slots list[c0 .. c0+nc-1] (slots c0 ..
  // without a list)
  __device__ void load(const uint8_t* list, int c0, int nc) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e >= nc * SCW) continue;
      int t, c;
      unit(e, nc, t, c);
      const int k = list ? list[c0 + t] : c0 + t;
      const int jj = min(max(j0 - 1 + c, 0), w - 1);
      const float* mk = m + (size_t)k * L.sk + (size_t)jj * L.sc;
#pragma unroll
      for (int a = 0; a < RB + 2; ++a) raw[u][a] = mk[rows[a]];
    }
  }

  __device__ void store(Tile& R, int nc) const {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e >= nc * SCW) continue;
      int t, c;
      unit(e, nc, t, c);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          R[t][r][p][c] = lerp_phase(p, raw[u][r], raw[u][r + 1],
                                     raw[u][r + 2]);
    }
  }
};

// The block's n listed slots, CH at a time, double-buffered in R:
// pass(R, c0, nc) over each chunk.  Every thread of the block calls it;
// it ends with __syncthreads().
template <int RB, int CH, class Pass>
__device__ void run_chunks(Stager<RB, CH>& st,
                           typename Stager<RB, CH>::Tile* R,
                           const uint8_t* list, int n, Pass pass) {
  const int n_chunks = (n + CH - 1) / CH;
  if (n_chunks > 0) {
    st.load(list, 0, min(CH, n));
    st.store(R[0], min(CH, n));
  }
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int nc = min(CH, n - ch * CH);
    const int nc_next = min(CH, n - (ch + 1) * CH);
    if (nc_next > 0) st.load(list, (ch + 1) * CH, nc_next);
    pass(R[ch & 1], ch * CH, nc);
    if (nc_next > 0) st.store(R[(ch + 1) & 1], nc_next);
    __syncthreads();
  }
}

// Rows a block of the argmax / repair and sseg kernels: 2 when that
// divides the row tile hb (so a block never spans two tiles), else 1; the
// grid is (ceil(w / CW), h / rows).  ops/cuda/postproc_v3.py
// tiled_geometry says the same.
__host__ __device__ inline int tiled_rows(int hb) {
  return hb % 2 == 0 ? 2 : 1;
}

// The threads with f set, in thread order (a ballot in each warp, no host
// sync): list[0 .. n-1] = their indices (slots k < K <= 127: thread k
// passes f for slot k), and n.  Ends with __syncthreads().
template <int THREADS>
__device__ int list_slots(bool f, uint8_t* list, int* cnt) {
  const int tid = threadIdx.x;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  if ((tid & 31) == 0) cnt[tid >> 5] = __popc(bal);
  __syncthreads();
  int n = 0, pos = __popc(bal & ((1u << (tid & 31)) - 1));
  for (int wi = 0; wi < THREADS / 32; ++wi) {
    if (wi < (tid >> 5)) pos += cnt[wi];
    n += cnt[wi];
  }
  if (f) list[pos] = (uint8_t)tid;
  __syncthreads();
  return n;
}

// theta: the valid slots listed, staged TH_CH at a time, each thread forms
// the four column phases of each staged slot with the plain version's
// arithmetic and folds each into a running max and sum of exp in one
// pass: z = z * exp(mx - v) + 1 where v is a new max, else z + exp(v -
// mx), one expf a (pixel, slot).  The grid covers h rounded up to TH_RB.
constexpr int TH_RB = 2;                     // low-res rows a block
constexpr int TH_CH = 16;                    // valid slots staged at a time
using ThetaStager = Stager<TH_RB, TH_CH>;

__global__ void __launch_bounds__(ThetaStager::THREADS, 4)
theta_kernel(const float* __restrict__ m, Layout L,
             const uint8_t* __restrict__ valid, float log_thr,
             float* __restrict__ out, int K, int h, int w) {
  constexpr int NT = ThetaStager::THREADS;
  __shared__ ThetaStager::Tile R[2];
  __shared__ uint8_t s_list[128];
  __shared__ int s_cnt[NT / 32];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * TH_RB;
  const int j0 = blockIdx.x * CW;
  const int n_valid = list_slots<NT>(tid < K && valid[tid], s_list, s_cnt);
  ThetaStager st(m, L, i0, j0, h, w);

  const int jl = tid % CW;
  const int pr = (tid / CW) & 3;
  const int r = tid / (4 * CW);
  const bool inside = i0 + r < h && j0 + jl < w;
  float mx[4], z[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mx[c] = NEG;   // with no valid slot theta stays at about -1e30
    z[c] = 0.f;
  }
  run_chunks(st, R, s_list, n_valid,
             [&](ThetaStager::Tile& Rt, int, int nc) {
               if (!inside) return;
#pragma unroll 4
               for (int t = 0; t < nc; ++t) {
                 float v[4];
                 col_phases(&Rt[t][r][pr][jl], v);
#pragma unroll
                 for (int c = 0; c < 4; ++c) {
                   const float d = v[c] - mx[c];
                   const float e = expf(-fabsf(d));
                   z[c] = d > 0.f ? fmaf(z[c], e, 1.f) : z[c] + e;
                   mx[c] = fmaxf(mx[c], v[c]);
                 }
               }
             });
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

// argmax / repair.  The plain version takes, at each pixel, the first slot
// holding the max of: the upsampled value of each kept stuff slot; of each
// kept thing slot, its upsampled value where it owns the pixel, else 0.0;
// -1e30 for each slot not kept.  So the kernel stages and visits the kept
// stuff slots only, in slot order, with a strict '>' (the first slot
// holding the max stays), and adds the few other candidates a pixel has,
// each by a total order (value, then lower index): the owner, when it is
// a kept thing, with its upsampled value (computed for that one slot from
// its rows in global memory, read before the staged pass where a thread's
// four pixels have one owner); the first kept thing that is not the owner
// at 0.0; the first slot not kept at -1e30.  The runner-up (TOP2) is the
// first slot holding the max once the winner's value is -1e30: the kernel
// keeps the best two entries (the stuff pass, the owner, the first two
// kept things that are not the owner at 0.0, the first two slots not kept
// at -1e30), then takes the second or the winner at -1e30, whichever
// comes first.  Per-tile areas (a block lies in one row tile): each warp
// adds its ids to a shared histogram, one atomic for the warp where its
// 128 pixels hold one id, else one per distinct id and pixel phase
// (__match_any_sync); the block adds one global atomic per slot it holds;
// the areas are zeroed by the C entry.  REPAIR: a block of a clean tile
// copies m1 (and, the block of its first rows and columns, its area row)
// and returns.
constexpr int AM_CH = 16;                    // kept stuff slots staged at a time
enum { AM_ARGMAX = 0, AM_TOP2 = 1, AM_REPAIR = 2 };

struct ArgmaxArgs {
  const float* m;
  Layout L;
  const int8_t* owner;
  const uint8_t* kept;
  const uint8_t* is_thing;
  const uint8_t* dirty;        // REPAIR: [T] tiles to recompute
  const int32_t* m1;           // REPAIR: the previous map
  const int32_t* areas_prev;   // REPAIR: its [T, K] areas
  int32_t* m_id;
  int32_t* m2_id;              // TOP2: the runner-up map
  int32_t* areas;              // [T, K]
  int K, h, w, hb;
};

// (v, i) before (bv, bi): a higher value, or the same value at a lower
// index; bi == K is "no entry yet", which any entry is before.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi,
                                       int K) {
  return bi == K || v > bv || (v == bv && i < bi);
}

// The first N set bits of the four words bits[0 .. 3] (K: none; no bit
// at K or above is set), without indexing registers at run time.
template <int N>
__device__ void first_bits(const unsigned* bits, int K, int (&out)[N]) {
  unsigned w[4];
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) w[wi] = bits[wi];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    out[j] = K;
#pragma unroll
    for (int wi = 3; wi >= 0; --wi)
      if (w[wi]) out[j] = wi * 32 + __ffs(w[wi]) - 1;
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
      if (out[j] >> 5 == wi) w[wi] &= w[wi] - 1;
  }
}

template <int RB, int MODE>
__global__ void __launch_bounds__(4 * RB * CW)
argmax_kernel(ArgmaxArgs a) {
  constexpr bool TOP2 = MODE == AM_TOP2;
  using St = Stager<RB, AM_CH>;
  using Tile = typename St::Tile;
  constexpr int NT = St::THREADS;
  __shared__ Tile R[2];
  __shared__ uint8_t s_list[128];
  __shared__ int s_cnt[NT / 32];
  __shared__ unsigned s_out[4], s_thing[4];   // not kept; kept things
  __shared__ int hist[128];
  const int tid = threadIdx.x;
  const int K = a.K;
  const int i0 = blockIdx.y * RB;
  const int j0 = blockIdx.x * CW;
  const int t_row = i0 / a.hb;
  const int jl = tid % CW;
  const int pr = (tid / CW) & 3;
  const int r = tid / (4 * CW);
  const int i = i0 + r, j = j0 + jl;
  const bool inside = j < a.w;
  const size_t pix = (size_t)(4 * i + pr) * (4 * (size_t)a.w) + 4 * (size_t)j;

  if (MODE == AM_REPAIR && !a.dirty[t_row]) {
    // no pixel of this tile had its winner removed: the argmax over a
    // subset that still holds the max is unchanged
    if (inside)
      *reinterpret_cast<int4*>(a.m_id + pix) =
          *reinterpret_cast<const int4*>(a.m1 + pix);
    if (blockIdx.x == 0 && i0 % a.hb == 0)
      for (int k = tid; k < K; k += NT)
        a.areas[(size_t)t_row * K + k] = a.areas_prev[(size_t)t_row * K + k];
    return;
  }

  const int o4 = inside ? *reinterpret_cast<const int*>(a.owner + pix) : -1;
  for (int k = tid; k < 128; k += NT) hist[k] = 0;
  const bool kept = tid < K && a.kept[tid];
  const bool thing = tid < K && a.is_thing[tid];
  const unsigned out_bal = __ballot_sync(0xffffffffu, tid < K && !kept);
  const unsigned thing_bal = __ballot_sync(0xffffffffu, kept && thing);
  if ((tid & 31) == 0 && tid < 128) {
    s_out[tid >> 5] = out_bal;
    s_thing[tid >> 5] = thing_bal;
  }
  const int n_stuff = list_slots<NT>(kept && !thing, s_list, s_cnt);
  int out_slots[2], things[3];   // the first slots not kept, kept things
  first_bits(s_out, K, out_slots);
  first_bits(s_thing, K, things);
  auto kept_thing = [&](int o) {
    return o >= 0 && (s_thing[o >> 5] >> (o & 31) & 1);
  };

  // a thing's upsampled value at the four pixels: its rows i-1 .. i+1 at
  // columns j-1 .. j+1 (clamped), row phase pr, then the column phases,
  // as staged values are formed; read before the staged pass where the
  // four pixels have one owner, a kept thing
  auto owner_rows = [&](int o, float (&raw)[3][3]) {
    const float* mo = a.m + (size_t)o * a.L.sk;
    const size_t rw[3] = {(size_t)max(i - 1, 0) * a.L.sr,
                          (size_t)i * a.L.sr,
                          (size_t)min(i + 1, a.h - 1) * a.L.sr};
    const size_t cl[3] = {(size_t)max(j - 1, 0) * a.L.sc,
                          (size_t)j * a.L.sc,
                          (size_t)min(j + 1, a.w - 1) * a.L.sc};
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) raw[p][q] = __ldg(mo + rw[p] + cl[q]);
  };
  auto owner_value = [&](const float (&raw)[3][3], float (&v)[4]) {
    float x[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      x[q] = lerp_phase(pr, raw[0][q], raw[1][q], raw[2][q]);
    col_phases(x, v);
  };
  const int o0 = (int)(int8_t)o4;
  const bool pre = inside && kept_thing(o0) &&
                   o4 == (int)((unsigned)(o4 & 0xff) * 0x01010101u);
  float raw_o[3][3];
  if (pre) owner_rows(o0, raw_o);

  St st(a.m, a.L, i0, j0, a.h, a.w);
  float b1[4], b2[4];
  int i1[4], i2[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    b1[c] = b2[c] = -INFINITY;
    // the first kept stuff slot holds its place at -inf
    i1[c] = TOP2 || n_stuff == 0 ? K : s_list[0];
    i2[c] = K;
  }
  run_chunks(st, R, s_list, n_stuff, [&](Tile& Rt, int c0, int nc) {
    if (!inside) return;
#pragma unroll 4
    for (int t = 0; t < nc; ++t) {
      const int k = s_list[c0 + t];
      float v[4];
      col_phases(&Rt[t][r][pr][jl], v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (TOP2) {
          if (i1[c] == K || v[c] > b1[c]) {
            b2[c] = b1[c];
            i2[c] = i1[c];
            b1[c] = v[c];
            i1[c] = k;
          } else if (i2[c] == K || v[c] > b2[c]) {
            b2[c] = v[c];
            i2[c] = k;
          }
        } else if (v[c] > b1[c]) {
          b1[c] = v[c];
          i1[c] = k;
        }
      }
    }
  });

  int last = -1;   // the slot whose upsampled values v holds
  float v[4];
  if (pre) {
    owner_value(raw_o, v);
    last = o0;
  }
  int id[4], id2[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    auto insert = [&](float cv, int ci) {
      if (before(cv, ci, b1[c], i1[c], K)) {
        if (TOP2) {
          b2[c] = b1[c];
          i2[c] = i1[c];
        }
        b1[c] = cv;
        i1[c] = ci;
      } else if (TOP2 && before(cv, ci, b2[c], i2[c], K)) {
        b2[c] = cv;
        i2[c] = ci;
      }
    };
    const int o = (int)(int8_t)(o4 >> (8 * c));
    if (inside && kept_thing(o)) {
      if (o != last) {
        owner_rows(o, raw_o);
        owner_value(raw_o, v);
        last = o;
      }
      insert(v[c], o);
    }
    // the kept things that are not the owner count 0.0: the first (and
    // for the runner-up the second) of them
    const int f = things[0] == o ? things[1] : things[0];
    if (f < K) insert(0.f, f);
    if (TOP2) {
      const int g = things[0] == o || things[1] == o ? things[2] : things[1];
      if (g < K) insert(0.f, g);
    }
    if (out_slots[0] < K) insert(NEG, out_slots[0]);
    if (TOP2 && out_slots[1] < K) insert(NEG, out_slots[1]);
    id[c] = i1[c];
    // the runner-up: the second entry, or the winner at -1e30
    if (TOP2) id2[c] = before(NEG, id[c], b2[c], i2[c], K) ? id[c] : i2[c];
  }
  if (inside) {
    *reinterpret_cast<int4*>(a.m_id + pix) =
        make_int4(id[0], id[1], id[2], id[3]);
    if (TOP2)
      *reinterpret_cast<int4*>(a.m2_id + pix) =
          make_int4(id2[0], id2[1], id2[2], id2[3]);
  }
  // the warp's ids into the shared histogram: one atomic where its 128
  // pixels hold one id, else one per distinct id and pixel phase
  const bool four = inside && id[1] == id[0] && id[2] == id[0] &&
                    id[3] == id[0];
  int one;
  __match_all_sync(0xffffffffu, four ? id[0] : -1, &one);
  if (one && four) {
    if ((tid & 31) == 0) atomicAdd(&hist[id[0]], 128);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int v = inside ? id[c] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, v);
      if (v >= 0 && (tid & 31) == __ffs(peers) - 1)
        atomicAdd(&hist[v], __popc(peers));
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += NT)
    if (hist[k]) atomicAdd(&a.areas[(size_t)t_row * K + k], hist[k]);
}

// Per-slot pixel counts of an int32 id map of n entries (ids outside
// [0, K) are not counted).  A thread owns HN = 16 contiguous ids a step and
// issues its four 16-byte loads before it uses any of them.  A warp whose
// 512 ids are all one id makes one shared atomic; otherwise each thread
// walks its 16 ids and makes one shared atomic per run of equal ids (an
// id map is mostly long runs of one id).  Each block then adds its
// histogram with one global atomic per slot it saw.  The grid is at most
// one wave (hist_wave), so a thread takes one step at 2 MP; every thread
// of a block runs the same number of steps, so every lane takes part in
// the __match_all_sync.
constexpr int HV = 4;          // 16-byte loads a thread issues at once
constexpr int HN = 4 * HV;     // ids a thread owns a step
constexpr int HIST_MAX_K = 4096;

__global__ void __launch_bounds__(HT)
hist_kernel(const int32_t* __restrict__ m_id, long long n, int K,
            int32_t* __restrict__ areas) {
  extern __shared__ int hist[];
  for (int k = threadIdx.x; k < K; k += HT) hist[k] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * HT * HN;
  for (long long base = (long long)blockIdx.x * HT * HN; base < n;
       base += step) {
    const long long i = base + (long long)threadIdx.x * HN;
    int ids[HN];
    if (i + HN <= n) {
      const int4* src = reinterpret_cast<const int4*>(m_id + i);
      int4 v[HV];
#pragma unroll
      for (int j = 0; j < HV; ++j) v[j] = src[j];
#pragma unroll
      for (int j = 0; j < HV; ++j) {
        ids[4 * j] = v[j].x;
        ids[4 * j + 1] = v[j].y;
        ids[4 * j + 2] = v[j].z;
        ids[4 * j + 3] = v[j].w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < HN; ++c) ids[c] = i + c < n ? m_id[i + c] : -1;
    }
    // ids outside [0, K) (and the padding past n) become -1: not counted
    bool same = true;
#pragma unroll
    for (int c = 0; c < HN; ++c) {
      ids[c] = (unsigned)ids[c] < (unsigned)K ? ids[c] : -1;
      same = same && ids[c] == ids[0];
    }
    // -1 stands for "not one counted id": a warp matches on v >= 0 only
    // when every lane holds 16 of that id
    const int v = same ? ids[0] : -1;
    int one;
    __match_all_sync(0xffffffffu, v, &one);
    if (one && v >= 0) {
      if ((threadIdx.x & 31) == 0) atomicAdd(&hist[v], 32 * HN);
    } else {
      int cur = ids[0], cnt = 1;
#pragma unroll
      for (int c = 1; c < HN; ++c) {
        if (ids[c] == cur) {
          ++cnt;
        } else {
          if (cur >= 0) atomicAdd(&hist[cur], cnt);
          cur = ids[c];
          cnt = 1;
        }
      }
      if (cur >= 0) atomicAdd(&hist[cur], cnt);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += HT)
    if (hist[k]) atomicAdd(&areas[k], hist[k]);
}

// Blocks of one wave of hist_kernel on the current device (its SMs times
// the blocks an SM holds at K = HIST_MAX_K), computed once per device.
cudaError_t hist_wave(int* wave) {
  constexpr int N_DEV = 64;
  static int cache[N_DEV];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  if (dev < N_DEV && cache[dev]) {
    *wave = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist_kernel, HT, sizeof(int) * (size_t)HIST_MAX_K);
  if (err != cudaSuccess) return err;
  *wave = std::max(1, sms * per_sm);
  if (dev < N_DEV) cache[dev] = *wave;
  return cudaSuccess;
}

// hist_kernel's grid for n ids and a wave of `wave` blocks.
long long hist_blocks(long long n, int wave) {
  const long long per_block = (long long)HT * HN;
  return std::max(1LL, std::min((long long)wave,
                                (n + per_block - 1) / per_block));
}

// The semantic map: per full-res pixel, the first channel holding the max
// of the x4-upsampled logits (torch.argmax's tie rule; the TPU kernel's
// `vals >= mx` then min index).  x is NHWC [h, w, C] f32; the argmax
// kernel's blocks with every channel listed, SG_CH at a time (Cityscapes'
// 19 in one chunk); the four int64 ids of a thread go out as two 16-byte
// stores.
constexpr int SG_CH = 20;

template <int RB>
__global__ void __launch_bounds__(4 * RB * CW)
sseg_kernel(const float* __restrict__ x, int64_t* __restrict__ out, int C,
            int h, int w) {
  using St = Stager<RB, SG_CH>;
  using Tile = typename St::Tile;
  __shared__ Tile R[2];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * RB;
  const int j0 = blockIdx.x * CW;
  const int jl = tid % CW;
  const int pr = (tid / CW) & 3;
  const int r = tid / (4 * CW);
  const bool inside = j0 + jl < w;
  St st(x, k_minor(C, h, w), i0, j0, h, w);
  float best[4];
  int id[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    best[c] = -INFINITY;   // channel 0 is taken first
    id[c] = 0;
  }
  run_chunks(st, R, nullptr, C, [&](Tile& Rt, int c0, int nc) {
    if (!inside) return;
#pragma unroll 4
    for (int t = 0; t < nc; ++t) {
      float v[4];
      col_phases(&Rt[t][r][pr][jl], v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (v[c] > best[c]) {                // ties -> first channel
          best[c] = v[c];
          id[c] = c0 + t;
        }
    }
  });
  if (!inside) return;
  longlong2* o = reinterpret_cast<longlong2*>(
      out + (size_t)(4 * (i0 + r) + pr) * (4 * (size_t)w) + 4 * (j0 + jl));
  o[0] = make_longlong2(id[0], id[1]);
  o[1] = make_longlong2(id[2], id[3]);
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
      const int pc = threadIdx.x & 3;   // the pixel's column phase
      const float wx = phase_wx(pc), wc = phase_wc(pc);
      const int xo = pc < 2 ? 0 : 2;    // its outer staged column
#pragma unroll 1
      for (int pr = 0; pr < 4; ++pr) {
        const int pix = (4 * i + pr) * W4 + X;
        if (pix < s.p0 || pix >= p1) continue;
        const float th = tp.theta[pix];
        unsigned v = 0;
        for (int t = 0; t < nb; ++t) {
          const float* r = R + ((size_t)t * 4 + pr) * CSC + jl;
          if (mix(wx, r[xo], wc, r[1]) >= th) v |= 1u << t;
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

int launch_theta(const void* m, Layout L, const void* valid, float log_thr,
                 void* out, int K, int h, int w, void* stream) {
  dim3 grid((w + CW - 1) / CW, (h + TH_RB - 1) / TH_RB);
  theta_kernel<<<grid, ThetaStager::THREADS, 0, (cudaStream_t)stream>>>(
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

template <int MODE>
int launch_argmax_mode(const ArgmaxArgs& a, cudaStream_t stream) {
  const int rb = tiled_rows(a.hb);
  const dim3 grid((a.w + CW - 1) / CW, a.h / rb);
  if (rb == 2)
    argmax_kernel<2, MODE><<<grid, 4 * 2 * CW, 0, stream>>>(a);
  else
    argmax_kernel<1, MODE><<<grid, 4 * CW, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Zeroes the [h / hb, K] areas, then one launch: repair with a.dirty,
// the runner-up too with a.m2_id, else the argmax.
int launch_argmax(const ArgmaxArgs& a, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      a.areas, 0, sizeof(int32_t) * (size_t)(a.h / a.hb) * a.K, s);
  if (err != cudaSuccess) return (int)err;
  if (a.dirty != nullptr) return launch_argmax_mode<AM_REPAIR>(a, s);
  return a.m2_id != nullptr ? launch_argmax_mode<AM_TOP2>(a, s)
                            : launch_argmax_mode<AM_ARGMAX>(a, s);
}

ArgmaxArgs argmax_args(const void* m, Layout L, const void* owner,
                       const void* kept, const void* is_thing, void* m_id,
                       void* m2_id, void* areas, int K, int h, int w,
                       int hb) {
  ArgmaxArgs a{};
  a.m = static_cast<const float*>(m);
  a.L = L;
  a.owner = static_cast<const int8_t*>(owner);
  a.kept = static_cast<const uint8_t*>(kept);
  a.is_thing = static_cast<const uint8_t*>(is_thing);
  a.m_id = static_cast<int32_t*>(m_id);
  a.m2_id = static_cast<int32_t*>(m2_id);
  a.areas = static_cast<int32_t*>(areas);
  a.K = K;
  a.h = h;
  a.w = w;
  a.hb = hb;
  return a;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() as an
// int (0 = launched).  The Python wrapper checks shapes, types, contiguity,
// 16-byte alignment of the full-res maps and K <= 127, and allocates every
// output (and zeroes those said to be zeroed by the caller).  The
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

// m_id [4h, 4w] int32, areas [T, K] int32 (zeroed here) and, when m2_id
// is not null, the runner-up map [4h, 4w] int32.
extern "C" int pp_argmax(const void* m, const void* owner, const void* kept,
                         const void* is_thing, void* m_id, void* m2_id,
                         void* areas, int K, int h, int w, int hb,
                         void* stream) {
  return launch_argmax(argmax_args(m, slot_major(K, h, w), owner, kept,
                                   is_thing, m_id, m2_id, areas, K, h, w, hb),
                       stream);
}

// m_id [4h, 4w] int32 and the whole map's areas [K] int32 (zeroed here):
// one row tile of h low-res rows.
extern "C" int pp_argmax_hwk(const void* m, const void* owner,
                             const void* kept, const void* is_thing,
                             void* m_id, void* areas, int K, int h, int w,
                             void* stream) {
  return launch_argmax(argmax_args(m, k_minor(K, h, w), owner, kept,
                                   is_thing, m_id, nullptr, areas, K, h, w,
                                   h),
                       stream);
}

// One small-area-filter iteration; areas [T, K] int32 (zeroed here).
extern "C" int pp_repair(const void* m, const void* owner, const void* m1,
                         const void* kept, const void* is_thing,
                         const void* dirty, const void* areas_prev,
                         void* m_id, void* areas, int K, int h, int w, int hb,
                         void* stream) {
  ArgmaxArgs a = argmax_args(m, slot_major(K, h, w), owner, kept, is_thing,
                             m_id, nullptr, areas, K, h, w, hb);
  a.dirty = static_cast<const uint8_t*>(dirty);
  a.m1 = static_cast<const int32_t*>(m1);
  a.areas_prev = static_cast<const int32_t*>(areas_prev);
  return launch_argmax(a, stream);
}

// The launch geometry of the argmax / repair and sseg kernels for h x w
// low-res rows and row tiles of hb rows: out = (rows a block, grid x,
// grid y).
extern "C" void pp_tiled_geometry(int h, int w, int hb, int* out) {
  out[0] = tiled_rows(hb);
  out[1] = (w + CW - 1) / CW;
  out[2] = h / out[0];
}

// Per-slot counts areas [K] int32 (zeroed here) of an int32 id map of n
// entries, 16-byte aligned, 1 <= K <= 4096 (16 KB of shared memory a
// block: no attribute needed); one wave of blocks at most, each looping.
extern "C" int pp_hist(const void* m_id, long long n, int K, void* areas,
                       void* stream) {
  if (K < 1 || K > HIST_MAX_K) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(areas, 0, sizeof(int32_t) * (size_t)K, s);
  int wave = 0;
  if (err == cudaSuccess) err = hist_wave(&wave);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)hist_blocks(n, wave);
  hist_kernel<<<blocks, HT, sizeof(int) * (size_t)K, s>>>(
      static_cast<const int32_t*>(m_id), n, K, static_cast<int32_t*>(areas));
  return (int)cudaGetLastError();
}

// The semantic map [4h, 4w] int64 of NHWC logits x [h, w, C] f32.
extern "C" int pp_sseg(const void* x, void* out, int C, int h, int w,
                       void* stream) {
  const int rb = tiled_rows(h);
  const dim3 grid((w + CW - 1) / CW, h / rb);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xs = static_cast<const float*>(x);
  int64_t* o = static_cast<int64_t*>(out);
  if (rb == 2)
    sseg_kernel<2><<<grid, 4 * 2 * CW, 0, s>>>(xs, o, C, h, w);
  else
    sseg_kernel<1><<<grid, 4 * CW, 0, s>>>(xs, o, C, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* pp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
