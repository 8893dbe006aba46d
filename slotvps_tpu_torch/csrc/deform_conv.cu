// Deformable convolution v1 (3x3, stride 1, pad 1) for Hopper, forward and
// backward, in f32 and in bf16.
//
// Replaces the TPU kernels of slotvps_tpu/ops/pallas/deform_conv.py: the
// forward _dcn_kernel (deform_conv2d_pallas with compute_dtype=float32, and
// with the default bfloat16) and the backward _dcn_bwd_kernel (the custom
// VJP's _backward_impl).  The forward computes exactly what
// slotvps_tpu_torch/ops/deform_conv.py:deform_conv2d computes at the same
// halo and compute_dtype:
//   * sampling position of tap k = rigid position + (dy, dx) from
//     offset[..., 2k], offset[..., 2k+1] (f32: the bf16 model's bf16 offsets
//     are widened exactly by the wrapper, as the Pallas kernel does);
//   * a tap contributes iff the UNCLAMPED position lies in (-1, H) x (-1, W)
//     (the CUDA deformable_im2col rule);
//   * the bilinear sample is taken at the position clamped to rigid +- halo;
//   * bilinear corners outside the image read 0 (checked per corner here,
//     so no padded copy of x is needed).
// In bf16 the Pallas kernel's three rounding points are kept: each corner
// weight is formed in f32 and rounded to bf16, each sample is the f32 sum
// of bf16 weight x bf16 input rounded to bf16, and the output is the f32
// sum over taps and channels of bf16 sample x bf16 weight, written as f32
// (an f32 model: no rounding, as the Pallas kernel writes x.dtype) or
// rounded to bf16 (a bf16 model).
// Layouts: x [B, H, W, Cin] (NHWC), offset [B, H, W, 18] f32, weight
// [3, 3, Cin, Cout], out [B, H, W, Cout]; x and weight in the compute
// dtype; all contiguous.
//
// What bounds the forward on the card.  One 1024x2048 frame runs it 12
// times (3 tower blocks x 4 FPN levels), 174,080 output pixels x ~2.06
// MFLOP = ~0.36 TFLOP: 5.4 ms of f32 FMA at 67 TFLOP/s, 0.36 ms of bf16
// tensor-core work at 989 TFLOP/s.  In bf16, with the contraction on the
// tensor cores, what is left is the gather: 9 taps x 4 corners x Cin bf16
// per output pixel (~8 GB a frame when each sample is formed once), mostly
// L1/L2 hits because neighbouring pixels share corners, and the weights,
// which every block streams through once (L2-resident, 1.2 MB at 256->256).
// The TPU kernel's one-hot-matmul detour is not needed: the GPU gathers
// natively.
//
// f32 forward (dcn_fwd_f32_kernel, simple first): a block owns a strip of
// BP output pixels of one row and a tile of BN output channels.  It computes
// each (tap, pixel) pair's four corner indices and weights once into shared
// memory (make_tap; its geometry, tap_geom and tap_corners, is the
// backward's too), then walks Cin in chunks of CK: its threads gather the
// clamped bilinear samples into a shared-memory im2col tile [9*CK, BP] f32
// (NHWC, so a corner's channels are contiguous and loads coalesce), load
// the matching weight tile, and each thread accumulates a 4x4 register tile
// of (pixel, channel) outputs in f32 FMA.
//
// bf16 forward (dcn_fwd_bf16_kernel<NC, OutT>), built for the gather:
//   * A block owns a 2-D tile of <= 64 output pixels (4x16, 4x8 or 2x8,
//     so neighbouring pixels' corners stay in L1) and NC = 64, 128 or 256
//     output channels: all of Cout <= 256 wherever the card fills, so each
//     (pixel, tap, channel) sample is gathered once.  The wrapper picks the
//     tile per level from H, W, Cout and the SM count (never from B):
//     the largest tile that still puts >= 132 blocks on the card.  The 32x64
//     level (2,048 pixels) has 128 tiles of 16 pixels, so there it splits
//     Cout in two (NC = Cout/2): each sample is gathered twice, ~0.1 GB
//     of extra L2 reads a frame, against one block per SM left idle.
//   * Chunks of one tap x 64 input channels (K = 64, one 128-byte row per
//     pixel).  Two producer warpgroups gather: a thread owns (pixel, 8
//     channels), loads each of its tap's four corners as one 16-byte load,
//     forms the 8 samples in f32 and stores 16 bytes into the A stage in
//     the 128-byte-swizzled layout that wgmma reads (hopper.cuh); rows past
//     the tile's pixels stay 0.  The gather is software-pipelined: a
//     chunk's corner loads are issued before the previous chunk's samples
//     are formed.  The tile's offsets are staged in shared memory once, so
//     the tap geometry (tap_geom + tap_corners<true>, per tap, in
//     registers) waits on no global load.  An invalid corner reads 0 with
//     weight 0: an exact +0, so every corner takes the same FMAs.
//   * The weights go through the same ring: the wrapper's weight image
//     (dcn_wimg_kernel: the [64, NC] chunks already swizzled and zero-padded
//     past Cin and Cout, ~1 us) lets one thread land a chunk with one bulk
//     copy of the TMA unit (cp.async.bulk, completing on the stage's
//     mbarrier), so a ragged Cin or Cout needs no tensor map and no second
//     path.  The ring has 4 stages; producers run up to 4 chunks ahead.
//   * One consumer warpgroup runs the [64, 64] x [64, NC] product of each
//     chunk as 4 wgmma m64nNCk16 (bf16 in, f32 accumulators in registers:
//     NC/2 a thread), keeps one chunk's products in flight, and frees a
//     stage when its products are done.  Warp specialisation: the gather
//     and the tensor cores overlap through the full / empty mbarriers; the
//     producers' proxy fence makes their stores visible to wgmma.
//   * What bounds it now (kernel_variants.py, H100): the gather's latency
//     at one block of 12 warps per SM.  At P2 256->256 (0.82 ms) dropping
//     the corner loads saves ~0.17 ms, the products ~0.11, the A stores
//     ~0.09, the weight copies ~0.03; no one part dominates.
//   * The epilogue writes OutT from registers: a quad of lanes exchanges
//     words so that each lane stores 16 bytes (8 bf16 or 4 f32) of one
//     pixel's row; element stores where Cout's row is not 16-byte aligned.
// The rounding points are the Pallas kernel's (above), and the samples are
// bit for bit those of the earlier wmma kernel (the same f32 sums in
// corner order, each product exact).  Each output's sum runs over the
// chunks in a fixed order (tap, then channel chunk, 16 channels per wgmma
// step) whatever the tile, the grid or B: an image gives the same bits at
// B = 1 and B = 2, and two runs are equal.
//
// Backward (dcn_backward_f32 / dcn_backward_bf16): from the output
// gradient g [B, H, W, Cout] it computes what _dcn_bwd_kernel computes, at
// its rounding points in bf16 (slotvps_tpu_torch/ops/deform_conv.py:
// deform_conv2d_backward is its plain version):
//   dsample_k = g . W_k^T               (f32 sums; rounded to bf16 in bf16)
//   dx        = sum of M_k^T dsample_k  (the transpose of the bilinear gather)
//   dW_k      = samples_k^T . g         (samples M_k x recomputed; rounded)
//   doff_k    = sum over corners of dM_k/dp x (dsample_k . x_corner)
// with M the corner weights (rounded to bf16 in bf16) and dM their f32
// position derivatives: the y derivative is gated on "not clamped in y",
// the x derivative on "valid and not clamped in x" (an invalid tap has no
// weight and so no y derivative either).  Every output is summed in a fixed
// order, so each is the same on every run.  Each dtype runs a data pass
// (dsample to a scratch ds [B*H*W, 9, Cin] in the compute dtype, the corner
// sums and doff), a dx pass, a split-K dW pass and an ordered reduction of
// the dW partials.
//
// f32 (dcn_backward_f32, only the pallas_f32 parity step runs it):
//   1. data pass: a block owns BPB consecutive pixels (flat over B*H*W),
//      stages their g rows once and walks the taps and Cin in chunks of
//      CKD: dsample [BPB, CKD] = g tile . W^T tile in f32 FMA; one warp per
//      pixel and one lane per channel writes ds and reduces dsample x
//      x_corner over the lanes into the pixel's four corner sums; after a
//      tap's last chunk, doff = sum of dM x corner sum.
//   3. weight pass: dW as a [9*Cin, Cout] product over pixels in TM x TN
//      tiles, each block summing one range of pixels (split K) into its
//      partial from recomputed samples, f32 FMA.
// bf16 (dcn_backward_bf16, the trainer's route), both products on wgmma:
//   1. data pass (dcn_bwd_data_bf16_kernel<NCI>): a block owns a 2-D tile
//      of <= 64 output pixels (the forward's tiles) and all NCI >= Cin
//      input channels.  g's tile lands once by TMA (a 4-D tensor map,
//      128-byte swizzle, zeros outside the image: the K-major A operand);
//      per tap, dsample [64, NCI] = g . W_k^T on wgmma m64nNCIk16 over
//      64-channel chunks of Cout, W_k^T's chunks arriving by bulk copy from
//      a pre-swizzled, zero-padded image (dcn_wimg_kernel on the transposed
//      strides) through a 3-stage ring.  The consumer warpgroup rounds the
//      f32 sums to bf16 (the Pallas rounding point) into one of two tiles
//      in shared memory and goes on to the next tap; the producer warps
//      write that tile to ds with 16-byte stores and form the four corner
//      sums sum_c dsample x x_corner with the forward's 16-byte corner
//      loads (a lane's 8 channels in order, then the pixel's lanes in a
//      fixed shuffle tree), then doff: dy then dx, gated by tap_derivs.
//   2. dx pass: below (all of Cin a block).
//   3. dW pass (dcn_bwd_dw_bf16_kernel<NC>): a block owns one tap x 64
//      input channels of dW (the forward's chunk) and all NC >= Cout
//      output channels, so each (pixel, tap, channel) sample is formed
//      once per call, and sums a range of 4 x 16 pixel tiles (split K:
//      ops/cuda/deform_conv.py dw_splits, a function of B*H*W, Cin and the
//      SM count, which fills whole waves of the card).  Producer warps
//      gather the tile's samples with the forward's code (tap_geom,
//      tap_corners<true>, 16-byte corner loads, software-pipelined; tap k's
//      two offsets loaded a tile ahead) into a 4-stage 128-byte-swizzled
//      ring; thread 0 lands g's tile [64 pixels][NC] beside them by TMA;
//      one consumer warpgroup runs dW_tile += samples^T . g on wgmma with
//      both operands read MN-major (TA = TB = 1), f32 accumulators, and
//      writes the split's partial.
// dx pass (a gather, as the JAX kernel's sliding row window sums dx in a
// fixed order): a block owns a tile of input pixels of one image, one warp
// per tile row.  A sample's corners lie within halo+1 rows above and
// halo+2 rows below its output pixel (columns alike), so only output
// pixels within that window of the tile reach it.  Output row by output
// row, the block recomputes the window's tap descriptors into shared
// memory; each warp scans them in order, finds with a ballot the taps with
// a corner on its row, and adds M x dsample (read from ds, a few taps'
// loads in flight at once) into its pixels' shared-memory sums: each sum
// is taken by one lane, in a fixed order (output row, column, tap,
// corner).  f32 (dcn_bwd_dx_kernel): XH x XW pixels and XC = 64 channels
// a block, two a lane.  bf16 (dcn_bwd_dx_bf16_kernel<CPL>, after
// kernel_variants.py named the per-64-channel descriptor builds and scans
// and the 4-byte ds loads): 8 x 8 pixels and all of Cin a block, Cin/32
// channels a lane, one 16-byte ds load a lane at Cin 256.
// What bounds the backward: ~2x the forward's contraction (dsample and dW,
// each as large as the forward's product) on the tensor cores, the inputs
// and outputs once: 0.887 ms at the 12 training shapes.  Any design that
// keeps ds has a floor above that: ds is 2.45 GB in bf16 at those shapes,
// written once and read about four times (once per corner), ~3.7 ms of HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BP = 64;        // output pixels per block (one row strip)
constexpr int BN = 64;        // output channels per block
constexpr int NT = 256;       // threads per block

struct Tap {                  // one (tap, pixel) bilinear sample
  int idx[4];                 // corner pixel index h*W+w, or -1: reads 0
  float w[4];                 // corner weight
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where tap k of output pixel (y, xo) samples, from that pixel's 18
// offsets `off`: the one statement of the sampling geometry, shared by the
// forward's and the backward's descriptors.
struct TapGeom {
  bool valid;      // the unclamped position lies in (-1, H) x (-1, W)
  bool ncy, ncx;   // within +-halo of the rigid position in y / x: the
                   // clamp passes the derivative (closed interval)
  int y0, x0;      // top-left corner of the clamped position
  float fy, fx;    // its fractions
};

// ... from the tap's own two offsets (dy, dx)
__device__ __forceinline__ TapGeom tap_geom_at(float dy, float dx, int y,
                                               int xo, int k, int H, int W,
                                               int halo) {
  TapGeom t;
  const float rig_y = (float)(y - 1 + k / 3);
  const float rig_x = (float)(xo - 1 + k % 3);
  const float py = rig_y + dy;
  const float px = rig_x + dx;
  t.valid = py > -1.f && py < (float)H && px > -1.f && px < (float)W;
  t.ncy = py >= rig_y - (float)halo && py <= rig_y + (float)halo;
  t.ncx = px >= rig_x - (float)halo && px <= rig_x + (float)halo;
  const float cy = fminf(fmaxf(py, rig_y - (float)halo), rig_y + (float)halo);
  const float cx = fminf(fmaxf(px, rig_x - (float)halo), rig_x + (float)halo);
  const float y0f = floorf(cy);
  const float x0f = floorf(cx);
  t.fy = cy - y0f;
  t.fx = cx - x0f;
  t.y0 = (int)y0f;
  t.x0 = (int)x0f;
  return t;
}

__device__ __forceinline__ TapGeom tap_geom(const float* __restrict__ off,
                                            int y, int xo, int k, int H,
                                            int W, int halo) {
  return tap_geom_at(off[2 * k], off[2 * k + 1], y, xo, k, H, W, halo);
}

// The corners of a tap: corner j (row j >> 1, column j & 1) gets pixel
// index base + cy*W + cx and its bilinear weight, or -1 and 0 where it lies
// outside the image or the tap is invalid; with kRound each weight rounded
// to bf16 (the bf16 kernels' first rounding point).
template <bool kRound>
__device__ __forceinline__ void tap_corners(const TapGeom& gm, int base,
                                            int H, int W, int* idx,
                                            float* w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cy = gm.y0 + (j >> 1);
    const int cx = gm.x0 + (j & 1);
    idx[j] = -1;
    w[j] = 0.f;
    if (gm.valid && cy >= 0 && cy < H && cx >= 0 && cx < W) {
      const float m = ((j >> 1) ? gm.fy : 1.f - gm.fy) *
                      ((j & 1) ? gm.fx : 1.f - gm.fx);
      idx[j] = base + cy * W + cx;
      w[j] = kRound ? __bfloat162float(__float2bfloat16_rn(m)) : m;
    }
  }
}

// The position derivatives of a tap's corner weights (f32, never rounded):
// dM/dy = +-(column weight), gated on "not clamped in y"; dM/dx = +-(row
// weight), gated on "not clamped in x"; both 0 for a corner tap_corners
// left at -1 (outside the image, or an invalid tap: no weight, so no
// derivative either).
__device__ __forceinline__ void tap_derivs(const TapGeom& gm, const int* idx,
                                           float* gy, float* gx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = idx[j] >= 0;
    const float colw = (j & 1) ? gm.fx : 1.f - gm.fx;
    const float roww = (j >> 1) ? gm.fy : 1.f - gm.fy;
    gy[j] = live && gm.ncy ? ((j >> 1) ? colw : -colw) : 0.f;
    gx[j] = live && gm.ncx ? ((j & 1) ? roww : -roww) : 0.f;
  }
}

// The sampling descriptor of tap k at output pixel (y, xo) of the image
// whose first pixel is `img`, corner indices from `base` (0: within the
// image; img: over the batch).  A pixel past the row (xo >= W) samples
// nothing.
__device__ Tap make_tap(const float* __restrict__ offset, size_t img, int y,
                        int xo, int k, int H, int W, int halo, int base = 0) {
  Tap t;
  TapGeom gm{};   // valid = false
  if (xo < W)
    gm = tap_geom(offset + (img + (size_t)y * W + xo) * 18, y, xo, k, H, W,
                  halo);
  tap_corners<false>(gm, base, H, W, t.idx, t.w);
  return t;
}

// ---- f32 ----

constexpr int CK = 8;         // input channels per contraction chunk
constexpr int KC = 9 * CK;    // contracted rows per chunk
constexpr int SP = BP + 4;    // padded row of the sample tile (no bank
                              // conflicts on its stores, float4 reads)

constexpr size_t kSmemBytes =
    sizeof(Tap) * 9 * BP + sizeof(float) * (KC * SP + KC * BN);

__global__ void __launch_bounds__(NT)
dcn_fwd_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const float* __restrict__ weight,
                   float* __restrict__ out,
                   int H, int W, int Cin, int Cout, int halo, int n_ctiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* taps = reinterpret_cast<Tap*>(smem);                   // [9][BP]
  float* s_tile = reinterpret_cast<float*>(taps + 9 * BP);    // [KC][SP]
  float* w_tile = s_tile + KC * SP;                            // [KC][BN]

  const int tid = threadIdx.x;
  const int ctile = blockIdx.x % n_ctiles;
  const int ptile = blockIdx.x / n_ctiles;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int px0 = ptile * BP;
  const int n0 = ctile * BN;
  const size_t img = (size_t)b * H * W;   // first pixel of image b

  // 1. sampling descriptors of the strip's 9 x BP (tap, pixel) pairs
  for (int e = tid; e < 9 * BP; e += NT)
    taps[e] = make_tap(offset, img, y, px0 + e % BP, e / BP, H, W, halo);

  const int tc = tid % 16;   // output channels tc*4 .. tc*4+3
  const int tp = tid / 16;   // output pixels   tp*4 .. tp*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();  // descriptors written / previous chunk consumed
    // 2. im2col tile: s_tile[k*CK + c][p], channel fastest across threads
    for (int e = tid; e < 9 * BP * CK; e += NT) {
      const int c = e % CK;
      const int kp = e / CK;         // k * BP + p
      const Tap& t = taps[kp];
      float v = 0.f;
      if (c0 + c < Cin) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t.idx[j] >= 0)
            v += t.w[j] * x[(img + t.idx[j]) * Cin + c0 + c];
      }
      s_tile[((kp / BP) * CK + c) * SP + kp % BP] = v;
    }
    // 3. weight tile: w_tile[k*CK + c][n] = weight[k][c0+c][n0+n]
    for (int e = tid; e < KC * BN; e += NT) {
      const int n = e % BN;
      const int r = e / BN;
      const int k = r / CK;
      const int c = r % CK;
      float v = 0.f;
      if (c0 + c < Cin && n0 + n < Cout)
        v = weight[((size_t)k * Cin + c0 + c) * Cout + n0 + n];
      w_tile[r * BN + n] = v;
    }
    __syncthreads();
    // 4. f32 FMA contraction over the chunk's 9*CK rows
#pragma unroll 8
    for (int r = 0; r < KC; ++r) {
      const float4 a =
          *reinterpret_cast<const float4*>(&s_tile[r * SP + tp * 4]);
      const float4 wv =
          *reinterpret_cast<const float4*>(&w_tile[r * BN + tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wr[j], acc[i][j]);
    }
  }

  // 5. epilogue: out[b, y, xo, n0 + tc*4 .. +3]
  const int n = n0 + tc * 4;
  if (n >= Cout) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xo = px0 + tp * 4 + i;
    if (xo >= W) continue;
    float* o = out + (img + (size_t)y * W + xo) * Cout + n;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---- bf16 ----

using bf16 = __nv_bfloat16;

constexpr int FM = 64;          // A rows: the block's output pixels, padded
constexpr int FK = 64;          // input channels per chunk (128-byte rows)
constexpr int F_STAGES = 4;     // depth of the A and weight rings
constexpr int F_CONS = 128;     // consumer warpgroup: wgmma
constexpr int F_PROD = 256;     // producer warps: the gather
constexpr int F_THREADS = F_CONS + F_PROD;
constexpr int F_ITEMS = FM * (FK / 8) / F_PROD;   // (pixel, 8 channels) each

// dynamic shared memory of the forward at NC output channels per block
template <int NC>
constexpr size_t fwd_smem_bytes() {
  return 1024 + (size_t)F_STAGES * (FM + NC) * 128 + 2 * F_STAGES * 8 +
         sizeof(float) * FM * 18;
}

// A weight image: for each row tile ct, tap k and 64-wide chunk cc of the
// contracted dimension, an [nt rows][64] bf16 block in the 128-byte-
// swizzled K-major layout of hopper.cuh, zero past `rows` and `kdim`, so
// that one bulk copy lands a chunk as wgmma reads it.  Element (row r,
// contracted index kc) of tap k is weight[k*rows*kdim + r*rstride +
// kc*kstride].  The forward's image has rows = Cout, kdim = Cin (rstride 1,
// kstride Cout); the backward's data pass reads W_k^T: rows = Cin, kdim =
// Cout (rstride Cout, kstride 1).  One thread per 16 bytes.
__global__ void dcn_wimg_kernel(const bf16* __restrict__ weight,
                                uint4* __restrict__ img, int rows, int kdim,
                                int rstride, int kstride, int nt, int n_cc,
                                int n_units) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_units) return;
  const int n = (e >> 3) % nt;
  int rest = (e >> 3) / nt;
  const int cc = rest % n_cc;
  rest /= n_cc;
  const int k = rest % 9;
  const int r = (rest / 9) * nt + n;
  const int c0 = cc * FK + (((e & 7) ^ (n & 7)) << 3);
  const bf16* wk = weight + (size_t)k * rows * kdim + (size_t)r * rstride;
  uint32_t word[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t lo = 0, hi = 0;
    if (r < rows && c0 + 2 * t < kdim)
      lo = __bfloat16_as_ushort(wk[(size_t)(c0 + 2 * t) * kstride]);
    if (r < rows && c0 + 2 * t + 1 < kdim)
      hi = __bfloat16_as_ushort(wk[(size_t)(c0 + 2 * t + 1) * kstride]);
    word[t] = lo | (hi << 16);
  }
  img[e] = make_uint4(word[0], word[1], word[2], word[3]);
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a low, b high
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Channels c .. c+7 of one bf16 row (src = row + c): one 16-byte load where
// `vec` (Cin % 8 == 0 and a 16-byte aligned tensor), else element loads;
// zeros past Cin.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ src, int c,
                                       int Cin, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t h[8];
#pragma unroll
  for (int t = 0; t < 8; ++t)
    h[t] = c + t < Cin ? __bfloat16_as_ushort(src[t]) : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

// 8 samples of one (pixel, tap) from its corners' rows u[j] (8 channels
// each) and rounded weights m[j]: the f32 sum over corners 0..3 of bf16
// weight x bf16 input (each product exact), rounded to bf16 and packed.
__device__ __forceinline__ uint4 corner_samples(const uint4 (&u)[4],
                                                const float (&m)[4]) {
  float v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t wd[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[2 * t] = fmaf(m[j], bf_lo(wd[t]), v[2 * t]);
      v[2 * t + 1] = fmaf(m[j], bf_hi(wd[t]), v[2 * t + 1]);
    }
  }
  return make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                    pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}

// The block's output pixels p < tile_h * tile_w <= FM, all NC channels of
// output tile ctile; warp w of the consumer holds pixel rows 16w + l/4 (+8)
// of the wgmma accumulator (hopper.cuh).  Writes OutT in 16-byte stores
// where the row allows them (out_vec), else element by element.
template <int NC, typename OutT>
__device__ __forceinline__ void fwd_epilogue(
    const float (&acc)[NC / 2], OutT* __restrict__ out, size_t img, int H,
    int W, int Cout, int ty0, int tx0, int tile_w, int n_pix, int ctile,
    int out_vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int nlim = Cout - ctile * NC;   // this tile's columns inside Cout
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * warp + (lane >> 2) + 8 * h;
    const int y = ty0 + p / tile_w;
    const int xo = tx0 + p % tile_w;
    const bool live = p < n_pix && y < H && xo < W;
    OutT* orow = out + (img + (size_t)y * W + xo) * Cout + ctile * NC;
    if constexpr (std::is_same<OutT, bf16>::value) {
      // four n8 blocks at a time: lane q of the quad gathers block 4jb+q's
      // 8 columns from its quad (a 4x4 transpose of 32-bit words)
#pragma unroll
      for (int jb = 0; jb < NC / 32; ++jb) {
        uint32_t wv[4], got[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int r = 4 * (4 * jb + jj) + 2 * h;
          wv[jj] = pack_bf2(acc[r], acc[r + 1]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = (q - r) & 3;
          const uint32_t v = __shfl_sync(0xffffffffu, pick4(wv, (q + r) & 3),
                                         (lane & ~3) | src);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (s == src) got[s] = v;
        }
        const int col = 8 * (4 * jb + q);
        if (!live) continue;
        if (out_vec && col + 8 <= nlim) {
          *reinterpret_cast<uint4*>(orow + col) =
              make_uint4(got[0], got[1], got[2], got[3]);
        } else {
#pragma unroll
          for (int s = 0; s < 8; ++s)
            if (col + s < nlim) {
              const uint32_t wd = got[s >> 1];
              orow[col + s] = __ushort_as_bfloat16(
                  (unsigned short)((s & 1) ? (wd >> 16) : (wd & 0xffffu)));
            }
        }
      }
    } else {
      // two n8 blocks at a time: even lanes write 4 columns of the first,
      // odd lanes 4 of the second (one exchange with the neighbour lane)
#pragma unroll
      for (int jb = 0; jb < NC / 16; ++jb) {
        const int r0 = 4 * (2 * jb) + 2 * h;
        const int r1 = 4 * (2 * jb + 1) + 2 * h;
        const bool odd = q & 1;
        const float s0 = odd ? acc[r0] : acc[r1];
        const float s1 = odd ? acc[r0 + 1] : acc[r1 + 1];
        const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 u = odd ? make_float4(g0, g1, acc[r1], acc[r1 + 1])
                             : make_float4(acc[r0], acc[r0 + 1], g0, g1);
        const int col = odd ? 8 * (2 * jb + 1) + 2 * (q - 1)
                            : 8 * (2 * jb) + 2 * q;
        if (!live) continue;
        if (out_vec && col + 4 <= nlim) {
          *reinterpret_cast<float4*>(orow + col) = u;
        } else {
          const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (col + s < nlim) orow[col + s] = uv[s];
        }
      }
    }
  }
}

template <int NC, typename OutT>
__global__ void __launch_bounds__(F_THREADS, 1)
dcn_fwd_bf16_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ offset,
                    const unsigned char* __restrict__ wimg,
                    OutT* __restrict__ out, int H, int W, int Cin, int Cout,
                    int halo, int tile_h, int tile_w, int tiles_x,
                    int n_ctiles, int vec, int out_vec) {
  using namespace hopper;
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* s_a =
      fsm_raw + ((1024 - (smem_addr(fsm_raw) & 1023)) & 1023);   // [S][FM*128]
  unsigned char* s_b = s_a + F_STAGES * FM * 128;               // [S][NC*128]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + F_STAGES * NC * 128);
  uint64_t* empty = full + F_STAGES;
  float* s_off = reinterpret_cast<float*>(empty + F_STAGES);   // [FM][18]

  const int tid = threadIdx.x;
  const int ctile = blockIdx.x % n_ctiles;
  const int ptile = blockIdx.x / n_ctiles;
  const int ty0 = (ptile / tiles_x) * tile_h;
  const int tx0 = (ptile % tiles_x) * tile_w;
  const int n_pix = tile_h * tile_w;
  const size_t img = (size_t)blockIdx.y * H * W;
  const int n_cc = (Cin + FK - 1) / FK;
  const int n_chunks = 9 * n_cc;

  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], F_PROD + 1);   // the gather + the weight copy
      mbar_init(&empty[s], F_CONS);
    }
    mbar_init_fence();
  }
  // A rows past the block's pixels stay 0
  for (int e = tid; e < F_STAGES * FM * 8; e += F_THREADS)
    reinterpret_cast<uint4*>(s_a)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (tid < F_CONS) {
    // ---- consumer: [FM, 9*Cin] x [9*Cin, NC] on wgmma, f32 in registers
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % F_STAGES;
      mbar_wait(&full[s], (i / F_STAGES) & 1);
      const unsigned char* a = s_a + s * FM * 128;
      const unsigned char* b = s_b + s * NC * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma<NC, 0, 0>(acc, desc128(a + 32 * kk, 16, 1024),
                        desc128(b + 32 * kk, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();   // chunk i-1's products are done: free its stage
      if (i > 0) mbar_arrive(&empty[(i - 1) % F_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fwd_epilogue<NC, OutT>(acc, out, img, H, W, Cout, ty0, tx0, tile_w,
                           n_pix, ctile, out_vec);
  } else {
    // ---- producers: per chunk (tap k, channels cc*64 ..), thread pt
    // forms the 8 samples of channels 8g .. 8g+7 of pixel p (g = e & 7,
    // p = e >> 3, e = pt + F_PROD*i) and thread 0 copies the weight chunk.
    // The gather is software-pipelined: chunk ic+1's corner loads are in
    // flight while chunk ic's samples are formed and stored.
    const int pt = tid - F_CONS;
    const unsigned char* wsrc =
        wimg + (size_t)ctile * n_chunks * NC * 128;
    // the tile's offsets, staged once (the tap geometry reads them 9 times)
    for (int e = pt; e < n_pix * 18; e += F_PROD) {
      const int p = e / 18;
      const int y = ty0 + p / tile_w;
      const int xo = tx0 + p % tile_w;
      s_off[e] = y < H && xo < W
                     ? offset[(img + (size_t)y * W + xo) * 18 + e % 18]
                     : 0.f;
    }
    named_sync(1, F_PROD);
    int pix[F_ITEMS];   // pixel of item i, -1 past the tile
#pragma unroll
    for (int i = 0; i < F_ITEMS; ++i) {
      const int p = (pt + F_PROD * i) >> 3;
      pix[i] = p < n_pix ? p : -1;
    }
    const int g8 = 8 * (pt & 7);   // the items' channel offset in a chunk
    Tap tp[F_ITEMS];    // the tap of the chunk being loaded
    uint4 un[F_ITEMS][4];
    auto set_tap = [&](int k) {
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i) {
        const int p = pix[i] < 0 ? 0 : pix[i];
        const int y = ty0 + p / tile_w;
        const int xo = tx0 + p % tile_w;
        // a pixel outside the tile or the image samples nothing
        TapGeom gm{};   // valid = false
        if (pix[i] >= 0 && y < H && xo < W)
          gm = tap_geom(s_off + p * 18, y, xo, k, H, W, halo);
        tap_corners<true>(gm, 0, H, W, tp[i].idx, tp[i].w);
      }
    };
    // corner j of item i at channels c .. c+7 (zeros past Cin or off the
    // image: an invalid corner has weight 0 and adds an exact +0)
    auto load_chunk = [&](int cc) {
      const int c = cc * FK + g8;
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          un[i][j] = make_uint4(0, 0, 0, 0);
          if (tp[i].idx[j] < 0 || c >= Cin) continue;
          un[i][j] = load8(x + (img + tp[i].idx[j]) * Cin + c, c, Cin, vec);
        }
    };
    set_tap(0);
    load_chunk(0);
    for (int ic = 0; ic < n_chunks; ++ic) {
      const int s = ic % F_STAGES;
      uint4 uc[F_ITEMS][4];
      float wc[F_ITEMS][4];
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uc[i][j] = un[i][j];
          wc[i][j] = tp[i].w[j];
        }
      if (ic + 1 < n_chunks) {
        if ((ic + 1) % n_cc == 0) set_tap((ic + 1) / n_cc);
        load_chunk((ic + 1) % n_cc);
      }
      mbar_wait(&empty[s], ((ic / F_STAGES) & 1) ^ 1);
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], NC * 128);
        bulk_load(s_b + s * NC * 128, wsrc + (size_t)ic * NC * 128,
                  NC * 128, &full[s]);
      }
      unsigned char* a = s_a + s * FM * 128;
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i) {
        if (pix[i] < 0) continue;
        const uint4 v = corner_samples(uc[i], wc[i]);
        const int p = pix[i];
        *reinterpret_cast<uint4*>(a + p * 128 + (((g8 >> 3) ^ (p & 7)) << 4)) =
            v;
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  }
}

template <int NC>
int launch_fwd_bf16(const bf16* x, const float* offset, const bf16* weight,
                    void* wimg, void* out, int out_f32, int B, int H, int W,
                    int Cin, int Cout, int halo, int tile_h, int tile_w,
                    cudaStream_t stream) {
  const int n_cc = (Cin + FK - 1) / FK;
  const int n_ctiles = (Cout + NC - 1) / NC;
  const int n_units = n_ctiles * 9 * n_cc * NC * 8;
  dcn_wimg_kernel<<<(n_units + 255) / 256, 256, 0, stream>>>(
      weight, static_cast<uint4*>(wimg), Cout, Cin, 1, Cout, NC, n_cc,
      n_units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const dim3 grid(tiles_y * tiles_x * n_ctiles, B);
  const size_t smem = fwd_smem_bytes<NC>();
  const int vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t osz = out_f32 ? sizeof(float) : sizeof(bf16);
  const int out_vec = (Cout * osz) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned char* wi = static_cast<const unsigned char*>(wimg);
  if (out_f32) {
    err = cudaFuncSetAttribute(dcn_fwd_bf16_kernel<NC, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dcn_fwd_bf16_kernel<NC, float><<<grid, F_THREADS, smem, stream>>>(
        x, offset, wi, static_cast<float*>(out), H, W, Cin, Cout, halo,
        tile_h, tile_w, tiles_x, n_ctiles, vec, out_vec);
  } else {
    err = cudaFuncSetAttribute(dcn_fwd_bf16_kernel<NC, bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dcn_fwd_bf16_kernel<NC, bf16><<<grid, F_THREADS, smem, stream>>>(
        x, offset, wi, static_cast<bf16*>(out), H, W, Cin, Cout, halo,
        tile_h, tile_w, tiles_x, n_ctiles, vec, out_vec);
  }
  return (int)cudaGetLastError();
}

// ---- backward ----

constexpr int BPB = 64;        // pixels per block of the f32 data pass
constexpr int CKD = 32;        // input channels per chunk (one per lane)
constexpr int LDS = CKD + 4;   // f32 dsample tile row
constexpr int LDWF = CKD + 4;  // f32 W^T tile row ([Cout][LDWF])
constexpr int kSmemAlign = 128;

struct TapGrad {              // one (tap, pixel) pair of the backward
  int idx[4];                 // corner pixel index over B*H*W, or -1
  float w[4];                 // corner weight M
  float gy[4];                // dM / d(position y)
  float gx[4];                // dM / d(position x)
};

// The f32 backward's descriptor of tap k at flat pixel q = (b*H + y)*W + x:
// the forward's corners (indices over B*H*W) and their position
// derivatives (tap_derivs).  Corners outside the image get idx -1: x reads
// 0 there, and the JAX kernel's dx in the padding is discarded, so they
// contribute nothing.
__device__ TapGrad make_tap_grad(const float* __restrict__ offset, int q,
                                 int H, int W, int k, int halo) {
  const int b = q / (H * W);
  const int y = (q - b * H * W) / W;
  const int xo = q - (b * H + y) * W;
  const TapGeom gm = tap_geom(offset + (size_t)q * 18, y, xo, k, H, W, halo);
  TapGrad t;
  tap_corners<false>(gm, b * H * W, H, W, t.idx, t.w);
  tap_derivs(gm, t.idx, t.gy, t.gx);
  return t;
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared-memory layout of the f32 data pass for Cout output channels: the
// fixed part (dsample tile, descriptors, corner sums), then the g tile
// [BPB][Cout + 4] and the W^T tile [Cout][LDWF] (float4 reads of 8
// channels), each region 128-byte aligned.
struct DataSmem {
  int ldg;
  size_t g_off, w_off, bytes;
};

DataSmem data_smem(int Cout) {
  DataSmem d;
  size_t off = round_up(sizeof(float) * BPB * LDS + sizeof(TapGrad) * BPB +
                            sizeof(float) * BPB * 4,
                        kSmemAlign);
  d.ldg = Cout + 4;
  d.g_off = off;
  off += round_up((int)(sizeof(float) * BPB * d.ldg), kSmemAlign);
  d.w_off = off;
  off += round_up((int)(sizeof(float) * Cout * LDWF), kSmemAlign);
  d.bytes = off;
  return d;
}

__global__ void __launch_bounds__(NT)
dcn_bwd_data_kernel(const float* __restrict__ x,
                    const float* __restrict__ offset,
                    const float* __restrict__ weight,
                    const float* __restrict__ g, float* __restrict__ ds,
                    float* __restrict__ doff, int n_pix, int H, int W,
                    int Cin, int Cout, int halo, DataSmem sm) {
  extern __shared__ __align__(128) unsigned char smem_d[];
  float* s_ds = reinterpret_cast<float*>(smem_d);              // [BPB][LDS]
  TapGrad* s_tap = reinterpret_cast<TapGrad*>(s_ds + BPB * LDS);  // [BPB]
  float* s_pt = reinterpret_cast<float*>(s_tap + BPB);         // [BPB][4]
  float* s_g = reinterpret_cast<float*>(smem_d + sm.g_off);    // [BPB][ldg]
  float* s_w = reinterpret_cast<float*>(smem_d + sm.w_off);    // [Cout][LDWF]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * BPB;
  const int ldg = sm.ldg;

  // 1. the block's g rows, zero-padded
  for (int e = tid; e < BPB * ldg; e += NT) {
    const int p = e / ldg;
    const int co = e - p * ldg;
    float v = 0.f;
    if (p0 + p < n_pix && co < Cout) v = g[(size_t)(p0 + p) * Cout + co];
    s_g[e] = v;
  }

  for (int k = 0; k < 9; ++k) {
    __syncthreads();  // g staged / the previous tap's corner sums read
    if (tid < BPB) {
      if (p0 + tid < n_pix) {
        s_tap[tid] = make_tap_grad(offset, p0 + tid, H, W, k, halo);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_tap[tid].idx[j] = -1;
          s_tap[tid].w[j] = s_tap[tid].gy[j] = s_tap[tid].gx[j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s_pt[tid * 4 + j] = 0.f;
    }
    for (int c0 = 0; c0 < Cin; c0 += CKD) {
      __syncthreads();  // descriptors written / previous chunk consumed
      // 2. W^T tile of tap k, channels c0 .. c0+CKD-1
      for (int e = tid; e < Cout * CKD; e += NT) {
        const int co = e / CKD;
        const int c = e - co * CKD;
        float v = 0.f;
        if (c0 + c < Cin) v = weight[((size_t)k * Cin + c0 + c) * Cout + co];
        s_w[co * LDWF + c] = v;
      }
      __syncthreads();
      // 3. dsample [BPB, CKD] = g tile . W^T tile, f32 FMA
      {
        const int p = tid / 4;
        const int cb = (tid % 4) * 8;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        const float* gr = s_g + p * ldg;
        const float* wt = s_w + cb;
        for (int co = 0; co < Cout; ++co) {
          const float a = gr[co];
          const float4 w0 = *reinterpret_cast<const float4*>(wt + co * LDWF);
          const float4 w1 =
              *reinterpret_cast<const float4*>(wt + co * LDWF + 4);
          acc[0] = fmaf(a, w0.x, acc[0]);
          acc[1] = fmaf(a, w0.y, acc[1]);
          acc[2] = fmaf(a, w0.z, acc[2]);
          acc[3] = fmaf(a, w0.w, acc[3]);
          acc[4] = fmaf(a, w1.x, acc[4]);
          acc[5] = fmaf(a, w1.y, acc[5]);
          acc[6] = fmaf(a, w1.z, acc[6]);
          acc[7] = fmaf(a, w1.w, acc[7]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) s_ds[p * LDS + cb + i] = acc[i];
      }
      __syncthreads();
      // 4. one warp per pixel, one lane per channel: dsample to ds (for
      //    the dx pass), corner sums of dsample x x_corner over the lanes
      for (int p = warp; p < BPB; p += NT / 32) {
        if (p0 + p >= n_pix) continue;   // warp-uniform
        const TapGrad t = s_tap[p];
        const int c = c0 + lane;
        float d = 0.f;
        if (c < Cin) {
          d = s_ds[p * LDS + lane];
          ds[((size_t)(p0 + p) * 9 + k) * Cin + c] = d;
        }
        if (t.idx[0] < 0 && t.idx[1] < 0 && t.idx[2] < 0 && t.idx[3] < 0)
          continue;   // warp-uniform: an invalid tap
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < Cin) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t.idx[j] >= 0) part[j] = d * x[(size_t)t.idx[j] * Cin + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s_pt[p * 4 + j] += part[j];
        }
      }
    }
    __syncthreads();
    // 5. the tap's offset gradient, dy then dx
    if (tid < BPB && p0 + tid < n_pix) {
      const TapGrad& t = s_tap[tid];
      float gy = 0.f;
      float gx = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gy += t.gy[j] * s_pt[tid * 4 + j];
        gx += t.gx[j] * s_pt[tid * 4 + j];
      }
      doff[(size_t)(p0 + tid) * 18 + 2 * k] = gy;
      doff[(size_t)(p0 + tid) * 18 + 2 * k + 1] = gx;
    }
  }
}

constexpr int XH = NT / 32;   // input rows per block of the dx pass (a warp
                              // each)
constexpr int XW = 32;        // input columns per block of the dx pass
constexpr int XC = 64;        // input channels per block (two per lane)
constexpr int XU = 4;         // taps whose dsample loads are in flight at once
constexpr int kNoRow = -(1 << 28);   // DxTap.y0 of a tap that samples nothing

struct DxTap {                // one (output pixel, tap) of the dx pass
  int y0, x0;                 // top-left corner of the clamped sample
  float w[4];                 // corner weights M (0 outside the image)
};

// Shared memory of the dx pass at a halo: the tile's sums [XH][XW][XC] and
// one output row's tap descriptors [(XW + 2*halo + 3) * 9].
size_t dx_smem_bytes(int halo) {
  return sizeof(float) * XH * XW * XC +
         sizeof(DxTap) * (size_t)(XW + 2 * halo + 3) * 9;
}

// Channels c and c+1 of one dsample row (0 past Cin); two-wide loads when
// Cin is even (c is even, so they are aligned).
__device__ __forceinline__ float2 ds_pair(const float* __restrict__ row,
                                          int c, int Cin) {
  if ((Cin & 1) == 0 && c + 1 < Cin)
    return *reinterpret_cast<const float2*>(row + c);
  return make_float2(c < Cin ? row[c] : 0.f, c + 1 < Cin ? row[c + 1] : 0.f);
}

// The f32 dx pass: dx [B, H, W, Cin] f32 = the sum over the taps whose
// corners land on each input pixel of M x dsample, from ds [B*H*W, 9, Cin]
// f32; every element written, each sum in one fixed order.
__global__ void __launch_bounds__(NT)
dcn_bwd_dx_kernel(const float* __restrict__ ds,
                  const float* __restrict__ offset, float* __restrict__ dx,
                  int H, int W, int Cin, int halo, int n_xtiles) {
  extern __shared__ __align__(16) unsigned char smem_x[];
  float2* s_acc = reinterpret_cast<float2*>(smem_x);   // [XH][XW][XC/2]
  DxTap* s_tap = reinterpret_cast<DxTap*>(s_acc + XH * XW * XC / 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int xt0 = (blockIdx.x % n_xtiles) * XW;
  const int c = (blockIdx.x / n_xtiles) * XC + 2 * lane;   // and c + 1
  const int yi = blockIdx.y * XH + warp;   // this warp's input row
  const size_t img = (size_t)blockIdx.z * H * W;
  float2* acc = s_acc + warp * XW * (XC / 2) + lane;   // acc[col * XC/2]
  for (int col = 0; col < XW; ++col) acc[col * (XC / 2)] = make_float2(0, 0);

  // the output pixels whose samples can reach the tile
  const int ylo = max(0, (int)blockIdx.y * XH - halo - 2);
  const int yhi = min(H - 1, (int)blockIdx.y * XH + XH - 1 + halo + 1);
  const int xlo = max(0, xt0 - halo - 2);
  const int xhi = min(W - 1, xt0 + XW - 1 + halo + 1);
  const int n_e = (xhi - xlo + 1) * 9;    // entry e: column xlo + e/9, tap e%9
  for (int y = ylo; y <= yhi; ++y) {
    __syncthreads();   // the previous row's descriptors consumed
    for (int e = tid; e < n_e; e += NT) {
      const int xo = xlo + e / 9;
      const TapGeom gm = tap_geom(offset + (img + (size_t)y * W + xo) * 18,
                                  y, xo, e % 9, H, W, halo);
      DxTap t;
      int idx[4];
      tap_corners<false>(gm, 0, H, W, idx, t.w);
      t.y0 = gm.valid ? gm.y0 : kNoRow;
      t.x0 = gm.x0;
      s_tap[e] = t;
    }
    __syncthreads();
    if (yi >= H) continue;   // warp-uniform; the loop's barriers still run
    const float* ds_row = ds + (img + (size_t)y * W + xlo) * 9 * Cin;
    // the entries with a corner on row yi inside the tile, in entry order;
    // XU of them at a time: their loads first, then their sums in order
    for (int e0 = 0; e0 < n_e; e0 += 32) {
      bool hit = false;
      if (e0 + lane < n_e) {
        const DxTap& t = s_tap[e0 + lane];
        hit = (t.y0 == yi || t.y0 + 1 == yi) && t.x0 >= xt0 - 1 &&
              t.x0 < xt0 + XW;
      }
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {
        int eh[XU];
        float2 d[XU];
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          eh[u] = -1;
          if (mask) {
            eh[u] = e0 + __ffs(mask) - 1;
            mask &= mask - 1;
          }
        }
#pragma unroll
        for (int u = 0; u < XU; ++u)
          d[u] = eh[u] < 0 ? make_float2(0.f, 0.f)
                           : ds_pair(ds_row + (size_t)eh[u] * Cin, c, Cin);
#pragma unroll
        for (int u = 0; u < XU; ++u) {
          if (eh[u] >= 0) {   // warp-uniform
            const DxTap& t = s_tap[eh[u]];
            const bool bottom = t.y0 != yi;   // the row's corners are 2, 3
#pragma unroll
            for (int jc = 0; jc < 2; ++jc) {
              const int col = t.x0 + jc - xt0;
              const float m = bottom ? t.w[2 + jc] : t.w[jc];
              if (col >= 0 && col < XW && m != 0.f) {
                float2 a = acc[col * (XC / 2)];
                a.x += m * d[u].x;
                a.y += m * d[u].y;
                acc[col * (XC / 2)] = a;
              }
            }
          }
        }
      }
    }
  }
  if (yi >= H || c >= Cin) return;
  for (int col = 0; col < XW && xt0 + col < W; ++col) {
    const float2 a = acc[col * (XC / 2)];
    float* out = dx + (img + (size_t)yi * W + xt0 + col) * Cin + c;
    if ((Cin & 1) == 0) {
      *reinterpret_cast<float2*>(out) = a;
    } else {
      out[0] = a.x;
      if (c + 1 < Cin) out[1] = a.y;
    }
  }
}

// ---- the bf16 dx pass ----
//
// The f32 pass's window walk, with all of Cin in one block: a block owns
// XB_ROWS x XB_COLS input pixels of one image (a warp a row) and every
// channel, CPL = NCI / 32 channels a lane, so a window's descriptors are
// built once for all channels (the f32 pass builds them once per 64), a
// warp's scan of a window row serves all channels, and a ds row comes in
// one 4 * CPL-byte load a lane.  The sums live in shared memory, CPL
// contiguous floats a lane and column (kernel_variants.py: registers
// picked by a uniform branch on the column cost ~0.9 ms more at P2 of the
// training crop).  The order of every sum is the f32 pass's (output row,
// column, tap, corner).
constexpr int XB_ROWS = NT / 32;   // input rows per block (a warp each)
constexpr int XB_COLS = 8;         // input columns per block
constexpr int XB_U = 2;            // hits whose ds loads are in flight

// the block's sums [XB_ROWS][XB_COLS][32 * cpl] f32, then one output row's
// window entries.  A lane's sums of one column lie in chunks of
// DxVec<CPL>::N floats, chunk j of lane l at (j * 32 + l) * N: a warp's
// vector accesses to a chunk touch consecutive addresses (no bank
// conflicts).
template <int CPL>
struct DxVec {   // CPL = 2: float2 chunks
  static constexpr int N = 2;
  using T = float2;
  __device__ static T axpy(T v, float m, const float* d) {
    return make_float2(v.x + m * d[0], v.y + m * d[1]);
  }
};
template <>
struct DxVec<4> {
  static constexpr int N = 4;
  using T = float4;
  __device__ static T axpy(T v, float m, const float* d) {
    return make_float4(v.x + m * d[0], v.y + m * d[1], v.z + m * d[2],
                       v.w + m * d[3]);
  }
};
template <>
struct DxVec<8> : DxVec<4> {};

size_t dx_bf16_smem_bytes(int halo, int cpl) {
  return sizeof(float) * XB_ROWS * XB_COLS * 32 * cpl +
         sizeof(DxTap) * (size_t)(XB_COLS + 2 * halo + 3) * 9;
}

// CPL channels c .. c+CPL-1 of one bf16 ds row, as f32 (0 past Cin): one
// load of 4 * CPL bytes where `vec` (Cin % CPL == 0, ds 16-byte aligned)
template <int CPL>
__device__ __forceinline__ void load_ds(const bf16* __restrict__ row, int c,
                                        int Cin, int vec, float (&d)[CPL]) {
  uint32_t wd[CPL / 2];
  if (vec && c < Cin) {
    if constexpr (CPL == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
      wd[0] = u.x, wd[1] = u.y, wd[2] = u.z, wd[3] = u.w;
    } else if constexpr (CPL == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + c));
      wd[0] = u.x, wd[1] = u.y;
    } else {
      wd[0] = __ldg(reinterpret_cast<const unsigned int*>(row + c));
    }
  } else {
#pragma unroll
    for (int t = 0; t < CPL / 2; ++t) {
      const uint32_t lo =
          c + 2 * t < Cin ? __bfloat16_as_ushort(row[c + 2 * t]) : 0u;
      const uint32_t hi =
          c + 2 * t + 1 < Cin ? __bfloat16_as_ushort(row[c + 2 * t + 1]) : 0u;
      wd[t] = lo | (hi << 16);
    }
  }
#pragma unroll
  for (int t = 0; t < CPL / 2; ++t) {
    d[2 * t] = bf_lo(wd[t]);
    d[2 * t + 1] = bf_hi(wd[t]);
  }
}

template <int CPL>
__global__ void __launch_bounds__(NT)
dcn_bwd_dx_bf16_kernel(const bf16* __restrict__ ds,
                       const float* __restrict__ offset,
                       float* __restrict__ dx, int H, int W, int Cin,
                       int halo, int vec) {
  extern __shared__ __align__(16) unsigned char smem_xb[];
  float* s_sum = reinterpret_cast<float*>(smem_xb);
  DxTap* s_tap = reinterpret_cast<DxTap*>(s_sum + XB_ROWS * XB_COLS * 32 * CPL);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int xt0 = blockIdx.x * XB_COLS;
  const int c = lane * CPL;
  const int yi = blockIdx.y * XB_ROWS + warp;   // this warp's input row
  const size_t img = (size_t)blockIdx.z * H * W;
  using Vec = DxVec<CPL>;
  using VT = typename Vec::T;
  constexpr int NV = Vec::N;
  // this lane's chunk j of column cc: my_sum[cc * 32 * CPL + j * 32 * NV]
  float* my_sum = s_sum + warp * XB_COLS * 32 * CPL + lane * NV;
  for (int cc = 0; cc < XB_COLS; ++cc)
#pragma unroll
    for (int j = 0; j < CPL / NV; ++j)
      *reinterpret_cast<VT*>(my_sum + cc * 32 * CPL + j * 32 * NV) = VT{};

  // the output pixels whose samples can reach the tile
  const int ylo = max(0, (int)blockIdx.y * XB_ROWS - halo - 2);
  const int yhi =
      min(H - 1, (int)blockIdx.y * XB_ROWS + XB_ROWS - 1 + halo + 1);
  const int xlo = max(0, xt0 - halo - 2);
  const int xhi = min(W - 1, xt0 + XB_COLS - 1 + halo + 1);
  const int n_e = (xhi - xlo + 1) * 9;    // entry e: column xlo + e/9, tap e%9
  for (int y = ylo; y <= yhi; ++y) {
    __syncthreads();   // the previous row's descriptors consumed
    for (int e = tid; e < n_e; e += NT) {
      const int xo = xlo + e / 9;
      const TapGeom gm = tap_geom(offset + (img + (size_t)y * W + xo) * 18,
                                  y, xo, e % 9, H, W, halo);
      DxTap t;
      int idx[4];
      tap_corners<true>(gm, 0, H, W, idx, t.w);
      t.y0 = gm.valid ? gm.y0 : kNoRow;
      t.x0 = gm.x0;
      s_tap[e] = t;
    }
    __syncthreads();
    if (yi >= H) continue;   // warp-uniform; the loop's barriers still run
    const bf16* ds_row = ds + (img + (size_t)y * W + xlo) * 9 * Cin;
    // the entries with a corner on row yi inside the tile, in entry order;
    // XB_U of them at a time: their loads first, then their sums in order
    for (int e0 = 0; e0 < n_e; e0 += 32) {
      bool hit = false;
      if (e0 + lane < n_e) {
        const DxTap& t = s_tap[e0 + lane];
        hit = (t.y0 == yi || t.y0 + 1 == yi) && t.x0 >= xt0 - 1 &&
              t.x0 < xt0 + XB_COLS;
      }
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {
        int eh[XB_U];
        float d[XB_U][CPL];
#pragma unroll
        for (int u = 0; u < XB_U; ++u) {
          eh[u] = -1;
          if (mask) {
            eh[u] = e0 + __ffs(mask) - 1;
            mask &= mask - 1;
          }
        }
#pragma unroll
        for (int u = 0; u < XB_U; ++u) {
          if (eh[u] < 0) {
#pragma unroll
            for (int t = 0; t < CPL; ++t) d[u][t] = 0.f;
          } else {
            load_ds<CPL>(ds_row + (size_t)eh[u] * Cin, c, Cin, vec, d[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < XB_U; ++u) {
          if (eh[u] >= 0) {   // warp-uniform
            const DxTap& t = s_tap[eh[u]];
            const bool bottom = t.y0 != yi;   // the row's corners are 2, 3
#pragma unroll
            for (int jc = 0; jc < 2; ++jc) {
              const int col = t.x0 + jc - xt0;
              const float m = bottom ? t.w[2 + jc] : t.w[jc];
              if (col >= 0 && col < XB_COLS && m != 0.f) {
#pragma unroll
                for (int j = 0; j < CPL / NV; ++j) {
                  VT* a = reinterpret_cast<VT*>(my_sum + col * 32 * CPL +
                                                j * 32 * NV);
                  *a = Vec::axpy(*a, m, d[u] + j * NV);
                }
              }
            }
          }
        }
      }
    }
  }
  if (yi >= H || c >= Cin) return;
  for (int cc = 0; cc < XB_COLS && xt0 + cc < W; ++cc) {
    float* out = dx + (img + (size_t)yi * W + xt0 + cc) * Cin + c;
#pragma unroll
    for (int j = 0; j < CPL / NV; ++j) {
      const VT v = *reinterpret_cast<const VT*>(my_sum + cc * 32 * CPL +
                                                j * 32 * NV);
      if (vec && Cin % NV == 0) {
        *reinterpret_cast<VT*>(out + j * NV) = v;
      } else {
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int e = 0; e < NV; ++e)
          if (c + j * NV + e < Cin) out[j * NV + e] = f[e];
      }
    }
  }
}

constexpr int TM = 64;    // dW rows (tap, input channel) per block
constexpr int TN = 64;    // dW cols (output channels) per block
constexpr int KP = 32;    // pixels per step of the weight pass

// f32 dW partial of one (row tile, col tile, pixel range): part[split] =
// samples^T . g over the range, f32 FMA.
__global__ void __launch_bounds__(NT)
dcn_bwd_weight_kernel(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ g, float* __restrict__ part,
                      int n_pix, int H, int W, int Cin, int Cout, int halo,
                      int n_ntiles, int pix_per_split) {
  constexpr int WLDA = TM + 4;   // s_a [KP][WLDA]
  constexpr int WLDB = TN + 4;   // s_b [KP][WLDB]
  __shared__ __align__(128) Tap s_tap[9 * KP];
  __shared__ __align__(128) float s_a[KP * WLDA];
  __shared__ __align__(128) float s_b[KP * WLDB];

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / n_ntiles) * TM;
  const int n0 = (blockIdx.x % n_ntiles) * TN;
  const int n_rows = 9 * Cin;
  const int k_lo = r0 / Cin;
  const int k_hi = min(n_rows, r0 + TM) - 1;
  const int n_taps = k_hi / Cin - k_lo + 1;
  const int pbeg = blockIdx.y * pix_per_split;
  const int pend = min(n_pix, pbeg + pix_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = pbeg; q0 < pend; q0 += KP) {
    __syncthreads();  // previous step's tiles consumed
    // 1. descriptors of the row tile's taps at the step's pixels
    for (int e = tid; e < n_taps * KP; e += NT) {
      const int q = q0 + e % KP;
      const int b = q / (H * W);
      const int y = (q - b * H * W) / W;
      // corner indices over B*H*W; a pixel past the range samples nothing
      const int xo = q < pend ? q - (b * H + y) * W : W;
      s_tap[e] = make_tap(offset, (size_t)b * H * W, y, xo, k_lo + e / KP,
                          H, W, halo, b * H * W);
    }
    // 2. g tile [KP][TN]
    for (int e = tid; e < KP * TN; e += NT) {
      const int px = e / TN;
      const int n = e - px * TN;
      float v = 0.f;
      if (q0 + px < pend && n0 + n < Cout)
        v = g[(size_t)(q0 + px) * Cout + n0 + n];
      s_b[px * WLDB + n] = v;
    }
    __syncthreads();
    // 3. sample tile [KP][TM]: f32 sum of M x x over the corners
    //    (neighbouring threads: neighbouring channels)
    for (int e = tid; e < KP * TM; e += NT) {
      const int px = e / TM;
      const int r = e - px * TM;
      const int row = r0 + r;
      float v = 0.f;
      if (row < n_rows && q0 + px < pend) {
        const int k = row / Cin;
        const int c = row - k * Cin;
        const Tap& t = s_tap[(k - k_lo) * KP + px];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t.idx[j] >= 0) v += t.w[j] * x[(size_t)t.idx[j] * Cin + c];
      }
      s_a[px * WLDA + r] = v;
    }
    __syncthreads();
    // 4. acc[TM][TN] += A . B over the step's KP pixels
    const int tr = (tid / 16) * 4;
    const int tc = (tid % 16) * 4;
#pragma unroll 8
    for (int px = 0; px < KP; ++px) {
      const float4 a = *reinterpret_cast<const float4*>(&s_a[px * WLDA + tr]);
      const float4 b = *reinterpret_cast<const float4*>(&s_b[px * WLDB + tc]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // 5. the partial of this split: part[split][row][col]
  float* dst = part + (size_t)blockIdx.y * n_rows * Cout;
  const int tr = (tid / 16) * 4;
  const int tc = (tid % 16) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r0 + tr + i < n_rows && n0 + tc + j < Cout)
        dst[(size_t)(r0 + tr + i) * Cout + n0 + tc + j] = acc[i][j];
}

// dW = the partials summed in split order (the same on every run).
__global__ void dcn_bwd_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dw, int n,
                                      int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * n + i];
  dw[i] = s;
}

// ---- bf16 backward on wgmma ----

constexpr int BW_TH = 4;        // dW pass pixel tile: 4 rows x 16 columns,
constexpr int BW_TW = 16;       //   FM pixels, the product's K per stage
constexpr int BW_STAGES = 4;    // depth of the dW pass's sample and g ring
constexpr int BD_STAGES = 3;    // depth of the data pass's W^T ring
constexpr int BD_PAD = 8;       // bf16 pad of a dsample tile row

// dynamic shared memory of the dW pass at NC output channels per block
template <int NC>
constexpr size_t bwd_dw_smem_bytes() {
  return 1024 + (size_t)BW_STAGES * (FM + NC) * 128 + 2 * BW_STAGES * 8;
}

// ... and of the data pass at NCI input channels, with n_kb 64-channel
// chunks of Cout in its g tile
template <int NCI>
constexpr size_t bwd_data_smem_bytes(int n_kb) {
  return 1024 + (size_t)n_kb * FM * 128 + (size_t)BD_STAGES * NCI * 128 +
         2 * sizeof(bf16) * FM * (NCI + BD_PAD) + sizeof(float) * FM * 18 +
         (1 + BD_STAGES + 4) * 8;
}

// sum over 8 channels, in order, of a[t] x b[t] (bf16 pairs; each product
// exact in f32)
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    s = fmaf(bf_lo(wa[t]), bf_lo(wb[t]), s);
    s = fmaf(bf_hi(wa[t]), bf_hi(wb[t]), s);
  }
  return s;
}

// Data pass.  Block = one tile_h x tile_w pixel tile (<= FM pixels) of one
// image and all NCI >= Cin input channels.  The g tile [FM pixels][Cout]
// lands once by TMA (K-major A, one 64-channel box per chunk); per tap k,
// dsample[FM, NCI] = g . W_k^T runs on wgmma over the chunks of Cout, the
// W_k^T chunks [NCI][64] streaming through a BD_STAGES ring by bulk copy
// from the wrapper's image (consumer thread 0 refills a stage once all four
// warps' products on it are done).  The consumer rounds the f32 sums to
// bf16 into one of two tiles in shared memory; the producer warps then
// write that tile to ds and form the four corner sums and doff, while the
// consumer multiplies the next tap.
template <int NCI>
__global__ void __launch_bounds__(F_THREADS, 1)
dcn_bwd_data_bf16_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ offset,
                         const unsigned char* __restrict__ wimg,
                         const __grid_constant__ CUtensorMap gmap,
                         bf16* __restrict__ ds, float* __restrict__ doff,
                         int H, int W, int Cin, int Cout, int halo,
                         int tile_h, int tile_w, int tiles_x, int vec_x,
                         int vec_ds) {
  using namespace hopper;
  constexpr int LDT = NCI + BD_PAD;
  extern __shared__ unsigned char dsm_raw[];
  const int n_kb = (Cout + 63) / 64;
  const int n_chunks = 9 * n_kb;
  // [n_kb][FM*128] g, then [S][NCI*128] W^T
  unsigned char* s_g =
      dsm_raw + ((1024 - (smem_addr(dsm_raw) & 1023)) & 1023);
  unsigned char* s_w = s_g + n_kb * FM * 128;
  bf16* s_ds = reinterpret_cast<bf16*>(s_w + BD_STAGES * NCI * 128);
  float* s_off = reinterpret_cast<float*>(s_ds + 2 * FM * LDT);  // [FM][18]
  uint64_t* g_full = reinterpret_cast<uint64_t*>(s_off + FM * 18);
  uint64_t* w_full = g_full + 1;
  uint64_t* ds_full = w_full + BD_STAGES;
  uint64_t* ds_empty = ds_full + 2;

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * tile_h;
  const int tx0 = (blockIdx.x % tiles_x) * tile_w;
  const int n_pix = tile_h * tile_w;
  const size_t img = (size_t)blockIdx.y * H * W;

  if (tid == 0) {
    mbar_init(g_full, 1);
    for (int s = 0; s < BD_STAGES; ++s) mbar_init(&w_full[s], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ds_full[b], F_CONS);
      mbar_init(&ds_empty[b], F_PROD);
    }
    mbar_init_fence();
  }
  // g rows past the tile's pixels stay 0
  for (int e = tid; e < n_kb * FM * 8; e += F_THREADS)
    reinterpret_cast<uint4*>(s_g)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (tid < F_CONS) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // W^T chunk ch (tap ch / n_kb, output channels 64 (ch % n_kb) ..)
    auto issue_w = [&](int ch) {
      const int s = ch % BD_STAGES;
      mbar_arrive_expect_tx(&w_full[s], NCI * 128);
      bulk_load(s_w + s * NCI * 128, wimg + (size_t)ch * NCI * 128,
                NCI * 128, &w_full[s]);
    };
    // chunk ch's products are done in all four warps: its stage takes the
    // chunk BD_STAGES later
    auto release = [&](int ch) {
      named_sync(2, F_CONS);
      if (tid == 0 && ch + BD_STAGES < n_chunks) issue_w(ch + BD_STAGES);
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(g_full, n_kb * n_pix * 128);
      for (int kb = 0; kb < n_kb; ++kb)
        tma_load_4d(s_g + kb * FM * 128, &gmap, kb * 64, tx0, ty0,
                    blockIdx.y, g_full);
      for (int ch = 0; ch < BD_STAGES && ch < n_chunks; ++ch) issue_w(ch);
    }
    float acc[NCI / 2];
#pragma unroll
    for (int i = 0; i < NCI / 2; ++i) acc[i] = 0.f;
    mbar_wait(g_full, 0);
    for (int k = 0; k < 9; ++k) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int ch = k * n_kb + kb;
        const int s = ch % BD_STAGES;
        mbar_wait(&w_full[s], (ch / BD_STAGES) & 1);
        const unsigned char* a = s_g + kb * FM * 128;
        const unsigned char* b = s_w + s * NCI * 128;
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < FK / 16; ++st)
          wgmma<NCI, 0, 0>(acc, desc128(a + 32 * st, 16, 1024),
                           desc128(b + 32 * st, 16, 1024), kb > 0 || st > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (kb > 0) release(ch - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(k * n_kb + n_kb - 1);
      // the tap's dsample rounded to bf16 (the Pallas rounding point) into
      // tile k % 2, once the producers are done with tap k - 2
      const int buf = k & 1;
      if (k >= 2) mbar_wait(&ds_empty[buf], ((k - 2) >> 1) & 1);
      bf16* t = s_ds + buf * FM * LDT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < NCI / 8; ++j)
          *reinterpret_cast<uint32_t*>(t + r * LDT + 8 * j + 2 * (lane & 3)) =
              pack_bf2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      mbar_arrive(&ds_full[buf]);
    }
  } else {
    // ---- producers: per tap, LG lanes own a pixel, 8 channels each
    const int pt = tid - F_CONS;
    for (int e = pt; e < n_pix * 18; e += F_PROD) {
      const int p = e / 18;
      const int y = ty0 + p / tile_w;
      const int xo = tx0 + p % tile_w;
      s_off[e] = y < H && xo < W
                     ? offset[(img + (size_t)y * W + xo) * 18 + e % 18]
                     : 0.f;
    }
    named_sync(1, F_PROD);
    constexpr int LG = NCI / 8;                    // lanes per pixel
    constexpr int PPW = 32 / LG;                   // pixels per warp a round
    constexpr int ROUNDS = FM / (F_PROD / 32 * PPW);
    const int pw = pt >> 5;
    const int lane = pt & 31;
    const int sub = lane / LG;
    const int c = 8 * (lane % LG);
    for (int k = 0; k < 9; ++k) {
      const int buf = k & 1;
      mbar_wait(&ds_full[buf], (k >> 1) & 1);
      const bf16* t = s_ds + buf * FM * LDT;
#pragma unroll 1
      for (int r = 0; r < ROUNDS; ++r) {
        const int p = (r * (F_PROD / 32) + pw) * PPW + sub;
        const int y = ty0 + p / tile_w;
        const int xo = tx0 + p % tile_w;
        const bool live = p < n_pix && y < H && xo < W;
        TapGeom gm{};   // valid = false
        if (live) gm = tap_geom(s_off + p * 18, y, xo, k, H, W, halo);
        int idx[4];
        float m[4];
        tap_corners<true>(gm, 0, H, W, idx, m);
        const uint4 dv = *reinterpret_cast<const uint4*>(t + p * LDT + c);
        uint4 u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u[j] = make_uint4(0, 0, 0, 0);
          if (idx[j] >= 0 && c < Cin)
            u[j] = load8(x + (img + idx[j]) * Cin + c, c, Cin, vec_x);
        }
        const size_t q = img + (size_t)y * W + xo;
        if (live && c < Cin) {
          bf16* dst = ds + (q * 9 + k) * Cin + c;
          if (vec_ds) {
            *reinterpret_cast<uint4*>(dst) = dv;
          } else {
            const uint32_t wd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c + e < Cin)
                dst[e] = __ushort_as_bfloat16((unsigned short)(
                    (e & 1) ? wd[e >> 1] >> 16 : wd[e >> 1] & 0xffffu));
          }
        }
        // corner sums: over this lane's 8 channels in order, then over the
        // pixel's LG lanes in a fixed tree
        float pj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pj[j] = dot8(dv, u[j]);
#pragma unroll
        for (int o = LG / 2; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pj[j] += __shfl_xor_sync(0xffffffffu, pj[j], o);
        if (live && lane % LG == 0) {
          float gy[4], gx[4];
          tap_derivs(gm, idx, gy, gx);
          float sy = 0.f;
          float sx = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sy += gy[j] * pj[j];
            sx += gx[j] * pj[j];
          }
          doff[q * 18 + 2 * k] = sy;
          doff[q * 18 + 2 * k + 1] = sx;
        }
      }
      mbar_arrive(&ds_empty[buf]);
    }
  }
}

// dW pass.  Block (row tile, split) = one tap k x 64 input channels (chunk
// cc) of dW and all NC >= Cout output channels, over the split's range of
// 4 x 16 pixel tiles (tile t: image t / tiles_img, row-major within it).
// Per tile, producer warps gather the samples [FM pixels][64 channels]
// (the forward's gather: tap_geom, tap_corners<true>, 16-byte corner
// loads, software-pipelined, tap k's offsets loaded a tile ahead of their
// corners) into a BW_STAGES ring, 128-byte swizzled, and thread 0 lands g's
// tile [FM pixels][NC] by TMA beside them; one consumer warpgroup runs
// dW_tile[64, NC] += samples^T . g on wgmma, both operands read MN-major
// (TA = TB = 1), and writes the split's partial.
template <int NC>
__global__ void __launch_bounds__(F_THREADS, 1)
dcn_bwd_dw_bf16_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ offset,
                       const __grid_constant__ CUtensorMap gmap,
                       float* __restrict__ part, int H, int W, int Cin,
                       int Cout, int halo, int tiles_x, int tiles_img,
                       int n_tiles, int vec) {
  using namespace hopper;
  extern __shared__ unsigned char wsm_raw[];
  // [S][FM*128] samples, then [S][NC/64][FM*128] g
  unsigned char* s_a =
      wsm_raw + ((1024 - (smem_addr(wsm_raw) & 1023)) & 1023);
  unsigned char* s_b = s_a + BW_STAGES * FM * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + BW_STAGES * NC * 128);
  uint64_t* empty = full + BW_STAGES;

  const int tid = threadIdx.x;
  const int n_cc = (Cin + FK - 1) / FK;
  const int k = blockIdx.x / n_cc;
  const int cc = blockIdx.x % n_cc;
  const int split = blockIdx.y;
  const int t_lo = (int)((long long)split * n_tiles / gridDim.y);
  const int n_my =
      (int)((long long)(split + 1) * n_tiles / gridDim.y) - t_lo;
  const int n_box = (Cout + 63) / 64;   // g's 64-channel boxes a tile

  if (tid == 0) {
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], F_PROD + 1);   // the gather + the g copy
      mbar_init(&empty[s], F_CONS);
    }
    mbar_init_fence();
  }
  // g's blocks past Cout stay 0 (no box lands there)
  for (int e = tid; e < BW_STAGES * NC * 8; e += F_THREADS)
    reinterpret_cast<uint4*>(s_b)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (tid < F_CONS) {
    // ---- consumer: [64 channels, pixels] x [pixels, NC] on wgmma
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_my; ++i) {
      const int s = i % BW_STAGES;
      mbar_wait(&full[s], (i / BW_STAGES) & 1);
      const unsigned char* a = s_a + s * FM * 128;
      const unsigned char* b = s_b + s * NC * 128;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < FM / 16; ++st)
        wgmma<NC, 1, 1>(acc, desc128(a + 2048 * st, FM * 128, 1024),
                        desc128(b + 2048 * st, FM * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();   // tile i-1's products are done: free its stage
      if (i > 0) mbar_arrive(&empty[(i - 1) % BW_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the split's partial: rows k*Cin + cc*64 + r, columns 0 .. Cout-1
    const int warp = tid >> 5;
    const int lane = tid & 31;
    float* dst = part + ((size_t)split * 9 * Cin + (size_t)k * Cin +
                         cc * FK) * Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      if (cc * FK + r >= Cin) continue;
      float* row = dst + (size_t)r * Cout;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        if ((Cout & 1) == 0 && col + 1 < Cout) {
          *reinterpret_cast<float2*>(row + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (col < Cout) row[col] = acc[4 * j + 2 * h];
          if (col + 1 < Cout) row[col + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  } else {
    // ---- producers: thread pt forms the 8 samples of channels c .. c+7
    // of stage row prow[i] (item i), as the forward's producers do
    const int pt = tid - F_CONS;
    const int g8 = 8 * (pt & 7);
    const int c = cc * FK + g8;
    int prow[F_ITEMS];
#pragma unroll
    for (int i = 0; i < F_ITEMS; ++i) prow[i] = (pt + F_PROD * i) >> 3;
    Tap tp[F_ITEMS];       // tap k at the tile being loaded
    uint4 un[F_ITEMS][4];
    float2 on[F_ITEMS];    // tap k's offsets at the tile after it
    size_t img_n = 0;      // first pixel of the loaded tile's image
    auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
      b = t / tiles_img;
      const int r = t - b * tiles_img;
      ty0 = (r / tiles_x) * BW_TH;
      tx0 = (r % tiles_x) * BW_TW;
    };
    auto load_off = [&](int t) {
      int b, ty0, tx0;
      tile_of(t, b, ty0, tx0);
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i) {
        const int y = ty0 + prow[i] / BW_TW;
        const int xo = tx0 + prow[i] % BW_TW;
        on[i] = make_float2(0.f, 0.f);
        if (y < H && xo < W)
          on[i] = __ldg(reinterpret_cast<const float2*>(
              offset + (((size_t)b * H + y) * W + xo) * 18 + 2 * k));
      }
    };
    auto set_tap = [&](int t) {
      int b, ty0, tx0;
      tile_of(t, b, ty0, tx0);
      img_n = (size_t)b * H * W;
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i) {
        const int y = ty0 + prow[i] / BW_TW;
        const int xo = tx0 + prow[i] % BW_TW;
        // a pixel outside the image samples nothing
        TapGeom gm{};   // valid = false
        if (y < H && xo < W)
          gm = tap_geom_at(on[i].x, on[i].y, y, xo, k, H, W, halo);
        tap_corners<true>(gm, 0, H, W, tp[i].idx, tp[i].w);
      }
    };
    auto load_tile = [&]() {
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          un[i][j] = make_uint4(0, 0, 0, 0);
          if (tp[i].idx[j] < 0 || c >= Cin) continue;
          un[i][j] = load8(x + (img_n + tp[i].idx[j]) * Cin + c, c, Cin, vec);
        }
    };
    if (n_my > 0) {
      load_off(t_lo);
      set_tap(t_lo);
      load_tile();
      if (n_my > 1) load_off(t_lo + 1);
    }
    for (int ic = 0; ic < n_my; ++ic) {
      const int s = ic % BW_STAGES;
      uint4 uc[F_ITEMS][4];
      float wc[F_ITEMS][4];
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uc[i][j] = un[i][j];
          wc[i][j] = tp[i].w[j];
        }
      if (ic + 1 < n_my) {
        set_tap(t_lo + ic + 1);
        load_tile();
        if (ic + 2 < n_my) load_off(t_lo + ic + 2);
      }
      mbar_wait(&empty[s], ((ic / BW_STAGES) & 1) ^ 1);
      if (pt == 0) {
        int b, ty0, tx0;
        tile_of(t_lo + ic, b, ty0, tx0);
        mbar_arrive_expect_tx(&full[s], n_box * FM * 128);
        for (int bx = 0; bx < n_box; ++bx)
          tma_load_4d(s_b + s * NC * 128 + bx * FM * 128, &gmap, bx * 64,
                      tx0, ty0, b, &full[s]);
      }
      unsigned char* a = s_a + s * FM * 128;
#pragma unroll
      for (int i = 0; i < F_ITEMS; ++i) {
        const int p = prow[i];
        *reinterpret_cast<uint4*>(a + p * 128 + (((g8 >> 3) ^ (p & 7)) << 4)) =
            corner_samples(uc[i], wc[i]);
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
  }
}

// A 4-D map of g [B, H, W, C] bf16 (C its row stride, a multiple of 8):
// boxes of 64 channels x box_w x box_h pixels of one image, 128-byte
// swizzle, zeros outside the tensor.
bool make_g_map(CUtensorMap* map, const void* g, int B, int H, int W, int C,
                int box_h, int box_w) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(g),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// wgmma width of a channel count <= 256
int wgmma_width(int c) { return c <= 64 ? 64 : c <= 128 ? 128 : 256; }

template <int NCI>
cudaError_t launch_data_bf16(const bf16* x, const float* offset,
                             const unsigned char* wimg, const CUtensorMap& gm,
                             bf16* ds, float* doff, int B, int H, int W,
                             int Cin, int Cout, int halo, int tile_h,
                             int tile_w, int vec_x, int vec_ds,
                             cudaStream_t stream) {
  const size_t smem = bwd_data_smem_bytes<NCI>((Cout + 63) / 64);
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_data_bf16_kernel<NCI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const dim3 grid(tiles_x * ((H + tile_h - 1) / tile_h), B);
  dcn_bwd_data_bf16_kernel<NCI><<<grid, F_THREADS, smem, stream>>>(
      x, offset, wimg, gm, ds, doff, H, W, Cin, Cout, halo, tile_h, tile_w,
      tiles_x, vec_x, vec_ds);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dw_bf16(const bf16* x, const float* offset,
                           const CUtensorMap& gm, float* part, int B, int H,
                           int W, int Cin, int Cout, int halo, int splits,
                           int vec, cudaStream_t stream) {
  const size_t smem = bwd_dw_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_dw_bf16_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + BW_TW - 1) / BW_TW;
  const int tiles_img = tiles_x * ((H + BW_TH - 1) / BW_TH);
  const dim3 grid(9 * ((Cin + FK - 1) / FK), splits);
  dcn_bwd_dw_bf16_kernel<NC><<<grid, F_THREADS, smem, stream>>>(
      x, offset, gm, part, H, W, Cin, Cout, halo, tiles_x, tiles_img,
      B * tiles_img, vec);
  return cudaGetLastError();
}

// The f32 dx pass over ds [B*H*W, 9, Cin] f32.
cudaError_t launch_dx_f32(const float* ds, const float* offset, float* dx,
                          int B, int H, int W, int Cin, int halo,
                          cudaStream_t stream) {
  const size_t dx_bytes = dx_smem_bytes(halo);
  if (dx_bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dx_bytes);
  if (err != cudaSuccess) return err;
  const int n_xtiles = (W + XW - 1) / XW;
  dim3 xgrid(n_xtiles * ((Cin + XC - 1) / XC), (H + XH - 1) / XH, B);
  dcn_bwd_dx_kernel<<<xgrid, NT, dx_bytes, stream>>>(ds, offset, dx, H, W,
                                                     Cin, halo, n_xtiles);
  return cudaGetLastError();
}

// The bf16 dx pass over ds [B*H*W, 9, Cin] bf16, CPL channels a lane.
template <int CPL>
cudaError_t launch_dx_bf16(const bf16* ds, const float* offset, float* dx,
                           int B, int H, int W, int Cin, int halo,
                           cudaStream_t stream) {
  const size_t bytes = dx_bf16_smem_bytes(halo, CPL);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_dx_bf16_kernel<CPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec =
      Cin % CPL == 0 && reinterpret_cast<uintptr_t>(ds) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const dim3 grid((W + XB_COLS - 1) / XB_COLS, (H + XB_ROWS - 1) / XB_ROWS,
                  B);
  dcn_bwd_dx_bf16_kernel<CPL><<<grid, NT, bytes, stream>>>(
      ds, offset, dx, H, W, Cin, halo, vec);
  return cudaGetLastError();
}

int launch_backward_f32(const float* x, const float* offset,
                        const float* weight, const float* g, float* dx,
                        float* doff, float* ds, float* part, float* dw, int B,
                        int H, int W, int Cin, int Cout, int halo, int splits,
                        cudaStream_t stream) {
  const int n_pix = B * H * W;
  const DataSmem sm = data_smem(Cout);
  if (sm.bytes > 232448 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm.bytes);
  if (err != cudaSuccess) return (int)err;
  dcn_bwd_data_kernel<<<(n_pix + BPB - 1) / BPB, NT, sm.bytes, stream>>>(
      x, offset, weight, g, ds, doff, n_pix, H, W, Cin, Cout, halo, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_dx_f32(ds, offset, dx, B, H, W, Cin, halo, stream);
  if (err != cudaSuccess) return (int)err;

  const int n_mtiles = (9 * Cin + TM - 1) / TM;
  const int n_ntiles = (Cout + TN - 1) / TN;
  const int per_split = round_up((n_pix + splits - 1) / splits, KP);
  dim3 grid(n_mtiles * n_ntiles, splits);
  dcn_bwd_weight_kernel<<<grid, NT, 0, stream>>>(
      x, offset, g, part, n_pix, H, W, Cin, Cout, halo, n_ntiles, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = 9 * Cin * Cout;
  dcn_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n,
                                                             splits);
  return (int)cudaGetLastError();
}

int launch_backward_bf16(const bf16* x, const float* offset,
                         const bf16* weight, const bf16* g, void* wimg,
                         float* dx, float* doff, bf16* ds, float* part,
                         float* dw, int B, int H, int W, int Cin, int Cout,
                         int g_stride, int halo, int tile_h, int tile_w,
                         int splits, cudaStream_t stream) {
  if (Cin < 1 || Cin > 256 || Cout < 1 || Cout > 256 || g_stride < Cout ||
      g_stride % 8 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      tile_h < 1 || tile_w < 1 || tile_h * tile_w > FM || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int nci = wgmma_width(Cin);
  const int nc = wgmma_width(Cout);
  const int n_kb = (Cout + 63) / 64;
  // 1. the image of W^T: per tap and 64 output channels, [nci][64]
  const int n_units = 9 * n_kb * nci * 8;
  dcn_wimg_kernel<<<(n_units + 255) / 256, 256, 0, stream>>>(
      weight, static_cast<uint4*>(wimg), Cin, Cout, Cout, 1, nci, n_kb,
      n_units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap gm_data, gm_dw;
  if (!make_g_map(&gm_data, g, B, H, W, g_stride, tile_h, tile_w) ||
      !make_g_map(&gm_dw, g, B, H, W, g_stride, BW_TH, BW_TW))
    return (int)cudaErrorInvalidValue;
  const int vec_x =
      Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_ds =
      Cin % 8 == 0 && reinterpret_cast<uintptr_t>(ds) % 16 == 0;
  const unsigned char* wi = static_cast<const unsigned char*>(wimg);

  // 2. data pass: ds and doff
  err = nci == 64 ? launch_data_bf16<64>(x, offset, wi, gm_data, ds, doff, B,
                                         H, W, Cin, Cout, halo, tile_h,
                                         tile_w, vec_x, vec_ds, stream)
        : nci == 128
            ? launch_data_bf16<128>(x, offset, wi, gm_data, ds, doff, B, H, W,
                                    Cin, Cout, halo, tile_h, tile_w, vec_x,
                                    vec_ds, stream)
            : launch_data_bf16<256>(x, offset, wi, gm_data, ds, doff, B, H, W,
                                    Cin, Cout, halo, tile_h, tile_w, vec_x,
                                    vec_ds, stream);
  if (err != cudaSuccess) return (int)err;

  // 3. dx pass: all of Cin a block, nci / 32 channels a lane
  err = nci == 64 ? launch_dx_bf16<2>(ds, offset, dx, B, H, W, Cin, halo,
                                      stream)
        : nci == 128 ? launch_dx_bf16<4>(ds, offset, dx, B, H, W, Cin, halo,
                                         stream)
                     : launch_dx_bf16<8>(ds, offset, dx, B, H, W, Cin, halo,
                                         stream);
  if (err != cudaSuccess) return (int)err;

  // 4. dW pass: one partial per split
  err = nc == 64 ? launch_dw_bf16<64>(x, offset, gm_dw, part, B, H, W, Cin,
                                      Cout, halo, splits, vec_x, stream)
        : nc == 128 ? launch_dw_bf16<128>(x, offset, gm_dw, part, B, H, W,
                                          Cin, Cout, halo, splits, vec_x,
                                          stream)
                    : launch_dw_bf16<256>(x, offset, gm_dw, part, B, H, W,
                                          Cin, Cout, halo, splits, vec_x,
                                          stream);
  if (err != cudaSuccess) return (int)err;

  // 5. dW = the partials in split order
  const int n = 9 * Cin * Cout;
  dcn_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dw, n,
                                                             splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int (0 = launched).
// Requires Cout % 4 == 0 (float4 stores); the Python wrapper checks shapes.
extern "C" int dcn_forward_f32(const void* x, const void* offset,
                               const void* weight, void* out, int B, int H,
                               int W, int Cin, int Cout, int halo,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_ctiles = (Cout + BN - 1) / BN;
  const int n_ptiles = (W + BP - 1) / BP;
  dim3 grid(n_ptiles * n_ctiles, H, B);
  dcn_fwd_f32_kernel<<<grid, NT, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(weight), static_cast<float*>(out), H, W, Cin,
      Cout, halo, n_ctiles);
  return (int)cudaGetLastError();
}

// bf16 x and weight, f32 offset; out f32 (out_f32 != 0) or bf16; any Cin
// and Cout.  A block owns a tile_h x tile_w pixel tile (<= 64 pixels) and
// n_tile (64, 128 or 256) output channels; `wimg` is scratch for the weight
// image, n_ctiles * 9 * ceil(Cin/64) * n_tile * 64 bf16 (n_ctiles =
// ceil(Cout / n_tile)).  Launches the image and the forward on `stream`;
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int dcn_forward_bf16(const void* x, const void* offset,
                                const void* weight, void* wimg, void* out,
                                int out_f32, int B, int H, int W, int Cin,
                                int Cout, int halo, int tile_h, int tile_w,
                                int n_tile, void* stream) {
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > FM)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* ob = static_cast<const float*>(offset);
  const bf16* wb = static_cast<const bf16*>(weight);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_tile) {
    case 64:
      return launch_fwd_bf16<64>(xb, ob, wb, wimg, out, out_f32, B, H, W, Cin,
                                 Cout, halo, tile_h, tile_w, s);
    case 128:
      return launch_fwd_bf16<128>(xb, ob, wb, wimg, out, out_f32, B, H, W,
                                  Cin, Cout, halo, tile_h, tile_w, s);
    case 256:
      return launch_fwd_bf16<256>(xb, ob, wb, wimg, out, out_f32, B, H, W,
                                  Cin, Cout, halo, tile_h, tile_w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the bf16 forward at n_tile output channels.
extern "C" int dcn_forward_bf16_smem(int n_tile) {
  return n_tile == 64    ? (int)fwd_smem_bytes<64>()
         : n_tile == 128 ? (int)fwd_smem_bytes<128>()
                         : (int)fwd_smem_bytes<256>();
}

// f32 backward: x, weight and g f32, offset f32; writes dx, doff and dw
// ([3, 3, Cin, Cout]), all f32, with scratch `ds` [B*H*W, 9, Cin] f32
// (dsample) and `part` [splits, 9*Cin, Cout] f32 (the dW partials).
// Launches four kernels on `stream`; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int dcn_backward_f32(const void* x, const void* offset,
                                const void* weight, const void* g, void* dx,
                                void* doff, void* ds, void* part, void* dw,
                                int B, int H, int W, int Cin, int Cout,
                                int halo, int splits, void* stream) {
  return launch_backward_f32(
      static_cast<const float*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(weight), static_cast<const float*>(g),
      static_cast<float*>(dx), static_cast<float*>(doff),
      static_cast<float*>(ds), static_cast<float*>(part),
      static_cast<float*>(dw), B, H, W, Cin, Cout, halo, splits,
      (cudaStream_t)stream);
}

// bf16 backward: x, weight and g bf16, offset f32; Cin, Cout <= 256; g's
// rows `g_stride` >= Cout elements apart (a multiple of 8, g 16-byte
// aligned: the TMA unit's rule).  Writes dx, doff and dw (f32), with
// scratch `wimg` (9 * ceil(Cout/64) * wgmma_width(Cin) * 64 bf16: the W^T
// image), `ds` [B*H*W, 9, Cin] bf16 and `part` [splits, 9*Cin, Cout] f32.
// The data pass runs on tile_h x tile_w pixel tiles (<= 64 pixels), the dW
// pass on 4 x 16 tiles in `splits` ranges.  Launches the image, the data,
// dx, dW and reduction passes on `stream`; returns cudaGetLastError() as an
// int (0 = launched; cudaErrorInvalidValue for a shape it does not take or
// a tensor map the driver refuses).
extern "C" int dcn_backward_bf16(const void* x, const void* offset,
                                 const void* weight, const void* g,
                                 void* wimg, void* dx, void* doff, void* ds,
                                 void* part, void* dw, int B, int H, int W,
                                 int Cin, int Cout, int g_stride, int halo,
                                 int tile_h, int tile_w, int splits,
                                 void* stream) {
  return launch_backward_bf16(
      static_cast<const bf16*>(x), static_cast<const float*>(offset),
      static_cast<const bf16*>(weight), static_cast<const bf16*>(g), wimg,
      static_cast<float*>(dx), static_cast<float*>(doff),
      static_cast<bf16*>(ds), static_cast<float*>(part),
      static_cast<float*>(dw), B, H, W, Cin, Cout, g_stride, halo, tile_h,
      tile_w, splits, (cudaStream_t)stream);
}

// Dynamic shared memory of the bf16 backward's dW pass at nc output
// channels per block, and of its data pass at nci input channels with
// c_out output channels.
extern "C" int dcn_bwd_dw_bf16_smem(int nc) {
  return nc == 64    ? (int)bwd_dw_smem_bytes<64>()
         : nc == 128 ? (int)bwd_dw_smem_bytes<128>()
                     : (int)bwd_dw_smem_bytes<256>();
}

extern "C" int dcn_bwd_data_bf16_smem(int nci, int c_out) {
  const int n_kb = (c_out + 63) / 64;
  return nci == 64    ? (int)bwd_data_smem_bytes<64>(n_kb)
         : nci == 128 ? (int)bwd_data_smem_bytes<128>(n_kb)
                      : (int)bwd_data_smem_bytes<256>(n_kb);
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
