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
// MFLOP = ~0.36 TFLOP: 5.4 ms of f32 FMA at 67 TFLOP/s, 2.2 ms as three
// TF32 passes at 494.7 TFLOP/s, 0.36 ms of bf16 tensor-core work at 989
// TFLOP/s.  In bf16, with the contraction on the
// tensor cores, what is left is the gather: 9 taps x 4 corners x Cin bf16
// per output pixel (~8 GB a frame when each sample is formed once), mostly
// L1/L2 hits because neighbouring pixels share corners, and the weights,
// which every block streams through once (L2-resident, 1.2 MB at 256->256).
// The TPU kernel's one-hot-matmul detour is not needed: the GPU gathers
// natively.
//
// f32: the split-TF32 product.  The TPU kernel multiplies in f32 at
// Precision.HIGHEST, itself a sum of products of bf16 parts; here every f32
// product runs on the tensor cores as three TF32 products of split
// operands, a = hi + lo with hi = tf32(a), lo = tf32(a - hi) (hopper.cuh
// split_tf32): A.B = Ahi.Bhi + Ahi.Blo + Alo.Bhi, each product exact and
// summed in f32 (~2^-21 of a product; one TF32 pass, ~2^-11, misses the
// f32 kernels' 1e-4 of max|ref|).  The tensor cores' own f32 sums lose
// more than round-to-nearest, an error that grows with the number of
// accumulations, so the long sums restart their accumulators and add the
// pieces in f32 (below).  TF32 wgmma reads both operands K-major; the
// sampled or staged operand (A) is split in the consumer's registers (the
// register-A form), the other (B) arrives pre-split as two 128-byte-
// swizzled tiles.
// A block with 256 output columns runs two consumer warpgroups of 128
// columns each (64 accumulators a thread beside the TF32 fragments).
//
// f32 forward (dcn_fwd_f32_kernel<NC>), the bf16 forward's structure: a
// 2-D tile of <= 64 output pixels and NC = 64, 128 or 256 output channels
// (all of Cout wherever the card fills: ops/cuda/deform_conv.py
// f32_forward_geometry), chunks of one tap x 32 input channels.  Producer
// warps gather with 16-byte corner loads (4 f32 channels), software-
// pipelined, from offsets staged once, into an f32 A tile [64][36] (rows
// padded so that the consumers' fragment loads hit 32 banks; corner
// weights not rounded: tap_corners<false>); the weights' chunks come from
// an image pre-split into hi and lo parts (dcn_wimg_f32_kernel), one bulk
// copy a part; 2 ring stages at NC = 256 (75 KB each), 4 below.  Each
// consumer loads its A fragments from the stage, splits them and runs the
// three wgmma m64nNk8 of each k8 step, then adds the chunk's sums to its
// running sums in shared memory (a restart every chunk: 7.5e-7 of max|out|
// where every tap gave 2.3e-6 and no restart 1.9e-5).  What bounds it
// (kernel_variants.py dcn_f32, H100, P2 256->256, 2.33 ms): the consumers,
// not the gather (no corner loads saves nothing; one TF32 pass ~0.6 ms,
// the per-chunk sums ~0.55 ms).  128 output channels a block (one consumer
// warpgroup, 4 stages, each sample gathered twice) takes 3.02 ms.
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
// f32 (dcn_backward_f32, the pallas_f32 step), both products split-TF32
// on wgmma, on the bf16 passes' plans (geometry: f32_backward_geometry):
//   1. data pass (dcn_bwd_data_f32_kernel<NCI>): a <= 64-pixel tile and
//      all NCI >= Cin input channels a block; g's tile lands once by TMA
//      (4-D map, 32-channel boxes, 128-byte swizzle: the consumers' split
//      fragment loads hit 32 banks); per tap, dsample [64, NCI] = g . W_k^T
//      over 32-channel chunks of Cout, W_k^T's hi and lo chunks by bulk copy
//      from the transposed image (2 stages at NCI = 256, 3 below).  The
//      consumers write dsample to ds in f32 from their registers (shared
//      memory has no room for an f32 tile beside the ring) and mark the
//      tap done; the producer warps read it back (L2) with the x corners,
//      8 channels a lane, and form the corner sums and doff.
//   2. dx pass: below (the bf16 pass's code on f32 ds).
//   3. dW pass (dcn_bwd_dw_f32_kernel<NC>): one tap x 64 input channels and
//      all NC >= Cout output channels a block, split K over runs of 32
//      pixels of an image (row-major, runs may span rows; TF32 needs both
//      operands K-major, K = pixels, and a 128-byte row is 32 f32 pixels).
//      The producers gather the run's samples with the forward's code into
//      an f32 tile [32 pixels][64 + 8 channels], read transposed (as A =
//      samples^T) into the consumers' registers; B = g^T arrives by TMA as
//      hi and lo tiles [NC][32 pixels] from a transposed, pre-split copy of
//      g (dcn_gsplit_kernel, [2][B][Cout][H*W rounded up to 4]).
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
// corner).  dcn_bwd_dx_kernel<CPL, T> (both dtypes; kernel_variants.py
// named the per-64-channel descriptor builds and scans and the 4-byte ds
// loads of an earlier 64-channel design): 8 x 8 pixels and all of Cin a
// block, Cin/32 channels a lane, one ds load of CPL elements a lane.
// What bounds the backward: ~2x the forward's contraction (dsample and dW,
// each as large as the forward's product) on the tensor cores, the inputs
// and outputs once: 0.887 ms in bf16 at the 12 training shapes, ~5.3 ms
// as three TF32 passes in f32.  Any design that keeps ds has a floor above
// that: ds is 2.45 GB in bf16 (4.9 GB in f32) at those shapes, written
// once and read about four times (once per corner), ~3.7 ms (~7.3 ms) of
// HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;       // threads per block of the dx pass

struct Tap {                  // one (tap, pixel) bilinear sample
  int idx[4];                 // corner pixel index h*W+w, or -1: reads 0
  float w[4];                 // corner weight
};

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
// output tile ctile; warp w of a consumer warpgroup holds pixel rows 16w +
// l/4 (+8) of the wgmma accumulator (hopper.cuh).  Writes OutT in 16-byte
// stores where the row allows them (out_vec), else element by element.
template <int NC, typename OutT>
__device__ __forceinline__ void fwd_epilogue(
    const float (&acc)[NC / 2], OutT* __restrict__ out, size_t img, int H,
    int W, int Cout, int ty0, int tx0, int tile_w, int n_pix, int ctile,
    int out_vec) {
  const int warp = (threadIdx.x >> 5) & 3;   // within its warpgroup
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

// ---- f32 on wgmma: split-TF32 ----

constexpr int TK = 32;           // f32 K per chunk: one 128-byte row
constexpr int TA_FWD = TK + 4;   // f32 row of the forward's A tile [FM]
                                 // (the consumers' fragment loads hit 32
                                 // banks, the producers' 16-byte stores stay
                                 // aligned)
constexpr int TF_ITEMS = FM * (TK / 4) / F_PROD;   // (pixel, 4 channels) each
constexpr int TF_FLUSH = 1;      // forward: chunks summed on the tensor
                                 // cores before they are added to s_tot

// consumer threads of an f32 wgmma kernel with NC output columns a block:
// two warpgroups of 128 columns at NC = 256, else one
template <int NC>
__host__ __device__ constexpr int tf_cons() {
  return NC > 128 ? 256 : 128;
}
template <int NC>
__host__ __device__ constexpr int tf_threads() {
  return tf_cons<NC>() + F_PROD;
}
// ring depth at NC columns: a stage holds 2 x NC x 128 bytes of B (hi and
// lo); the dW pass fits 3 at NC = 256, the forward 2 beside its sums
template <int NC>
__host__ __device__ constexpr int tf_stages() {
  return NC > 128 ? 3 : 4;
}
template <int NC>
__host__ __device__ constexpr int tf_fwd_stages() {
  return NC > 128 ? 2 : 4;
}

// dynamic shared memory of the f32 forward at NC output channels a block:
// the ring, the consumers' per-tap sums [FM][NC], barriers, offsets
template <int NC>
constexpr size_t fwd_f32_smem_bytes() {
  return 1024 +
         (size_t)tf_fwd_stages<NC>() *
             (2 * NC * 128 + sizeof(float) * FM * TA_FWD) +
         sizeof(float) * FM * NC + 2 * tf_fwd_stages<NC>() * 8 +
         sizeof(float) * FM * 18;
}

// The f32 counterpart of dcn_wimg_kernel: for each row tile, tap k and
// 32-wide chunk cc of the contracted dimension, the [nt rows][32] block as
// its two TF32 parts (hopper.cuh split_tf32), hi then lo, each in the
// 128-byte-swizzled K-major layout, zero past `rows` and `kdim`.  Strides as
// dcn_wimg_kernel's.  One thread per 16 bytes.
__global__ void dcn_wimg_f32_kernel(const float* __restrict__ weight,
                                    uint4* __restrict__ img, int rows,
                                    int kdim, int rstride, int kstride,
                                    int nt, int n_cc, int n_units) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_units) return;
  const int n = (e >> 3) % nt;
  int rest = (e >> 3) / nt;
  const int part = rest & 1;
  rest >>= 1;
  const int cc = rest % n_cc;
  rest /= n_cc;
  const int k = rest % 9;
  const int r = (rest / 9) * nt + n;
  const int c0 = cc * TK + (((e & 7) ^ (n & 7)) << 2);
  const float* wk = weight + (size_t)k * rows * kdim + (size_t)r * rstride;
  uint32_t word[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v =
        r < rows && c0 + t < kdim ? wk[(size_t)(c0 + t) * kstride] : 0.f;
    uint32_t hi, lo;
    hopper::split_tf32(v, hi, lo);
    word[t] = part ? lo : hi;
  }
  img[e] = make_uint4(word[0], word[1], word[2], word[3]);
}

// Channels c .. c+3 of one f32 row (src = row + c): one 16-byte load where
// `vec` (Cin % 4 == 0 and a 16-byte aligned tensor), else element loads;
// zeros past Cin.  Read-only data (__ldg).
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int c,
                                        int Cin, int vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  return make_float4(__ldg(src), c + 1 < Cin ? __ldg(src + 1) : 0.f,
                     c + 2 < Cin ? __ldg(src + 2) : 0.f,
                     c + 3 < Cin ? __ldg(src + 3) : 0.f);
}

// 4 samples of one (pixel, tap) from its corners' rows u[j] (4 channels
// each) and weights m[j]: the f32 sum over corners 0..3 of weight x input
__device__ __forceinline__ float4 corner_samples_f32(const float4 (&u)[4],
                                                     const float (&m)[4]) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v.x = fmaf(m[j], u[j].x, v.x);
    v.y = fmaf(m[j], u[j].y, v.y);
    v.z = fmaf(m[j], u[j].z, v.z);
    v.w = fmaf(m[j], u[j].w, v.w);
  }
  return v;
}

// The f32 forward.  Block = one tile_h x tile_w pixel tile (<= FM pixels)
// of one image and NC output channels (tile ctile), chunks of one tap x 32
// input channels through an S-stage ring: the producer warps' A tile (f32
// samples [FM][TA_FWD]) and the weight image's hi and lo chunks [NC][32]
// (thread 0 of the producers, two bulk copies).  Consumer warpgroup cw
// multiplies columns cw * NW .. of the chunk: per k8 step its A fragment,
// split in registers, against B's hi and lo tiles (mma3); it waits for a
// chunk's products before it frees the stage, since they read its B.  The
// tensor cores' f32 sums lose more than round-to-nearest over a long K
// (measured: 1.9e-5 of max|out| over 9 x 256 channels, an error that grows
// with the number of sums), so the accumulators restart every TF_FLUSH
// chunks and each such sum is added in f32, in chunk order, to the
// thread's running sums in shared memory (s_tot, [FM][NC] f32 a block).
template <int NC>
__global__ void __launch_bounds__(tf_threads<NC>(), 1)
dcn_fwd_f32_kernel(const float* __restrict__ x,
                   const float* __restrict__ offset,
                   const unsigned char* __restrict__ wimg,
                   float* __restrict__ out, int H, int W, int Cin, int Cout,
                   int halo, int tile_h, int tile_w, int tiles_x,
                   int n_ctiles, int vec, int out_vec) {
  using namespace hopper;
  constexpr int S = tf_fwd_stages<NC>();
  constexpr int CONS = tf_cons<NC>();
  constexpr int NW = NC * 128 / CONS;   // columns a consumer warpgroup
  extern __shared__ unsigned char tfsm_raw[];
  unsigned char* s_b =
      tfsm_raw + ((1024 - (smem_addr(tfsm_raw) & 1023)) & 1023);
  float* s_a = reinterpret_cast<float*>(s_b + S * 2 * NC * 128);
  // consumer thread t's sum i at s_tot[(i / 4) * CONS * 4 + 4 t + i % 4]
  float* s_tot = s_a + S * FM * TA_FWD;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_tot + FM * NC);
  uint64_t* empty = full + S;
  float* s_off = reinterpret_cast<float*>(empty + S);   // [FM][18]

  const int tid = threadIdx.x;
  const int ctile = blockIdx.x % n_ctiles;
  const int ptile = blockIdx.x / n_ctiles;
  const int ty0 = (ptile / tiles_x) * tile_h;
  const int tx0 = (ptile % tiles_x) * tile_w;
  const int n_pix = tile_h * tile_w;
  const size_t img = (size_t)blockIdx.y * H * W;
  const int n_cc = (Cin + TK - 1) / TK;
  const int n_chunks = 9 * n_cc;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], F_PROD + 1);   // the gather + the weight copies
      mbar_init(&empty[s], CONS);
    }
    mbar_init_fence();
  }
  // A rows past the block's pixels stay 0
  for (int e = tid; e < S * FM * TA_FWD / 4; e += tf_threads<NC>())
    reinterpret_cast<float4*>(s_a)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (tid < CONS) {
    // ---- consumers: [FM, 9*Cin] x [9*Cin, NW] on wgmma, f32 in registers
    const int cw = tid >> 7;
    const int r0 = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    const int q = tid & 3;
    float4* tot = reinterpret_cast<float4*>(s_tot) + tid;
    float acc[NW / 2];
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const float* a = s_a + s * FM * TA_FWD;
      uint32_t ah[TK / 8][4], al[TK / 8][4];
#pragma unroll
      for (int st = 0; st < TK / 8; ++st) {
        const int c = 8 * st + q;
        const float v[4] = {a[r0 * TA_FWD + c], a[(r0 + 8) * TA_FWD + c],
                            a[r0 * TA_FWD + c + 4],
                            a[(r0 + 8) * TA_FWD + c + 4]};
        split_frag(v, ah[st], al[st]);
      }
      const unsigned char* bh = s_b + s * 2 * NC * 128 + cw * NW * 128;
      const unsigned char* bl = bh + NC * 128;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < TK / 8; ++st)
        mma3<NW>(acc, ah[st], al[st], bh + 32 * st, bl + 32 * st,
                 i % TF_FLUSH > 0 || st > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int st = 0; st < TK / 8; ++st) {
        fence_regs(ah[st]);
        fence_regs(al[st]);
      }
      mbar_arrive(&empty[s]);
      if ((i + 1) % TF_FLUSH == 0 || i + 1 == n_chunks) {   // to s_tot
        fence_regs(acc);
#pragma unroll
        for (int v = 0; v < NW / 8; ++v) {
          float4 t = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                                 acc[4 * v + 3]);
          if (i >= TF_FLUSH) {
            const float4 o = tot[v * CONS];
            t = make_float4(o.x + t.x, o.y + t.y, o.z + t.z, o.w + t.w);
          }
          tot[v * CONS] = t;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NW / 8; ++v) {
      const float4 t = tot[v * CONS];
      acc[4 * v] = t.x, acc[4 * v + 1] = t.y, acc[4 * v + 2] = t.z,
              acc[4 * v + 3] = t.w;
    }
    fwd_epilogue<NW, float>(acc, out, img, H, W, Cout, ty0, tx0, tile_w,
                            n_pix, ctile * (NC / NW) + cw, out_vec);
  } else {
    // ---- producers: per chunk (tap k, channels cc*32 ..), thread pt forms
    // the 4 samples of channels 4g .. 4g+3 of pixel p (g = e & 7, p = e >>
    // 3, e = pt + F_PROD*i), software-pipelined as the bf16 forward's
    const int pt = tid - CONS;
    const unsigned char* wsrc =
        wimg + (size_t)ctile * n_chunks * 2 * NC * 128;
    for (int e = pt; e < n_pix * 18; e += F_PROD) {
      const int p = e / 18;
      const int y = ty0 + p / tile_w;
      const int xo = tx0 + p % tile_w;
      s_off[e] = y < H && xo < W
                     ? offset[(img + (size_t)y * W + xo) * 18 + e % 18]
                     : 0.f;
    }
    named_sync(1, F_PROD);
    int pix[TF_ITEMS];   // pixel of item i, -1 past the tile
#pragma unroll
    for (int i = 0; i < TF_ITEMS; ++i) {
      const int p = (pt + F_PROD * i) >> 3;
      pix[i] = p < n_pix ? p : -1;
    }
    const int g4 = 4 * (pt & 7);   // the items' channel offset in a chunk
    Tap tp[TF_ITEMS];   // the tap of the chunk being loaded
    float4 un[TF_ITEMS][4];
    auto set_tap = [&](int k) {
#pragma unroll
      for (int i = 0; i < TF_ITEMS; ++i) {
        const int p = pix[i] < 0 ? 0 : pix[i];
        const int y = ty0 + p / tile_w;
        const int xo = tx0 + p % tile_w;
        TapGeom gm{};   // valid = false: samples nothing
        if (pix[i] >= 0 && y < H && xo < W)
          gm = tap_geom(s_off + p * 18, y, xo, k, H, W, halo);
        tap_corners<false>(gm, 0, H, W, tp[i].idx, tp[i].w);
      }
    };
    auto load_chunk = [&](int cc) {
      const int c = cc * TK + g4;
#pragma unroll
      for (int i = 0; i < TF_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          un[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (tp[i].idx[j] < 0 || c >= Cin) continue;
          un[i][j] = load4(x + (img + tp[i].idx[j]) * Cin + c, c, Cin, vec);
        }
    };
    set_tap(0);
    load_chunk(0);
    for (int ic = 0; ic < n_chunks; ++ic) {
      const int s = ic % S;
      float4 uc[TF_ITEMS][4];
      float wc[TF_ITEMS][4];
#pragma unroll
      for (int i = 0; i < TF_ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uc[i][j] = un[i][j];
          wc[i][j] = tp[i].w[j];
        }
      if (ic + 1 < n_chunks) {
        if ((ic + 1) % n_cc == 0) set_tap((ic + 1) / n_cc);
        load_chunk((ic + 1) % n_cc);
      }
      mbar_wait(&empty[s], ((ic / S) & 1) ^ 1);
      if (pt == 0) {
        unsigned char* dst = s_b + s * 2 * NC * 128;
        const unsigned char* src = wsrc + (size_t)ic * 2 * NC * 128;
        mbar_arrive_expect_tx(&full[s], 2 * NC * 128);
        bulk_load(dst, src, NC * 128, &full[s]);
        bulk_load(dst + NC * 128, src + NC * 128, NC * 128, &full[s]);
      }
      float* a = s_a + s * FM * TA_FWD;
#pragma unroll
      for (int i = 0; i < TF_ITEMS; ++i) {
        if (pix[i] < 0) continue;
        *reinterpret_cast<float4*>(a + pix[i] * TA_FWD + g4) =
            corner_samples_f32(uc[i], wc[i]);
      }
      mbar_arrive(&full[s]);
    }
  }
}

template <int NC>
int launch_fwd_f32(const float* x, const float* offset, const float* weight,
                   void* wimg, float* out, int B, int H, int W, int Cin,
                   int Cout, int halo, int tile_h, int tile_w,
                   cudaStream_t stream) {
  const int n_cc = (Cin + TK - 1) / TK;
  const int n_ctiles = (Cout + NC - 1) / NC;
  const int n_units = n_ctiles * 9 * n_cc * 2 * NC * 8;
  dcn_wimg_f32_kernel<<<(n_units + 255) / 256, 256, 0, stream>>>(
      weight, static_cast<uint4*>(wimg), Cout, Cin, 1, Cout, NC, n_cc,
      n_units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_f32_smem_bytes<NC>();
  err = cudaFuncSetAttribute(dcn_fwd_f32_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const dim3 grid(tiles_y * tiles_x * n_ctiles, B);
  const int vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int out_vec =
      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dcn_fwd_f32_kernel<NC><<<grid, tf_threads<NC>(), smem, stream>>>(
      x, offset, static_cast<const unsigned char*>(wimg), out, H, W, Cin,
      Cout, halo, tile_h, tile_w, tiles_x, n_ctiles, vec, out_vec);
  return (int)cudaGetLastError();
}

// ---- backward: the dx pass (both dtypes) ----
//
// A gather over a window of output pixels, with all of Cin in one block: a
// block owns XB_ROWS x XB_COLS input pixels of one image (a warp a row) and
// every channel, CPL = NCI / 32 channels a lane, so a window's descriptors
// are built once for all channels, a warp's scan of a window row serves all
// channels, and a ds row comes in one load of CPL elements a lane.  The
// sums live in shared memory, CPL contiguous floats a lane and column
// (kernel_variants.py: registers picked by a uniform branch on the column
// cost ~0.9 ms more at P2 of the training crop).  Every sum runs in one
// order: output row, column, tap, corner.
constexpr int kNoRow = -(1 << 28);   // DxTap.y0 of a tap that samples nothing

struct DxTap {                // one (output pixel, tap) of the dx pass
  int y0, x0;                 // top-left corner of the clamped sample
  float w[4];                 // corner weights M (0 outside the image)
};

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

size_t dx_smem_bytes(int halo, int cpl) {
  return sizeof(float) * XB_ROWS * XB_COLS * 32 * cpl +
         sizeof(DxTap) * (size_t)(XB_COLS + 2 * halo + 3) * 9;
}

// CPL channels c .. c+CPL-1 of one ds row, as f32 (0 past Cin): one load
// of CPL elements where `vec` (Cin % CPL == 0, ds 16-byte aligned)
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
__device__ __forceinline__ void load_ds(const float* __restrict__ row, int c,
                                        int Cin, int vec, float (&d)[CPL]) {
  if (vec && c < Cin) {
    if constexpr (CPL == 2) {
      const float2 u = __ldg(reinterpret_cast<const float2*>(row + c));
      d[0] = u.x, d[1] = u.y;
    } else {
#pragma unroll
      for (int t = 0; t < CPL / 4; ++t) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(row + c) + t);
        d[4 * t] = u.x, d[4 * t + 1] = u.y, d[4 * t + 2] = u.z,
                  d[4 * t + 3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < CPL; ++t) d[t] = c + t < Cin ? row[c + t] : 0.f;
  }
}

// dx [B, H, W, Cin] f32 = the sum over the taps whose corners land on each
// input pixel of M x dsample, from ds [B*H*W, 9, Cin] in T (bf16: the
// weights M rounded to bf16, as the bf16 kernels round them); every
// element written, each sum in one fixed order.
template <int CPL, typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_dx_kernel(const T* __restrict__ ds, const float* __restrict__ offset,
                  float* __restrict__ dx, int H, int W, int Cin, int halo,
                  int vec) {
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
      tap_corners<std::is_same<T, bf16>::value>(gm, 0, H, W, idx, t.w);
      t.y0 = gm.valid ? gm.y0 : kNoRow;
      t.x0 = gm.x0;
      s_tap[e] = t;
    }
    __syncthreads();
    if (yi >= H) continue;   // warp-uniform; the loop's barriers still run
    const T* ds_row = ds + (img + (size_t)y * W + xlo) * 9 * Cin;
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

// ---- f32 backward on wgmma: split-TF32 ----

constexpr int TW_RUN = 32;       // dW pass: pixels a stage, one run of an
                                 // image (a 128-byte row of g^T)
constexpr int TA_DW = FK + 8;    // f32 row of the dW pass's sample tile
                                 // [TW_RUN] (the consumers' transposed
                                 // fragment loads hit 32 banks)
constexpr int TW_FLUSH = 16;     // dW pass: runs summed on the tensor cores
                                 // before they are added to the partial

// ring depth of the f32 data pass's W^T chunks (2 x NCI x 128 bytes each):
// 2 fit beside g's tile at NCI = 256
template <int NCI>
__host__ __device__ constexpr int tfd_stages() {
  return NCI > 128 ? 2 : 3;
}

// dynamic shared memory of the f32 data pass at NCI input channels a block
// with n_kb 32-channel chunks of Cout in its g tile, and of the f32 dW pass
// at NC output channels a block
template <int NCI>
constexpr size_t bwd_data_f32_smem_bytes(int n_kb) {
  return 1024 + (size_t)n_kb * FM * 128 +
         (size_t)tfd_stages<NCI>() * 2 * NCI * 128 + sizeof(float) * FM * 18 +
         (1 + tfd_stages<NCI>() + 9) * 8;
}

template <int NC>
constexpr size_t bwd_dw_f32_smem_bytes() {
  return 1024 +
         (size_t)tf_stages<NC>() *
             (2 * NC * 128 + sizeof(float) * TW_RUN * TA_DW) +
         2 * tf_stages<NC>() * 8;
}

// f32 data pass.  Block = one tile_h x tile_w pixel tile (<= FM pixels) of
// one image and all NCI >= Cin input channels.  g's tile lands once by TMA
// as n_kb boxes [FM pixels][32 channels], 128-byte swizzled; per tap k,
// dsample[FM, NCI] = g . W_k^T over the chunks of Cout, the W_k^T chunks'
// hi and lo parts [NCI][32] streaming through an S-stage ring by bulk copy
// (consumer thread 0 refills a stage once every consumer is done with it).
// Consumer warpgroup cw owns columns cw * NW ..; it writes its dsample to
// ds from registers and arrives on ds_ready[k]; the producer warps then
// read the tap's dsample back with the corners of x and form the corner
// sums and doff, while the consumers multiply the next tap.
template <int NCI>
__global__ void __launch_bounds__(tf_threads<NCI>(), 1)
dcn_bwd_data_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ offset,
                        const unsigned char* __restrict__ wimg,
                        const __grid_constant__ CUtensorMap gmap, float* ds,
                        float* __restrict__ doff, int H, int W, int Cin,
                        int Cout, int halo, int tile_h, int tile_w,
                        int tiles_x, int vec_x, int vec_ds) {
  using namespace hopper;
  constexpr int S = tfd_stages<NCI>();
  constexpr int CONS = tf_cons<NCI>();
  constexpr int NW = NCI * 128 / CONS;
  extern __shared__ unsigned char tdsm_raw[];
  const int n_kb = (Cout + TK - 1) / TK;
  const int n_chunks = 9 * n_kb;
  // [n_kb][FM*128] g, then [S][hi, lo][NCI*128] W^T
  unsigned char* s_g =
      tdsm_raw + ((1024 - (smem_addr(tdsm_raw) & 1023)) & 1023);
  unsigned char* s_w = s_g + n_kb * FM * 128;
  float* s_off = reinterpret_cast<float*>(s_w + S * 2 * NCI * 128);
  uint64_t* g_full = reinterpret_cast<uint64_t*>(s_off + FM * 18);
  uint64_t* w_full = g_full + 1;
  uint64_t* ds_ready = w_full + S;   // [9]: tap k's dsample is in ds

  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / tiles_x) * tile_h;
  const int tx0 = (blockIdx.x % tiles_x) * tile_w;
  const int n_pix = tile_h * tile_w;
  const size_t img = (size_t)blockIdx.y * H * W;

  if (tid == 0) {
    mbar_init(g_full, 1);
    for (int s = 0; s < S; ++s) mbar_init(&w_full[s], 1);
    for (int k = 0; k < 9; ++k) mbar_init(&ds_ready[k], CONS);
    mbar_init_fence();
  }
  // g rows past the tile's pixels stay 0
  for (int e = tid; e < n_kb * FM * 8; e += tf_threads<NCI>())
    reinterpret_cast<uint4*>(s_g)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (tid < CONS) {
    const int cw = tid >> 7;
    const int r0 = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    const int q = tid & 3;
    // W^T chunk ch (tap ch / n_kb, output channels 32 (ch % n_kb) ..)
    auto issue_w = [&](int ch) {
      const int s = ch % S;
      unsigned char* dst = s_w + s * 2 * NCI * 128;
      const unsigned char* src = wimg + (size_t)ch * 2 * NCI * 128;
      mbar_arrive_expect_tx(&w_full[s], 2 * NCI * 128);
      bulk_load(dst, src, NCI * 128, &w_full[s]);
      bulk_load(dst + NCI * 128, src + NCI * 128, NCI * 128, &w_full[s]);
    };
    if (tid == 0) {
      mbar_arrive_expect_tx(g_full, n_kb * n_pix * 128);
      for (int kb = 0; kb < n_kb; ++kb)
        tma_load_4d(s_g + kb * FM * 128, &gmap, kb * TK, tx0, ty0,
                    blockIdx.y, g_full);
      for (int ch = 0; ch < S && ch < n_chunks; ++ch) issue_w(ch);
    }
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    mbar_wait(g_full, 0);
    for (int k = 0; k < 9; ++k) {
      for (int kb = 0; kb < n_kb; ++kb) {
        const int ch = k * n_kb + kb;
        const int s = ch % S;
        // the fragments of g's box kb: element (r, c) lies at r*128 +
        // ((c/4 ^ r%8) * 16) + (c%4) * 4 (the 128-byte swizzle)
        const unsigned char* a = s_g + kb * FM * 128;
        uint32_t ah[TK / 8][4], al[TK / 8][4];
#pragma unroll
        for (int st = 0; st < TK / 8; ++st) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + 8 * (j & 1);
            const int c16 = 2 * st + (j >> 1);
            v[j] = *reinterpret_cast<const float*>(
                a + r * 128 + ((c16 ^ (r & 7)) << 4) + 4 * q);
          }
          split_frag(v, ah[st], al[st]);
        }
        mbar_wait(&w_full[s], (ch / S) & 1);
        const unsigned char* bh = s_w + s * 2 * NCI * 128 + cw * NW * 128;
        const unsigned char* bl = bh + NCI * 128;
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < TK / 8; ++st)
          mma3<NW>(acc, ah[st], al[st], bh + 32 * st, bl + 32 * st,
                   kb > 0 || st > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int st = 0; st < TK / 8; ++st) {
          fence_regs(ah[st]);
          fence_regs(al[st]);
        }
        // every consumer is done with stage s: it takes chunk ch + S
        named_sync(2, CONS);
        if (tid == 0 && ch + S < n_chunks) issue_w(ch + S);
      }
      fence_regs(acc);
      // the tap's dsample, f32, to ds: rows 16w + l/4 (+8), columns cw*NW +
      // 8j + 2(l%4) (+1)
      const int nlim = Cin - cw * NW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = r0 + 8 * h;
        const int y = ty0 + p / tile_w;
        const int xo = tx0 + p % tile_w;
        if (p >= n_pix || y >= H || xo >= W) continue;
        float* row =
            ds + ((img + (size_t)y * W + xo) * 9 + k) * Cin + cw * NW;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = 8 * j + 2 * q;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (vec_ds && col + 1 < nlim) {
            *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
          } else {
            if (col < nlim) row[col] = v0;
            if (col + 1 < nlim) row[col + 1] = v1;
          }
        }
      }
      __threadfence_block();
      mbar_arrive(&ds_ready[k]);
    }
  } else {
    // ---- producers: per tap, LG lanes own a pixel, 8 channels each
    const int pt = tid - CONS;
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
      mbar_wait(&ds_ready[k], 0);
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
        tap_corners<false>(gm, 0, H, W, idx, m);
        const size_t qp = img + (size_t)y * W + xo;
        // the lane's 8 channels of dsample (written in this kernel: plain
        // loads) and of each corner of x
        float d[8], u[4][8];
#pragma unroll
        for (int t = 0; t < 8; ++t) d[t] = 0.f;
        if (live && c < Cin) {
          const float* src = ds + (qp * 9 + k) * Cin + c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (c + 4 * h >= Cin) continue;
            if (vec_ds) {
              const float4 v = *reinterpret_cast<const float4*>(src + 4 * h);
              d[4 * h] = v.x, d[4 * h + 1] = v.y, d[4 * h + 2] = v.z,
                    d[4 * h + 3] = v.w;
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                d[4 * h + t] = c + 4 * h + t < Cin ? src[4 * h + t] : 0.f;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx[j] >= 0 && c + 4 * h < Cin)
              v = load4(x + (img + idx[j]) * Cin + c + 4 * h, c + 4 * h, Cin,
                        vec_x);
            u[j][4 * h] = v.x, u[j][4 * h + 1] = v.y, u[j][4 * h + 2] = v.z,
                     u[j][4 * h + 3] = v.w;
          }
        // corner sums: over this lane's 8 channels in order, then over the
        // pixel's LG lanes in a fixed tree
        float pj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pj[j] = 0.f;
#pragma unroll
          for (int t = 0; t < 8; ++t) pj[j] = fmaf(d[t], u[j][t], pj[j]);
        }
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
          doff[qp * 18 + 2 * k] = sy;
          doff[qp * 18 + 2 * k + 1] = sx;
        }
      }
    }
  }
}

// f32 dW pass.  Block (row tile, split) = one tap k x 64 input channels
// (chunk cc) of dW and all NC >= Cout output channels, over the split's
// range of runs (run t: pixels 32 (t % runs_img) .. of image t / runs_img,
// row-major).  Per run, the producer warps gather the samples [32 pixels]
// [64 channels] with the forward's code (tap k's offsets loaded a run
// ahead of their corners) into an S-stage ring of f32 tiles [TW_RUN]
// [TA_DW], and thread 0 lands g^T's hi and lo tiles [NC][32 pixels] by TMA
// beside them; consumer warpgroup cw runs dW_tile[64, NW] += samples^T .
// g over its columns cw * NW .., A = samples^T read transposed from the
// tile into registers and split there.  The tensor cores' f32 sums of a
// long K lose more than round-to-nearest would (measured: 1.3e-4 of
// max|dW| over ~14,500 pixels a split at P2 of the training crop), so the
// accumulators restart every TW_FLUSH runs and each such sum is added to
// the split's partial in f32, in order (the first one stored).
template <int NC>
__global__ void __launch_bounds__(tf_threads<NC>(), 1)
dcn_bwd_dw_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const __grid_constant__ CUtensorMap ghi,
                      const __grid_constant__ CUtensorMap glo,
                      float* __restrict__ part, int H, int W, int Cin,
                      int Cout, int halo, int runs_img, int n_runs,
                      int vec) {
  using namespace hopper;
  constexpr int S = tf_stages<NC>();
  constexpr int CONS = tf_cons<NC>();
  constexpr int NW = NC * 128 / CONS;
  constexpr int ITEMS = TW_RUN * (FK / 4) / F_PROD;   // (pixel, 4 channels)
  extern __shared__ unsigned char twsm_raw[];
  // [S][hi, lo][NC*128] g^T, then [S][TW_RUN][TA_DW] samples
  unsigned char* s_b =
      twsm_raw + ((1024 - (smem_addr(twsm_raw) & 1023)) & 1023);
  float* s_a = reinterpret_cast<float*>(s_b + S * 2 * NC * 128);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_a + S * TW_RUN * TA_DW);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int n_cc = (Cin + FK - 1) / FK;
  const int k = blockIdx.x / n_cc;
  const int cc = blockIdx.x % n_cc;
  const int split = blockIdx.y;
  const int t_lo = (int)((long long)split * n_runs / gridDim.y);
  const int n_my = (int)((long long)(split + 1) * n_runs / gridDim.y) - t_lo;
  const int HW = H * W;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], F_PROD + 1);   // the gather + the g^T copies
      mbar_init(&empty[s], CONS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < CONS) {
    // ---- consumers: [64 channels, pixels] x [pixels, NW] on wgmma
    const int cw = tid >> 7;
    const int m0 = 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2);
    const int q = tid & 3;
    // this thread's elements of the split's partial: rows m0 (+8) of
    // k*Cin + cc*64 .., columns cw*NW + 8j + 2q (+1); dW_tile's sum of the
    // runs since the last flush added to them (stored at the first flush)
    const int q2 = 2 * q;
    float* dst = part + ((size_t)split * 9 * Cin + (size_t)k * Cin +
                         cc * FK) * Cout + cw * NW;
    const int nlim = Cout - cw * NW;
    float acc[NW / 2];
    auto flush = [&](bool add) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 8 * h;
        if (cc * FK + r >= Cin) continue;
        float* row = dst + (size_t)r * Cout;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = 8 * j + q2;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if ((Cout & 1) == 0 && col + 1 < nlim) {
            float2* p2 = reinterpret_cast<float2*>(row + col);
            if (add) {
              const float2 o = *p2;
              v0 = o.x + v0, v1 = o.y + v1;
            }
            *p2 = make_float2(v0, v1);
          } else {
            if (col < nlim) row[col] = add ? row[col] + v0 : v0;
            if (col + 1 < nlim) row[col + 1] = add ? row[col + 1] + v1 : v1;
          }
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n_my; ++i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      const float* a = s_a + s * TW_RUN * TA_DW;
      uint32_t ah[TW_RUN / 8][4], al[TW_RUN / 8][4];
#pragma unroll
      for (int st = 0; st < TW_RUN / 8; ++st) {
        const int p = 8 * st + q;   // A's column: the pixel; row: channel
        const float v[4] = {a[p * TA_DW + m0], a[p * TA_DW + m0 + 8],
                            a[(p + 4) * TA_DW + m0],
                            a[(p + 4) * TA_DW + m0 + 8]};
        split_frag(v, ah[st], al[st]);
      }
      const unsigned char* bh = s_b + s * 2 * NC * 128 + cw * NW * 128;
      const unsigned char* bl = bh + NC * 128;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < TW_RUN / 8; ++st)
        mma3<NW>(acc, ah[st], al[st], bh + 32 * st, bl + 32 * st,
                 i % TW_FLUSH > 0 || st > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int st = 0; st < TW_RUN / 8; ++st) {
        fence_regs(ah[st]);
        fence_regs(al[st]);
      }
      mbar_arrive(&empty[s]);
      if ((i + 1) % TW_FLUSH == 0 || i + 1 == n_my) {
        fence_regs(acc);
        flush(i >= TW_FLUSH);
      }
    }
    if (n_my == 0) flush(false);   // an empty range: its partial is 0
  } else {
    // ---- producers: thread pt forms the 4 samples of channels c .. c+3 of
    // run pixel prow[i] (item i)
    const int pt = tid - CONS;
    const int g4 = 4 * (pt & 15);
    const int c = cc * FK + g4;
    int prow[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) prow[i] = (pt + F_PROD * i) >> 4;
    Tap tp[ITEMS];        // tap k at the run being loaded
    float4 un[ITEMS][4];
    float2 on[ITEMS];     // tap k's offsets at the run after it
    size_t img_n = 0;     // first pixel of the loaded run's image
    auto run_of = [&](int t, int& b, int& p0) {
      b = t / runs_img;
      p0 = (t - b * runs_img) * TW_RUN;
    };
    auto load_off = [&](int t) {
      int b, p0;
      run_of(t, b, p0);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int f = p0 + prow[i];
        on[i] = make_float2(0.f, 0.f);
        if (f < HW)
          on[i] = __ldg(reinterpret_cast<const float2*>(
              offset + ((size_t)b * HW + f) * 18 + 2 * k));
      }
    };
    auto set_tap = [&](int t) {
      int b, p0;
      run_of(t, b, p0);
      img_n = (size_t)b * HW;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int f = p0 + prow[i];
        // a pixel past the image samples nothing
        TapGeom gm{};   // valid = false
        if (f < HW)
          gm = tap_geom_at(on[i].x, on[i].y, f / W, f % W, k, H, W, halo);
        tap_corners<false>(gm, 0, H, W, tp[i].idx, tp[i].w);
      }
    };
    auto load_run = [&]() {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          un[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (tp[i].idx[j] < 0 || c >= Cin) continue;
          un[i][j] = load4(x + (img_n + tp[i].idx[j]) * Cin + c, c, Cin, vec);
        }
    };
    if (n_my > 0) {
      load_off(t_lo);
      set_tap(t_lo);
      load_run();
      if (n_my > 1) load_off(t_lo + 1);
    }
    for (int ic = 0; ic < n_my; ++ic) {
      const int s = ic % S;
      float4 uc[ITEMS][4];
      float wc[ITEMS][4];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uc[i][j] = un[i][j];
          wc[i][j] = tp[i].w[j];
        }
      if (ic + 1 < n_my) {
        set_tap(t_lo + ic + 1);
        load_run();
        if (ic + 2 < n_my) load_off(t_lo + ic + 2);
      }
      mbar_wait(&empty[s], ((ic / S) & 1) ^ 1);
      if (pt == 0) {
        int b, p0;
        run_of(t_lo + ic, b, p0);
        unsigned char* dst = s_b + s * 2 * NC * 128;
        mbar_arrive_expect_tx(&full[s], 2 * NC * 128);
        tma_load_3d(dst, &ghi, p0, 0, b, &full[s]);
        tma_load_3d(dst + NC * 128, &glo, p0, 0, b, &full[s]);
      }
      float* a = s_a + s * TW_RUN * TA_DW;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        *reinterpret_cast<float4*>(a + prow[i] * TA_DW + g4) =
            corner_samples_f32(uc[i], wc[i]);
      mbar_arrive(&full[s]);
    }
  }
}

// g [B, HW, C] f32 (rows g_stride apart) -> gt [2][B][C][HWp]: the
// transposed copy of g that the f32 dW pass's TMA reads K-major (pixels
// contiguous), as its two TF32 parts (hi, then lo), zero past HW.  32 x 32
// tiles through shared memory; grid (HWp / 32, C / 32, B) rounded up,
// 32 x 8 threads.
__global__ void dcn_gsplit_kernel(const float* __restrict__ g,
                                  float* __restrict__ gt, int HW, int C,
                                  int g_stride, int HWp) {
  __shared__ float tile[32][33];
  const int p0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const int b = blockIdx.z;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int r = 0; r < 32; r += 8) {
    const int p = p0 + ty + r;
    const int c = c0 + tx;
    tile[ty + r][tx] =
        p < HW && c < C ? g[((size_t)b * HW + p) * g_stride + c] : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)gridDim.z * C * HWp;
#pragma unroll
  for (int r = 0; r < 32; r += 8) {
    const int c = c0 + ty + r;
    const int p = p0 + tx;
    if (c >= C || p >= HWp) continue;
    uint32_t hi, lo;
    hopper::split_tf32(tile[tx][ty + r], hi, lo);
    const size_t o = ((size_t)b * C + c) * HWp + p;
    gt[o] = __uint_as_float(hi);
    gt[plane + o] = __uint_as_float(lo);
  }
}

// A 4-D map of g [B, H, W, C] (C its row stride: 16-byte rows) of
// elements of `esize` bytes: boxes of box_c channels (128 bytes) x box_w x
// box_h pixels of one image, 128-byte swizzle, zeros outside the tensor.
bool make_g_map(CUtensorMap* map, const void* g, CUtensorMapDataType dtype,
                int esize, int box_c, int B, int H, int W, int C, int box_h,
                int box_w) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esize,
                                 (cuuint64_t)W * C * esize,
                                 (cuuint64_t)H * W * C * esize};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(g), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map of one part of g^T [B, C, HWp] f32 (HWp a multiple of 4):
// boxes of 32 pixels x `rows` channels of one image, 128-byte swizzle,
// zeros outside the tensor.
bool make_gt_map(CUtensorMap* map, const float* gt, int B, int C, int HWp,
                 int rows) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HWp, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)HWp * 4,
                                 (cuuint64_t)C * HWp * 4};
  const cuuint32_t box[3] = {TW_RUN, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(gt), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
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

template <int NCI>
cudaError_t launch_data_f32(const float* x, const float* offset,
                            const unsigned char* wimg, const CUtensorMap& gm,
                            float* ds, float* doff, int B, int H, int W,
                            int Cin, int Cout, int halo, int tile_h,
                            int tile_w, int vec_x, int vec_ds,
                            cudaStream_t stream) {
  const size_t smem = bwd_data_f32_smem_bytes<NCI>((Cout + TK - 1) / TK);
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_data_f32_kernel<NCI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const dim3 grid(tiles_x * ((H + tile_h - 1) / tile_h), B);
  dcn_bwd_data_f32_kernel<NCI><<<grid, tf_threads<NCI>(), smem, stream>>>(
      x, offset, wimg, gm, ds, doff, H, W, Cin, Cout, halo, tile_h, tile_w,
      tiles_x, vec_x, vec_ds);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_dw_f32(const float* x, const float* offset,
                          const CUtensorMap& ghi, const CUtensorMap& glo,
                          float* part, int B, int H, int W, int Cin, int Cout,
                          int halo, int splits, int vec,
                          cudaStream_t stream) {
  const size_t smem = bwd_dw_f32_smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_dw_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int runs_img = (H * W + TW_RUN - 1) / TW_RUN;
  const dim3 grid(9 * ((Cin + FK - 1) / FK), splits);
  dcn_bwd_dw_f32_kernel<NC><<<grid, tf_threads<NC>(), smem, stream>>>(
      x, offset, ghi, glo, part, H, W, Cin, Cout, halo, runs_img,
      B * runs_img, vec);
  return cudaGetLastError();
}

// The dx pass over ds [B*H*W, 9, Cin] in T, CPL channels a lane.
template <int CPL, typename T>
cudaError_t launch_dx(const T* ds, const float* offset, float* dx, int B,
                      int H, int W, int Cin, int halo, cudaStream_t stream) {
  const size_t bytes = dx_smem_bytes(halo, CPL);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_dx_kernel<CPL, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int vec =
      Cin % CPL == 0 && reinterpret_cast<uintptr_t>(ds) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const dim3 grid((W + XB_COLS - 1) / XB_COLS, (H + XB_ROWS - 1) / XB_ROWS,
                  B);
  dcn_bwd_dx_kernel<CPL, T><<<grid, NT, bytes, stream>>>(ds, offset, dx, H, W,
                                                         Cin, halo, vec);
  return cudaGetLastError();
}

// ... at nci / 32 channels a lane (all of Cin a block)
template <typename T>
cudaError_t launch_dx_all(int nci, const T* ds, const float* offset,
                          float* dx, int B, int H, int W, int Cin, int halo,
                          cudaStream_t stream) {
  return nci == 64    ? launch_dx<2, T>(ds, offset, dx, B, H, W, Cin, halo,
                                        stream)
         : nci == 128 ? launch_dx<4, T>(ds, offset, dx, B, H, W, Cin, halo,
                                        stream)
                      : launch_dx<8, T>(ds, offset, dx, B, H, W, Cin, halo,
                                        stream);
}

int launch_backward_f32(const float* x, const float* offset,
                        const float* weight, const float* g, void* wimg,
                        float* gt, float* dx, float* doff, float* ds,
                        float* part, float* dw, int B, int H, int W, int Cin,
                        int Cout, int g_stride, int halo, int tile_h,
                        int tile_w, int splits, cudaStream_t stream) {
  if (Cin < 1 || Cin > 256 || Cout < 1 || Cout > 256 || g_stride < Cout ||
      g_stride % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gt) % 16 != 0 || tile_h < 1 ||
      tile_w < 1 || tile_h * tile_w > FM || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int nci = wgmma_width(Cin);
  const int nc = wgmma_width(Cout);
  const int n_kb = (Cout + TK - 1) / TK;
  const int HW = H * W;
  const int HWp = (HW + 3) / 4 * 4;
  // 1. the image of W^T: per tap and 32 output channels, [nci][32] hi, lo
  const int n_units = 9 * n_kb * 2 * nci * 8;
  dcn_wimg_f32_kernel<<<(n_units + 255) / 256, 256, 0, stream>>>(
      weight, static_cast<uint4*>(wimg), Cin, Cout, Cout, 1, nci, n_kb,
      n_units);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. g^T's two parts for the dW pass
  dcn_gsplit_kernel<<<dim3((HWp + 31) / 32, (Cout + 31) / 32, B), dim3(32, 8),
                      0, stream>>>(g, gt, HW, Cout, g_stride, HWp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* gt_lo = gt + (size_t)B * Cout * HWp;
  CUtensorMap gm_data, gm_hi, gm_lo;
  if (!make_g_map(&gm_data, g, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, TK, B, H,
                  W, g_stride, tile_h, tile_w) ||
      !make_gt_map(&gm_hi, gt, B, Cout, HWp, nc) ||
      !make_gt_map(&gm_lo, gt_lo, B, Cout, HWp, nc))
    return (int)cudaErrorInvalidValue;
  const int vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_ds =
      Cin % 4 == 0 && reinterpret_cast<uintptr_t>(ds) % 16 == 0;
  const unsigned char* wi = static_cast<const unsigned char*>(wimg);

  // 3. data pass: ds and doff
  err = nci == 64 ? launch_data_f32<64>(x, offset, wi, gm_data, ds, doff, B,
                                        H, W, Cin, Cout, halo, tile_h, tile_w,
                                        vec_x, vec_ds, stream)
        : nci == 128
            ? launch_data_f32<128>(x, offset, wi, gm_data, ds, doff, B, H, W,
                                   Cin, Cout, halo, tile_h, tile_w, vec_x,
                                   vec_ds, stream)
            : launch_data_f32<256>(x, offset, wi, gm_data, ds, doff, B, H, W,
                                   Cin, Cout, halo, tile_h, tile_w, vec_x,
                                   vec_ds, stream);
  if (err != cudaSuccess) return (int)err;

  // 4. dx pass: all of Cin a block, nci / 32 channels a lane
  err = launch_dx_all<float>(nci, ds, offset, dx, B, H, W, Cin, halo,
                             stream);
  if (err != cudaSuccess) return (int)err;

  // 5. dW pass: one partial per split
  err = nc == 64 ? launch_dw_f32<64>(x, offset, gm_hi, gm_lo, part, B, H, W,
                                     Cin, Cout, halo, splits, vec_x, stream)
        : nc == 128
            ? launch_dw_f32<128>(x, offset, gm_hi, gm_lo, part, B, H, W, Cin,
                                 Cout, halo, splits, vec_x, stream)
            : launch_dw_f32<256>(x, offset, gm_hi, gm_lo, part, B, H, W, Cin,
                                 Cout, halo, splits, vec_x, stream);
  if (err != cudaSuccess) return (int)err;

  // 6. dW = the partials in split order
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
  if (!make_g_map(&gm_data, g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, B, H,
                  W, g_stride, tile_h, tile_w) ||
      !make_g_map(&gm_dw, g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 64, B, H,
                  W, g_stride, BW_TH, BW_TW))
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
  err = launch_dx_all<bf16>(nci, ds, offset, dx, B, H, W, Cin, halo, stream);
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

// f32 x, offset and weight; out f32; any Cin and Cout.  A block owns a
// tile_h x tile_w pixel tile (<= 64 pixels) and n_tile (64, 128 or 256)
// output channels; `wimg` is scratch for the weight image, n_ctiles * 9 *
// ceil(Cin/32) * 2 * n_tile * 32 f32 (n_ctiles = ceil(Cout / n_tile)).
// Launches the image and the forward on `stream`; returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int dcn_forward_f32(const void* x, const void* offset,
                               const void* weight, void* wimg, void* out,
                               int B, int H, int W, int Cin, int Cout,
                               int halo, int tile_h, int tile_w, int n_tile,
                               void* stream) {
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > FM)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* of = static_cast<const float*>(offset);
  const float* wf = static_cast<const float*>(weight);
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_tile) {
    case 64:
      return launch_fwd_f32<64>(xf, of, wf, wimg, o, B, H, W, Cin, Cout, halo,
                                tile_h, tile_w, s);
    case 128:
      return launch_fwd_f32<128>(xf, of, wf, wimg, o, B, H, W, Cin, Cout,
                                 halo, tile_h, tile_w, s);
    case 256:
      return launch_fwd_f32<256>(xf, of, wf, wimg, o, B, H, W, Cin, Cout,
                                 halo, tile_h, tile_w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the f32 forward at n_tile output channels.
extern "C" int dcn_forward_f32_smem(int n_tile) {
  return n_tile == 64    ? (int)fwd_f32_smem_bytes<64>()
         : n_tile == 128 ? (int)fwd_f32_smem_bytes<128>()
                         : (int)fwd_f32_smem_bytes<256>();
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

// f32 backward: x, weight, g and offset f32; Cin, Cout <= 256; g's rows
// `g_stride` >= Cout elements apart (a multiple of 4, g 16-byte aligned:
// the TMA unit's rule).  Writes dx, doff and dw ([3, 3, Cin, Cout]), all
// f32, with scratch `wimg` (9 * ceil(Cout/32) * 2 * wgmma_width(Cin) * 32
// f32: the W^T image's two parts), `gt` (2 * B * Cout * HWp f32, HWp = H*W
// rounded up to 4: g^T's two parts), `ds` [B*H*W, 9, Cin] f32 and `part`
// [splits, 9*Cin, Cout] f32.  The data pass runs on tile_h x tile_w pixel
// tiles (<= 64 pixels), the dW pass on runs of 32 pixels in `splits`
// ranges.  Launches the image, the split of g, the data, dx, dW and
// reduction passes on `stream`; returns cudaGetLastError() as an int (0 =
// launched; cudaErrorInvalidValue for a shape it does not take or a tensor
// map the driver refuses).
extern "C" int dcn_backward_f32(const void* x, const void* offset,
                                const void* weight, const void* g,
                                void* wimg, void* gt, void* dx, void* doff,
                                void* ds, void* part, void* dw, int B, int H,
                                int W, int Cin, int Cout, int g_stride,
                                int halo, int tile_h, int tile_w, int splits,
                                void* stream) {
  return launch_backward_f32(
      static_cast<const float*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(weight), static_cast<const float*>(g), wimg,
      static_cast<float*>(gt), static_cast<float*>(dx),
      static_cast<float*>(doff), static_cast<float*>(ds),
      static_cast<float*>(part), static_cast<float*>(dw), B, H, W, Cin, Cout,
      g_stride, halo, tile_h, tile_w, splits, (cudaStream_t)stream);
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

// ... and of the f32 backward's.
extern "C" int dcn_bwd_dw_f32_smem(int nc) {
  return nc == 64    ? (int)bwd_dw_f32_smem_bytes<64>()
         : nc == 128 ? (int)bwd_dw_f32_smem_bytes<128>()
                     : (int)bwd_dw_f32_smem_bytes<256>();
}

extern "C" int dcn_bwd_data_f32_smem(int nci, int c_out) {
  const int n_kb = (c_out + TK - 1) / TK;
  return nci == 64    ? (int)bwd_data_f32_smem_bytes<64>(n_kb)
         : nci == 128 ? (int)bwd_data_f32_smem_bytes<128>(n_kb)
                      : (int)bwd_data_f32_smem_bytes<256>(n_kb);
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
