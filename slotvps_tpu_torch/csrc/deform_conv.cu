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
// What bounds the forward on the card: the contraction.  One 1024x2048
// frame runs the kernel 12 times (3 tower blocks x 4 FPN levels), 174,080
// output pixels x ~2.06 MFLOP = ~0.36 TFLOP: 5.4 ms of f32 FMA at
// 67 TFLOP/s, 0.36 ms of bf16 tensor-core work at 989 TFLOP/s.  The gather
// is small beside the f32 contraction: 9 taps x 4 corners x Cin loads per
// pixel, mostly L1/L2 hits because neighbouring pixels share corners; in
// bf16, with the contraction on the tensor cores, the gather and the sample
// staging are what is left.  The TPU kernel's one-hot-matmul detour is not
// needed: the GPU gathers natively.
//
// Forward design (simple first).  Both kernels: a block owns a strip of BP
// output pixels of one row and a tile of BN output channels.  It computes
// each (tap, pixel) pair's four corner indices and weights once into shared
// memory (make_tap; its geometry, tap_geom and tap_corners, is the
// backward's too), then walks Cin in chunks of CK: its
// threads gather the clamped bilinear samples into a shared-memory im2col
// tile of 9*CK contracted rows (NHWC, so a corner's channels are
// contiguous and loads coalesce), load the matching weight tile and
// multiply the two.
//   f32:  the tile is [9*CK, BP] f32; each thread accumulates a 4x4
//         register tile of (pixel, channel) outputs in f32 FMA.
//   bf16: the tile is [BP, 9*CK] bf16; eight warps run the [BP, 9*CK] x
//         [9*CK, BN] product with nvcuda::wmma 16x16x16 bf16 fragments and
//         f32 accumulators (warp w: pixel rows 16*(w%4), channel tiles
//         2*(w/4) and 2*(w/4)+1), staged through shared memory on the way
//         out.
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
// order, so each is the same on every run.  Four passes:
//   1. data pass: a block owns BPB consecutive pixels (flat over B*H*W,
//      so ragged widths need no padding), stages their g rows once, and
//      walks the taps and Cin in chunks of CKD: the chunk's dsample
//      [BPB, CKD] is a product of the g tile and a W^T tile (wmma bf16 with
//      f32 accumulators in bf16, f32 FMA in f32); then one warp per pixel
//      and one lane per channel writes dsample, in the compute dtype, to a
//      scratch buffer ds [B*H*W, 9, Cin] and reduces dsample x x_corner
//      over the lanes into the pixel's four corner sums; after the last
//      chunk of a tap, doff = sum of dM x corner sum.
//   2. dx pass (a gather, as the JAX kernel's sliding row window sums dx in
//      a fixed order): a block owns a tile of XH x XW input pixels of one
//      image and XC input channels, one warp per tile row and two channels
//      per lane.  A sample's corners lie within halo+1 rows above and
//      halo+2 rows below its output pixel (columns alike), so only output
//      pixels within that window of the tile reach it.  Output row by
//      output row, the block recomputes the window's tap descriptors into
//      shared memory; each warp scans them in order, finds with a ballot
//      the taps with a corner on its row, and adds M x dsample (read from
//      ds, XU taps' loads in flight at once) into its pixels' shared-memory
//      sums: each sum is taken by one lane, in a fixed order (output row,
//      column, tap, corner).
//   3. weight pass: dW as a [9*Cin, Cout] product over pixels, in TM x TN
//      tiles, each block summing one range of pixels (split K) into its own
//      partial: it recomputes its samples from the corner descriptors and
//      multiplies them with the g tile (wmma in bf16, FMA in f32).
//   4. a reduction of the partials in split order.
// What bounds the backward: ~2x the forward's contraction (dsample and dW,
// each as large as the forward's product); ds is written once and read
// about four times (once per corner; the bound counts neither), 0.74 GB in
// bf16 at the largest training level (2 x 200 x 400 pixels, Cin 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

#include <type_traits>

namespace {

constexpr int BP = 64;        // output pixels per block (one row strip)
constexpr int BN = 64;        // output channels per block
constexpr int NT = 256;       // threads per block

struct Tap {                  // one (tap, pixel) bilinear sample
  int idx[4];                 // corner pixel index h*W+w, or -1: reads 0
  float w[4];                 // corner weight
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v as the compute dtype T holds it (rounded to bf16 for bf16)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
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

__device__ __forceinline__ TapGeom tap_geom(const float* __restrict__ off,
                                            int y, int xo, int k, int H,
                                            int W, int halo) {
  TapGeom t;
  const float rig_y = (float)(y - 1 + k / 3);
  const float rig_x = (float)(xo - 1 + k % 3);
  const float py = rig_y + off[2 * k];
  const float px = rig_x + off[2 * k + 1];
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

// The sampling descriptor of tap k at output pixel (y, xo) of the image
// whose first pixel is `img`, corner indices from `base` (0: within the
// image; img: over the batch).  A pixel past the row (xo >= W) samples
// nothing.
template <bool kRound>
__device__ Tap make_tap(const float* __restrict__ offset, size_t img, int y,
                        int xo, int k, int H, int W, int halo, int base = 0) {
  Tap t;
  TapGeom gm{};   // valid = false
  if (xo < W)
    gm = tap_geom(offset + (img + (size_t)y * W + xo) * 18, y, xo, k, H, W,
                  halo);
  tap_corners<kRound>(gm, base, H, W, t.idx, t.w);
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
    taps[e] = make_tap<false>(offset, img, y, px0 + e % BP, e / BP, H,
                                     W, halo);

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

namespace bf = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int CK16 = 16;           // input channels per chunk (wmma k = 16)
constexpr int KC16 = 9 * CK16;     // contracted rows per chunk: 144
constexpr int LDA = KC16 + 8;      // sample tile row, bf16 elements
constexpr int LDB = BN + 8;        // weight tile row, bf16 elements
constexpr int LDC = BN + 4;        // f32 output staging row
constexpr size_t kTapBytes = sizeof(Tap) * 9 * BP;
constexpr size_t kABytes = sizeof(bf16) * BP * LDA;
constexpr size_t kBBytes = sizeof(bf16) * KC16 * LDB;
constexpr size_t kCBytes = sizeof(float) * BP * LDC;   // aliases A and B
constexpr size_t kSmemBytes16 =
    kTapBytes + (kABytes + kBBytes > kCBytes ? kABytes + kBBytes : kCBytes);

template <typename OutT>
__global__ void __launch_bounds__(NT)
dcn_fwd_bf16_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ offset,
                    const bf16* __restrict__ weight,
                    OutT* __restrict__ out,
                    int H, int W, int Cin, int Cout, int halo, int n_ctiles) {
  extern __shared__ __align__(128) unsigned char smem16[];
  Tap* taps = reinterpret_cast<Tap*>(smem16);                     // [9][BP]
  bf16* s_a = reinterpret_cast<bf16*>(smem16 + kTapBytes);        // [BP][LDA]
  bf16* s_b = reinterpret_cast<bf16*>(smem16 + kTapBytes + kABytes);
  float* s_c = reinterpret_cast<float*>(smem16 + kTapBytes);      // [BP][LDC]

  const int tid = threadIdx.x;
  const int ctile = blockIdx.x % n_ctiles;
  const int ptile = blockIdx.x / n_ctiles;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int px0 = ptile * BP;
  const int n0 = ctile * BN;
  const size_t img = (size_t)b * H * W;

  // 1. sampling descriptors, corner weights rounded to bf16
  for (int e = tid; e < 9 * BP; e += NT)
    taps[e] = make_tap<true>(offset, img, y, px0 + e % BP, e / BP, H,
                                   W, halo);

  const int warp = tid / 32;
  const int wm = warp % 4;          // pixel rows 16*wm .. 16*wm+15
  const int wn = (warp / 4) * 2;    // channel tiles wn, wn+1 (16 each)
  bf::fragment<bf::accumulator, 16, 16, 16, float> acc[2];
  bf::fill_fragment(acc[0], 0.f);
  bf::fill_fragment(acc[1], 0.f);

  for (int c0 = 0; c0 < Cin; c0 += CK16) {
    __syncthreads();  // descriptors written / previous chunk consumed
    // 2. im2col tile s_a[p][k*CK16 + c]: the f32 sum of the four bf16
    //    weight x bf16 input products (exact in f32), rounded to bf16
    for (int e = tid; e < 9 * BP * CK16; e += NT) {
      const int c = e % CK16;
      const int kp = e / CK16;       // k * BP + p
      const Tap& t = taps[kp];
      float v = 0.f;
      if (c0 + c < Cin) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t.idx[j] >= 0)
            v += t.w[j] * __bfloat162float(x[(img + t.idx[j]) * Cin + c0 + c]);
      }
      s_a[(kp % BP) * LDA + (kp / BP) * CK16 + c] = __float2bfloat16_rn(v);
    }
    // 3. weight tile s_b[k*CK16 + c][n] = weight[k][c0+c][n0+n], 0 outside
    for (int e = tid; e < KC16 * BN; e += NT) {
      const int n = e % BN;
      const int r = e / BN;
      const int k = r / CK16;
      const int c = r % CK16;
      bf16 v = __float2bfloat16_rn(0.f);
      if (c0 + c < Cin && n0 + n < Cout)
        v = weight[((size_t)k * Cin + c0 + c) * Cout + n0 + n];
      s_b[r * LDB + n] = v;
    }
    __syncthreads();
    // 4. tensor-core contraction over the chunk's 9*CK16 rows
#pragma unroll
    for (int kk = 0; kk < KC16; kk += 16) {
      bf::fragment<bf::matrix_a, 16, 16, 16, bf16, bf::row_major> fa;
      bf::load_matrix_sync(fa, s_a + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bf::fragment<bf::matrix_b, 16, 16, 16, bf16, bf::row_major> fb;
        bf::load_matrix_sync(fb, s_b + kk * LDB + (wn + i) * 16, LDB);
        bf::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }

  // 5. epilogue: f32 sums through shared memory, written as OutT (rounded
  //    to bf16 for a bf16 output)
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bf::store_matrix_sync(s_c + wm * 16 * LDC + (wn + i) * 16, acc[i], LDC,
                          bf::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BP * BN; e += NT) {
    const int n = e % BN;
    const int p = e / BN;
    const int xo = px0 + p;
    if (xo < W && n0 + n < Cout)
      out[(img + (size_t)y * W + xo) * Cout + n0 + n] =
          from_f32<OutT>(s_c[p * LDC + n]);
  }
}

// ---- backward ----

constexpr int BPB = 64;        // pixels per block of the data pass
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

// The backward's descriptor of tap k at flat pixel q = (b*H + y)*W + x:
// the forward's corners (indices over B*H*W) and their position
// derivatives.  Corners outside the image get idx -1: x reads 0 there, and
// the JAX kernel's dx in the padding is discarded, so they contribute
// nothing; an invalid tap has no weight and no position derivative.
template <bool kRound>
__device__ TapGrad make_tap_grad(const float* __restrict__ offset, int q,
                                 int H, int W, int k, int halo) {
  const int b = q / (H * W);
  const int y = (q - b * H * W) / W;
  const int xo = q - (b * H + y) * W;
  const TapGeom gm = tap_geom(offset + (size_t)q * 18, y, xo, k, H, W, halo);
  TapGrad t;
  tap_corners<kRound>(gm, b * H * W, H, W, t.idx, t.w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = t.idx[j] >= 0;
    // dM/dy = +-(column weight), dM/dx = +-(row weight)
    const float colw = (j & 1) ? gm.fx : 1.f - gm.fx;
    const float roww = (j >> 1) ? gm.fy : 1.f - gm.fy;
    t.gy[j] = live && gm.ncy ? ((j >> 1) ? colw : -colw) : 0.f;
    t.gx[j] = live && gm.ncx ? ((j & 1) ? roww : -roww) : 0.f;
  }
  return t;
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared-memory layout of the data pass for Cout output channels: the
// fixed part (dsample tile, descriptors, corner sums), then the g tile
// [BPB][ldg] and the W^T tile, each region 128-byte aligned.
//   bf16: g rows of ldg = round16(Cout) + 8; W^T col-major [CKD][ldw],
//         ldw = ldg (wmma operands, zero beyond Cout);
//   f32:  g rows of ldg = Cout + 4; W^T row-major [Cout][LDWF] (float4
//         reads of 8 channels).
struct DataSmem {
  int ldg, ldw;
  size_t g_off, w_off, bytes;
};

template <typename T>
DataSmem data_smem(int Cout) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  DataSmem d;
  size_t off = round_up(sizeof(float) * BPB * LDS + sizeof(TapGrad) * BPB +
                            sizeof(float) * BPB * 4,
                        kSmemAlign);
  d.ldg = kBf ? round_up(Cout, 16) + 8 : Cout + 4;
  d.ldw = kBf ? d.ldg : LDWF;
  d.g_off = off;
  off += round_up((int)(sizeof(T) * BPB * d.ldg), kSmemAlign);
  d.w_off = off;
  off += round_up((int)(sizeof(T) * (kBf ? CKD * d.ldw : Cout * LDWF)),
                  kSmemAlign);
  d.bytes = off;
  return d;
}

template <typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_data_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                    const T* __restrict__ weight, const T* __restrict__ g,
                    T* __restrict__ ds, float* __restrict__ doff,
                    int n_pix, int H, int W, int Cin, int Cout, int halo,
                    DataSmem sm) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem_d[];
  float* s_ds = reinterpret_cast<float*>(smem_d);              // [BPB][LDS]
  TapGrad* s_tap = reinterpret_cast<TapGrad*>(s_ds + BPB * LDS);  // [BPB]
  float* s_pt = reinterpret_cast<float*>(s_tap + BPB);         // [BPB][4]
  T* s_g = reinterpret_cast<T*>(smem_d + sm.g_off);            // [BPB][ldg]
  T* s_w = reinterpret_cast<T*>(smem_d + sm.w_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * BPB;
  const int ldg = sm.ldg;
  const int ldw = sm.ldw;

  // 1. the block's g rows (already in the compute dtype), zero-padded
  for (int e = tid; e < BPB * ldg; e += NT) {
    const int p = e / ldg;
    const int co = e - p * ldg;
    T v = from_f32<T>(0.f);
    if (p0 + p < n_pix && co < Cout) v = g[(size_t)(p0 + p) * Cout + co];
    s_g[e] = v;
  }

  for (int k = 0; k < 9; ++k) {
    __syncthreads();  // g staged / the previous tap's corner sums read
    if (tid < BPB) {
      if (p0 + tid < n_pix) {
        s_tap[tid] = make_tap_grad<kBf>(offset, p0 + tid, H, W, k, halo);
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
      if constexpr (kBf) {
        for (int e = tid; e < CKD * ldw; e += NT) {
          const int c = e / ldw;
          const int co = e - c * ldw;
          bf16 v = __float2bfloat16_rn(0.f);
          if (c0 + c < Cin && co < Cout)
            v = weight[((size_t)k * Cin + c0 + c) * Cout + co];
          s_w[e] = v;   // col-major B: element (co, c) at c*ldw + co
        }
      } else {
        for (int e = tid; e < Cout * CKD; e += NT) {
          const int co = e / CKD;
          const int c = e - co * CKD;
          float v = 0.f;
          if (c0 + c < Cin)
            v = to_f32(weight[((size_t)k * Cin + c0 + c) * Cout + co]);
          s_w[co * LDWF + c] = from_f32<T>(v);
        }
      }
      __syncthreads();
      // 3. dsample [BPB, CKD] = g tile . W^T tile, f32 sums
      if constexpr (kBf) {
        const int wm = warp % 4;      // pixel rows 16*wm
        const int wn = warp / 4;      // channel cols 16*wn
        bf::fragment<bf::accumulator, 16, 16, 16, float> acc;
        bf::fill_fragment(acc, 0.f);
        const int k16 = round_up(Cout, 16);
        for (int kk = 0; kk < k16; kk += 16) {
          bf::fragment<bf::matrix_a, 16, 16, 16, bf16, bf::row_major> fa;
          bf::fragment<bf::matrix_b, 16, 16, 16, bf16, bf::col_major> fb;
          bf::load_matrix_sync(fa, reinterpret_cast<const bf16*>(s_g) +
                                       wm * 16 * ldg + kk, ldg);
          bf::load_matrix_sync(fb, reinterpret_cast<const bf16*>(s_w) +
                                       wn * 16 * ldw + kk, ldw);
          bf::mma_sync(acc, fa, fb, acc);
        }
        bf::store_matrix_sync(s_ds + wm * 16 * LDS + wn * 16, acc, LDS,
                              bf::mem_row_major);
      } else {
        const int p = tid / 4;
        const int cb = (tid % 4) * 8;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        const float* gr = reinterpret_cast<const float*>(s_g) + p * ldg;
        const float* wt = reinterpret_cast<const float*>(s_w) + cb;
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
          d = round_to<T>(s_ds[p * LDS + lane]);
          ds[((size_t)(p0 + p) * 9 + k) * Cin + c] = from_f32<T>(d);
        }
        if (t.idx[0] < 0 && t.idx[1] < 0 && t.idx[2] < 0 && t.idx[3] < 0)
          continue;   // warp-uniform: an invalid tap
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < Cin) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t.idx[j] >= 0)
              part[j] = d * to_f32(x[(size_t)t.idx[j] * Cin + c]);
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

__device__ __forceinline__ float2 ds_pair(const bf16* __restrict__ row, int c,
                                          int Cin) {
  if ((Cin & 1) == 0 && c + 1 < Cin)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + c));
  return make_float2(c < Cin ? to_f32(row[c]) : 0.f,
                     c + 1 < Cin ? to_f32(row[c + 1]) : 0.f);
}

// dx [B, H, W, Cin] f32 = the sum over the taps whose corners land on each
// input pixel of M x dsample, from ds [B*H*W, 9, Cin] in the compute dtype;
// every element written, each sum in one fixed order.
template <typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_dx_kernel(const T* __restrict__ ds, const float* __restrict__ offset,
                  float* __restrict__ dx, int H, int W, int Cin, int halo,
                  int n_xtiles) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
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
      tap_corners<kBf>(gm, 0, H, W, idx, t.w);
      t.y0 = gm.valid ? gm.y0 : kNoRow;
      t.x0 = gm.x0;
      s_tap[e] = t;
    }
    __syncthreads();
    if (yi >= H) continue;   // warp-uniform; the loop's barriers still run
    const T* ds_row = ds + (img + (size_t)y * W + xlo) * 9 * Cin;
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

constexpr int TM = 64;    // dW rows (tap, input channel) per block
constexpr int TN = 64;    // dW cols (output channels) per block
constexpr int KP = 32;    // pixels per step of the weight pass

// dW partial of one (row tile, col tile, pixel range): part[split] =
// samples^T . g over the range, f32 sums.
template <typename T>
__global__ void __launch_bounds__(NT)
dcn_bwd_weight_kernel(const T* __restrict__ x,
                      const float* __restrict__ offset,
                      const T* __restrict__ g, float* __restrict__ part,
                      int n_pix, int H, int W, int Cin, int Cout, int halo,
                      int n_ntiles, int pix_per_split) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int WLDA = kBf ? TM + 8 : TM + 4;   // s_a [KP][WLDA], A col-major
  constexpr int WLDB = kBf ? TN + 8 : TN + 4;   // s_b [KP][WLDB], B row-major
  constexpr int WLDC = TN + 4;
  __shared__ __align__(128) Tap s_tap[9 * KP];
  __shared__ __align__(128) unsigned char s_ab[sizeof(T) * KP * (WLDA + WLDB)];
  T* s_a = reinterpret_cast<T*>(s_ab);
  T* s_b = s_a + KP * WLDA;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r0 = (blockIdx.x / n_ntiles) * TM;
  const int n0 = (blockIdx.x % n_ntiles) * TN;
  const int n_rows = 9 * Cin;
  const int k_lo = r0 / Cin;
  const int k_hi = min(n_rows, r0 + TM) - 1;
  const int n_taps = k_hi / Cin - k_lo + 1;
  const int pbeg = blockIdx.y * pix_per_split;
  const int pend = min(n_pix, pbeg + pix_per_split);

  bf::fragment<bf::accumulator, 16, 16, 16, float> facc[2];
  float acc[4][4];
  if constexpr (kBf) {
    bf::fill_fragment(facc[0], 0.f);
    bf::fill_fragment(facc[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int q0 = pbeg; q0 < pend; q0 += KP) {
    __syncthreads();  // previous step's tiles consumed
    // 1. descriptors of the row tile's taps at the step's pixels
    for (int e = tid; e < n_taps * KP; e += NT) {
      const int q = q0 + e % KP;
      const int b = q / (H * W);
      const int y = (q - b * H * W) / W;
      // corner indices over B*H*W; a pixel past the range samples nothing
      const int xo = q < pend ? q - (b * H + y) * W : W;
      s_tap[e] = make_tap<kBf>(offset, (size_t)b * H * W, y, xo,
                               k_lo + e / KP, H, W, halo, b * H * W);
    }
    // 2. g tile [KP][TN]
    for (int e = tid; e < KP * TN; e += NT) {
      const int px = e / TN;
      const int n = e - px * TN;
      T v = from_f32<T>(0.f);
      if (q0 + px < pend && n0 + n < Cout)
        v = g[(size_t)(q0 + px) * Cout + n0 + n];
      s_b[px * WLDB + n] = v;
    }
    __syncthreads();
    // 3. sample tile [KP][TM]: f32 sum of M x x over the corners, rounded
    //    to the compute dtype (neighbouring threads: neighbouring channels)
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
          if (t.idx[j] >= 0)
            v += t.w[j] * to_f32(x[(size_t)t.idx[j] * Cin + c]);
      }
      s_a[px * WLDA + r] = from_f32<T>(v);
    }
    __syncthreads();
    // 4. acc[TM][TN] += A . B over the step's KP pixels
    if constexpr (kBf) {
      const int wm = warp % 4;          // rows 16*wm
      const int wn = (warp / 4) * 2;    // col tiles wn, wn+1
#pragma unroll
      for (int kk = 0; kk < KP; kk += 16) {
        bf::fragment<bf::matrix_a, 16, 16, 16, bf16, bf::col_major> fa;
        bf::load_matrix_sync(fa, s_a + kk * WLDA + wm * 16, WLDA);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bf::fragment<bf::matrix_b, 16, 16, 16, bf16, bf::row_major> fb;
          bf::load_matrix_sync(fb, s_b + kk * WLDB + (wn + i) * 16, WLDB);
          bf::mma_sync(facc[i], fa, fb, facc[i]);
        }
      }
    } else {
      const int tr = (tid / 16) * 4;
      const int tc = (tid % 16) * 4;
#pragma unroll 8
      for (int px = 0; px < KP; ++px) {
        const float4 a =
            *reinterpret_cast<const float4*>(&s_a[px * WLDA + tr]);
        const float4 b =
            *reinterpret_cast<const float4*>(&s_b[px * WLDB + tc]);
        const float av[4] = {to_f32(a.x), to_f32(a.y), to_f32(a.z),
                             to_f32(a.w)};
        const float bv[4] = {to_f32(b.x), to_f32(b.y), to_f32(b.z),
                             to_f32(b.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  // 5. the partial of this split: part[split][row][col]
  float* dst = part + (size_t)blockIdx.y * n_rows * Cout;
  if constexpr (kBf) {
    __shared__ __align__(128) float s_c[TM * WLDC];
    const int wm = warp % 4;
    const int wn = (warp / 4) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      bf::store_matrix_sync(s_c + wm * 16 * WLDC + (wn + i) * 16, facc[i],
                            WLDC, bf::mem_row_major);
    __syncthreads();
    for (int e = tid; e < TM * TN; e += NT) {
      const int r = e / TN;
      const int n = e - r * TN;
      if (r0 + r < n_rows && n0 + n < Cout)
        dst[(size_t)(r0 + r) * Cout + n0 + n] = s_c[r * WLDC + n];
    }
  } else {
    const int tr = (tid / 16) * 4;
    const int tc = (tid % 16) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + tr + i < n_rows && n0 + tc + j < Cout)
          dst[(size_t)(r0 + tr + i) * Cout + n0 + tc + j] = acc[i][j];
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

template <typename T>
int launch_backward(const void* x, const void* offset, const void* weight,
                    const void* g, void* dx, void* doff, void* ds, void* part,
                    void* dw, int B, int H, int W, int Cin, int Cout,
                    int halo, int splits, cudaStream_t stream) {
  const int n_pix = B * H * W;
  const DataSmem sm = data_smem<T>(Cout);
  const size_t dx_bytes = dx_smem_bytes(halo);
  if (sm.bytes > 232448 || dx_bytes > 232448 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_bwd_data_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm.bytes);
  if (err != cudaSuccess) return (int)err;
  dcn_bwd_data_kernel<T><<<(n_pix + BPB - 1) / BPB, NT, sm.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const T*>(weight), static_cast<const T*>(g),
      static_cast<T*>(ds), static_cast<float*>(doff), n_pix, H, W, Cin, Cout,
      halo, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dcn_bwd_dx_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dx_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_xtiles = (W + XW - 1) / XW;
  dim3 xgrid(n_xtiles * ((Cin + XC - 1) / XC), (H + XH - 1) / XH, B);
  dcn_bwd_dx_kernel<T><<<xgrid, NT, dx_bytes, stream>>>(
      static_cast<const T*>(ds), static_cast<const float*>(offset),
      static_cast<float*>(dx), H, W, Cin, halo, n_xtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_mtiles = (9 * Cin + TM - 1) / TM;
  const int n_ntiles = (Cout + TN - 1) / TN;
  const int per_split = round_up((n_pix + splits - 1) / splits, KP);
  dim3 grid(n_mtiles * n_ntiles, splits);
  dcn_bwd_weight_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const T*>(g), static_cast<float*>(part), n_pix, H, W, Cin,
      Cout, halo, n_ntiles, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = 9 * Cin * Cout;
  dcn_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), n, splits);
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

// bf16 x and weight, f32 offset; out f32 (out_f32 != 0) or bf16; any Cout.
// Launches on `stream`; returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int dcn_forward_bf16(const void* x, const void* offset,
                                const void* weight, void* out, int out_f32,
                                int B, int H, int W, int Cin, int Cout,
                                int halo, void* stream) {
  const int n_ctiles = (Cout + BN - 1) / BN;
  const int n_ptiles = (W + BP - 1) / BP;
  dim3 grid(n_ptiles * n_ctiles, H, B);
  cudaError_t err;
  if (out_f32) {
    err = cudaFuncSetAttribute(dcn_fwd_bf16_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes16);
    if (err != cudaSuccess) return (int)err;
    dcn_fwd_bf16_kernel<float>
        <<<grid, NT, kSmemBytes16, (cudaStream_t)stream>>>(
            static_cast<const bf16*>(x), static_cast<const float*>(offset),
            static_cast<const bf16*>(weight), static_cast<float*>(out), H, W,
            Cin, Cout, halo, n_ctiles);
  } else {
    err = cudaFuncSetAttribute(dcn_fwd_bf16_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes16);
    if (err != cudaSuccess) return (int)err;
    dcn_fwd_bf16_kernel<bf16>
        <<<grid, NT, kSmemBytes16, (cudaStream_t)stream>>>(
            static_cast<const bf16*>(x), static_cast<const float*>(offset),
            static_cast<const bf16*>(weight), static_cast<bf16*>(out), H, W,
            Cin, Cout, halo, n_ctiles);
  }
  return (int)cudaGetLastError();
}

// Backward of the forward of the same dtype.  x, weight and g in the
// compute dtype, offset f32; writes dx (f32), doff (f32) and dw (f32,
// [3, 3, Cin, Cout]), with scratch `ds` [B*H*W, 9, Cin] in the compute
// dtype (dsample) and `part` [splits, 9*Cin, Cout] f32 (the dW partials).
// Launches four kernels on `stream`; returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int dcn_backward_f32(const void* x, const void* offset,
                                const void* weight, const void* g, void* dx,
                                void* doff, void* ds, void* part, void* dw,
                                int B, int H, int W, int Cin, int Cout,
                                int halo, int splits, void* stream) {
  return launch_backward<float>(x, offset, weight, g, dx, doff, ds, part, dw,
                                B, H, W, Cin, Cout, halo, splits,
                                (cudaStream_t)stream);
}

extern "C" int dcn_backward_bf16(const void* x, const void* offset,
                                 const void* weight, const void* g, void* dx,
                                 void* doff, void* ds, void* part, void* dw,
                                 int B, int H, int W, int Cin, int Cout,
                                 int halo, int splits, void* stream) {
  return launch_backward<bf16>(x, offset, weight, g, dx, doff, ds, part, dw,
                               B, H, W, Cin, Cout, halo, splits,
                               (cudaStream_t)stream);
}

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
