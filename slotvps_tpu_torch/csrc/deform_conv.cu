// Deformable convolution v1 forward (3x3, stride 1, pad 1), f32, for Hopper.
//
// Replaces the TPU kernel slotvps_tpu/ops/pallas/deform_conv.py:_dcn_kernel
// (deform_conv2d_pallas with compute_dtype=float32).  It computes exactly
// what slotvps_tpu_torch/ops/deform_conv.py:deform_conv2d computes at the
// same halo:
//   * sampling position of tap k = rigid position + (dy, dx) from
//     offset[..., 2k], offset[..., 2k+1];
//   * a tap contributes iff the UNCLAMPED position lies in (-1, H) x (-1, W)
//     (the CUDA deformable_im2col rule);
//   * the bilinear sample is taken at the position clamped to rigid +- halo;
//   * bilinear corners outside the image read 0 (checked per corner here,
//     so no padded copy of x is needed).
// Layouts: x [B, H, W, Cin] (NHWC), offset [B, H, W, 18], weight
// [3, 3, Cin, Cout], out [B, H, W, Cout]; all f32 and contiguous.
//
// What bounds it on the card: the contraction.  One 1024x2048 frame runs
// the kernel 12 times (3 tower blocks x 4 FPN levels), 174,080 output pixels
// x ~2.06 MFLOP = ~0.36 TFLOP of f32 FMA, with no tensor cores yet
// (bf16/TF32 wgmma is later work).  The gather is small beside it: 9 taps x
// 4 corners x Cin loads per pixel, mostly L1/L2 hits because neighbouring
// pixels share corners.  The TPU kernel's one-hot-matmul detour is not
// needed: the GPU gathers natively.
//
// Design (simple first): a block owns a strip of BP output pixels of one row
// and a tile of BN output channels.  It computes each (tap, pixel) pair's
// four corner indices and weights once into shared memory, then walks Cin in
// chunks of CK: its threads gather the clamped bilinear samples into a
// shared-memory im2col tile [9*CK, BP] (NHWC, so a corner's channels are
// contiguous and loads coalesce), load the matching weight tile [9*CK, BN],
// and multiply the two in f32 FMA, each thread accumulating a 4x4 register
// tile of (pixel, channel) outputs.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BP = 64;        // output pixels per block (one row strip)
constexpr int BN = 64;        // output channels per block
constexpr int CK = 8;         // input channels per contraction chunk
constexpr int KC = 9 * CK;    // contracted rows per chunk
constexpr int NT = 256;       // threads per block: 16 x 16 of 4x4 tiles
constexpr int SP = BP + 4;    // padded row of the sample tile (no bank
                              // conflicts on its stores, float4 reads)

struct Tap {                  // one (tap, pixel) bilinear sample
  int idx[4];                 // corner pixel index h*W+w, or -1: reads 0
  float w[4];                 // corner weight
};

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
  for (int e = tid; e < 9 * BP; e += NT) {
    const int k = e / BP;
    const int p = e % BP;
    const int xo = px0 + p;
    Tap t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      t.idx[j] = -1;
      t.w[j] = 0.f;
    }
    if (xo < W) {
      const float* off = offset + ((img + (size_t)y * W + xo) * 18);
      const float dy = off[2 * k];
      const float dx = off[2 * k + 1];
      const float rig_y = (float)(y - 1 + k / 3);
      const float rig_x = (float)(xo - 1 + k % 3);
      float py = rig_y + dy;
      float px = rig_x + dx;
      // validity at the unclamped position
      if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
        py = fminf(fmaxf(py, rig_y - (float)halo), rig_y + (float)halo);
        px = fminf(fmaxf(px, rig_x - (float)halo), rig_x + (float)halo);
        const float y0f = floorf(py);
        const float x0f = floorf(px);
        const float fy = py - y0f;
        const float fx = px - x0f;
        const int y0 = (int)y0f;
        const int x0 = (int)x0f;
        const float cw[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx,
                             fy * (1.f - fx), fy * fx};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cy = y0 + (j >> 1);
          const int cx = x0 + (j & 1);
          if (cy >= 0 && cy < H && cx >= 0 && cx < W) {
            t.idx[j] = cy * W + cx;
            t.w[j] = cw[j];
          }
        }
      }
    }
    taps[e] = t;
  }

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

extern "C" const char* dcn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
