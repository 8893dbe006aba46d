// The greedy mask-removal claim loop on binarized planes, for Hopper.
//
// Replaces the TPU kernel slotvps_tpu/ops/pallas/claim_scan.py
// claim_scan_pallas / _claim_scan_batched (_kernel).  It computes exactly
// what slotvps_tpu_torch/ops/claim_scan.py claim_scan computes: planes
// [B, K, H, W] of 0/1 bytes in, keep [B, K] and owner [B, H, W] int8 out.
// Slot i of video b is rejected when its plane has no pixel or every pixel,
// or when its pixels already owned by a slot of its own class, divided by
// its pixel count (one correctly rounded f32 division, __fdiv_rn; the
// library is built without fast-math), exceed the fraction threshold;
// otherwise it claims its unowned pixels.
//
// Design.  The loop over slots is sequential: slot i's decision needs
// whole-map counts taken after every earlier claim.  The 2 MB int8 owner
// map of a 1024x2048 frame does not fit in the 227 KB of shared memory a
// block can have; it does fit in the 50 MB L2.  So, as claim_kernel in
// postproc_v3.cu: one launch per slot of the range the caller gives (the
// valid thing slots), plus one that applies the last claim, with no host
// sync in the loop.  Launch i applies the pending claim of the slot kept
// before it and counts slot i's pixels and same-class overlap (16 pixels a
// thread, block reductions, one atomic per block); the block that takes
// the last ticket decides keep and sets the pending slot.  The batch rides
// grid.y: one launch serves slot i of all B videos; a video for which slot
// i is not a valid thing leaves the launch at once and keeps its pending
// claim for its next launch.  Class equality reads the claimer's label
// (labels[owner]), so no owner-class map is kept.
//
// Memory layout.  The planes are read at any strides with one pixel stride
// (H*W pixels at stride sp): the contiguous [K, H, W] bytes (sp = 1, 16-byte
// loads) or the K-minor [H, W, K] stack that the postprocess builds (sp = K,
// one byte a pixel).  chip_smoke.py times both on the planes of a real
// 1024x2048 frame (K = 100, 27 valid things; NVIDIA H100 80GB HBM3,
// 700.00 W, two runs): the K-minor read costs each launch a 32-byte sector
// per pixel for one byte, twice (the slot's plane and the pending one),
// 2.36 / 2.39 ms a frame; the contiguous copy alone (210 MB in, 210 MB out,
// as torch's permuted copy does it) takes 4.68 / 4.93 ms, and the kernel
// on the copy 0.45 / 0.33 ms.  So the postprocess hands the kernel the
// K-minor stack as it is.
//
// What bounds it (H100 SXM at 700 W, 3.35 TB/s of HBM): the bytes of the
// valid-thing planes read once and the owner map written once, ~2 MB a
// valid thing at 1024x2048: 0.0175 ms for the frame above.  On the K-minor
// stack the sector reads take the time (~130 MB a launch); on contiguous
// planes the launch gaps and the re-read of the pending plane (from L2) do.
// A persistent grid with a grid-wide barrier per slot would remove the
// gaps (a later optimisation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 256;    // threads per block
constexpr int PPT = 16;    // pixels per thread

union Bytes16 {
  int4 v;
  uint8_t b[PPT];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// `cnt` bytes at `src`, `sp` apart, into dst[0..cnt); a 16-byte load when
// the run is whole, contiguous and aligned.
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ src,
                                         long long sp, int cnt,
                                         uint8_t (&dst)[PPT]) {
  if (cnt == PPT && sp == 1 && aligned16(src)) {
    Bytes16 u;
    u.v = *reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int c = 0; c < PPT; ++c) dst[c] = u.b[c];
    return;
  }
  for (int c = 0; c < PPT; ++c) dst[c] = c < cnt ? src[(size_t)c * sp] : 0;
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

// One step of the claim loop for slot `slot` of every video (grid.y = B).
// scratch: [B, K] pixel counts, [B, K] same-class overlaps, [B, K] block
// tickets, then [B] pending = 1 + the slot whose claim is still to be
// applied (0 = none).  slot = -1 only applies the pending claims.
__global__ void __launch_bounds__(CT)
claim_scan_kernel(const uint8_t* __restrict__ planes, long long sb,
                  long long sk, long long sp,
                  const int32_t* __restrict__ labels,
                  const uint8_t* __restrict__ flags, float frac, int B,
                  int K, int HW, int slot, int8_t* __restrict__ owner,
                  uint8_t* __restrict__ keep, int32_t* scratch) {
  __shared__ int s_labels[128];
  __shared__ int s_red[2][CT / 32];
  const int b = blockIdx.y;
  const size_t bk = (size_t)b * K;
  if (slot >= 0 && !flags[bk + slot]) return;   // nothing to do for video b
  int32_t* cnt_n = scratch + bk;
  int32_t* cnt_o = scratch + (size_t)B * K + bk;
  int32_t* ticket = scratch + 2 * (size_t)B * K + bk;
  int32_t* pending = scratch + 3 * (size_t)B * K + b;
  const int p = *pending - 1;
  if (slot < 0 && p < 0) return;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    s_labels[k] = labels[bk + k];
  __syncthreads();

  const uint8_t* pb = planes + (size_t)b * sb;
  int8_t* ob = owner + (size_t)b * HW;
  const size_t px = ((size_t)blockIdx.x * CT + threadIdx.x) * PPT;
  int n = 0, ovl = 0;
  if (px < (size_t)HW) {
    const int cnt = (int)min((size_t)PPT, (size_t)HW - px);
    int8_t* op = ob + px;
    Bytes16 o;
    const bool vec_o = cnt == PPT && aligned16(op);
    if (vec_o)
      o.v = *reinterpret_cast<const int4*>(op);
    else
      for (int c = 0; c < cnt; ++c) o.b[c] = (uint8_t)op[c];
    bool changed = false;
    uint8_t lg[PPT];
    if (p >= 0) {
      load_run(pb + (size_t)p * sk + px * sp, sp, cnt, lg);
#pragma unroll
      for (int c = 0; c < PPT; ++c)
        if (lg[c] && (int8_t)o.b[c] < 0) {
          o.b[c] = (uint8_t)p;
          changed = true;
        }
    }
    if (slot >= 0) {
      const int cls = s_labels[slot];
      load_run(pb + (size_t)slot * sk + px * sp, sp, cnt, lg);
#pragma unroll
      for (int c = 0; c < PPT; ++c)
        if (lg[c]) {
          ++n;
          const int oc = (int8_t)o.b[c];
          if (oc >= 0 && s_labels[oc] == cls) ++ovl;
        }
    }
    if (changed) {
      if (vec_o)
        *reinterpret_cast<int4*>(op) = o.v;
      else
        for (int c = 0; c < cnt; ++c) op[c] = (int8_t)o.b[c];
    }
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
      const bool reject =
          tn == 0 || tn == HW ||
          __fdiv_rn(__int2float_rn(to), __int2float_rn(max(tn, 1))) > frac;
      keep[bk + slot] = reject ? 0 : 1;
      *pending = reject ? 0 : slot + 1;
    }
  }
}

}  // namespace

// The claim loop over slots lo .. hi-1 of every video (each valid thing
// slot must lie in that range; the others are skipped on the device), then
// one launch that applies the last claims: hi - lo + 1 launches on
// `stream`.  Element (b, k, pixel) of the planes lies at
// planes[b*sb + k*sk + pixel*sp].  Initializes owner [B, HW] to -1, keep
// [B, K] to 0 and scratch ((3K + 1) B int32) to 0 on the stream.  Returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int cs_claim_scan(const void* planes, long long sb, long long sk,
                             long long sp, const void* labels,
                             const void* flags, float frac, int B, int K,
                             int HW, int lo, int hi, void* owner, void* keep,
                             void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(owner, 0xff, (size_t)B * HW, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(keep, 0, (size_t)B * K, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0,
                          sizeof(int32_t) * (3 * (size_t)K + 1) * B, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((size_t)HW + (size_t)CT * PPT - 1) /
                             ((size_t)CT * PPT)),
                  (unsigned)B);
  for (int slot = lo; slot <= hi; ++slot) {
    claim_scan_kernel<<<grid, CT, 0, s>>>(
        static_cast<const uint8_t*>(planes), sb, sk, sp,
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(flags), frac, B, K, HW,
        slot < hi ? slot : -1, static_cast<int8_t*>(owner),
        static_cast<uint8_t*>(keep), static_cast<int32_t*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* cs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
