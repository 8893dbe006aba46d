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
// Design: one persistent cooperative launch a call (claim_loop.cuh): a
// block a streaming multiprocessor owns a run of pixels of every video,
// keeps its owner tile and one bit word a pixel in shared memory, builds
// the words of up to 32 valid things in one pass over the planes, and
// takes one step a valid thing with a grid-wide barrier between steps.
// The batch is a loop inside the block: the steps are those of the video
// with the most valid things.  No host sync, no launch a slot.
//
// Memory layout.  The planes are read at any strides with one pixel stride
// (H*W pixels at stride sp).  The bits pass reads them two ways:
//  - K-minor (sk = 1, sp >= K: the [H, W, K] stack that the postprocess
//    builds, read in place): a thread a pixel reads the aligned 16-byte
//    pieces that hold the pixel's bytes of the chunk's slot range,
//    neighbouring threads on neighbouring pixels, and skips the pieces
//    that are all zero; each sector is read once a call;
//  - otherwise 16 pixels a thread, one slot after the other: 16-byte loads
//    along a plane when it is contiguous (sp = 1), byte loads else.
// The earlier kernel (one launch a slot, each walking all pixels and
// re-reading the pending slot's plane) took 2.36-2.63 ms on the K-minor
// planes of a real 1024x2048 frame (K = 100, 27 valid things) and
// 0.32-0.45 on a contiguous copy (PERF.md).
//
// What bounds it (H100 SXM at 700 W, 3.35 TB/s of HBM): the bytes of the
// valid-thing planes read once and the owner map written once, ~2 MB a
// valid thing at 1024x2048: 0.0175 ms for that frame.  On the K-minor stack
// the sectors that hold [lo, hi) of each pixel set the floor of any kernel
// reading it in place (a sector per 32 bytes: ~2-4 a pixel); then the ~28
// grid barriers, 1-3 us each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "claim_loop.cuh"

namespace {

constexpr int PPT = 16;    // pixels a thread in the strided bits pass
constexpr int PIECES = 4;  // 16-byte pieces a round in the K-minor pass

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
#pragma unroll
  for (int c = 0; c < PPT; ++c) dst[c] = c < cnt ? src[(size_t)c * sp] : 0;
}

struct Planes {
  const uint8_t* p;
  long long sb, sk, sp;
};

// The words of steps cbase .. cbase+nbits-1 of every video from planes
// whose slots are adjacent bytes (sk = 1, sp >= K): a thread a pixel, whose
// word it writes alone; it reads the aligned 16-byte pieces that hold the
// pixel's bytes of [smin, smax] (the chunk's first and last slot), PIECES
// at a time, and skips the pieces that are all zero.  Neighbouring threads
// read neighbouring pixels, so each sector comes from device memory once.
template <typename Word>
__device__ void bits_k_minor(const claim::Args& a,
                             const claim::Block<Word>& s, Planes pl,
                             int cbase, int nbits) {
  for (int b = 0; b < s.nv; ++b) {
    const int nb = max(0, min(nbits, s.cnt[b] - cbase));
    Word* w = s.bits(b);
    if (nb == 0) {
      for (int i = threadIdx.x; i < s.np; i += blockDim.x) w[i] = 0;
      continue;
    }
    const int smin = s.list[b * a.K + cbase];
    const int smax = s.list[b * a.K + cbase + nb - 1];
    const int8_t* pos = s.pos + b * a.K;
    const uint8_t* base =
        pl.p + (s.v0 + b) * pl.sb + (long long)s.p0 * pl.sp;
    for (int i = threadIdx.x; i < s.np; i += blockDim.x) {
      const uintptr_t px = reinterpret_cast<uintptr_t>(base + i * pl.sp);
      const uintptr_t last = px + smax;
      unsigned acc = 0;
      for (uintptr_t s0 = (px + smin) & ~(uintptr_t)15; s0 <= last;
           s0 += PIECES * PPT) {
        Bytes16 u[PIECES];
#pragma unroll
        for (int q = 0; q < PIECES; ++q)
          u[q].v = s0 + PPT * q <= last
                       ? *reinterpret_cast<const int4*>(s0 + PPT * q)
                       : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int q = 0; q < PIECES; ++q) {
          if ((u[q].v.x | u[q].v.y | u[q].v.z | u[q].v.w) == 0) continue;
          const int k0 = (int)(s0 + PPT * q - px);
#pragma unroll
          for (int c = 0; c < PPT; ++c) {
            const int k = k0 + c;
            if (u[q].b[c] && k >= smin && k <= smax) {
              const int j = pos[k] - cbase;
              if (j >= 0 && j < nb) acc |= 1u << j;
            }
          }
        }
      }
      w[i] = (Word)acc;
    }
  }
  __syncthreads();
}

// The same words from planes at any strides: 16 pixels a thread, whose
// words it zeroes and then ORs each slot of the chunk into where the
// slot's byte is set (the words stay in shared memory, not in registers).
template <typename Word>
__device__ void bits_strided(const claim::Args& a,
                             const claim::Block<Word>& s, Planes pl,
                             int cbase, int nbits) {
  for (int b = 0; b < s.nv; ++b) {
    const int nb = max(0, min(nbits, s.cnt[b] - cbase));
    const uint8_t* list = s.list + b * a.K + cbase;
    const uint8_t* pb = pl.p + (s.v0 + b) * pl.sb;
    Word* w = s.bits(b);
    for (int g = threadIdx.x; g * PPT < s.np; g += blockDim.x) {
      const int i0 = g * PPT;
      const int cnt = min(PPT, s.np - i0);
      const uint8_t* src = pb + (long long)(s.p0 + i0) * pl.sp;
      for (int c = 0; c < cnt; ++c) w[i0 + c] = 0;
      for (int j = 0; j < nb; ++j) {
        uint8_t by[PPT];
        load_run(src + list[j] * pl.sk, pl.sp, cnt, by);
#pragma unroll
        for (int c = 0; c < PPT; ++c)
          if (by[c]) w[i0 + c] |= (Word)(1u << j);
      }
    }
  }
  __syncthreads();
}

template <typename Word>
__global__ void __launch_bounds__(claim::THREADS, 1)
claim_scan_kernel(claim::Args a, Planes pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool k_minor = pl.sk == 1 && pl.sp >= a.K;
  claim::run_groups<Word>(a, smem, [&](const claim::Block<Word>& s,
                                       int cbase, int nbits) {
    if (k_minor)
      bits_k_minor(a, s, pl, cbase, nbits);
    else
      bits_strided(a, s, pl, cbase, nbits);
  });
}

}  // namespace

// Shared memory of one block of the kernel at this geometry (the wrapper's
// claim_smem must say the same).
extern "C" long long cs_claim_smem(int group, int K, int run, int chunk,
                                   int own_smem, int bits_smem) {
  return (long long)claim::claim_smem_bytes(group, K, run, chunk,
                                            own_smem != 0, bits_smem != 0, 0);
}

// The claim loop over the valid thing slots in [lo, hi) of every video, in
// one cooperative launch of `blocks` blocks on `stream`, at the geometry of
// the wrapper's claim_geometry (run pixels a block, `chunk` slots a bits
// pass, the owner tile and the words in shared memory or not, `group`
// videos a pass).  Element
// (b, k, pixel) of the planes lies at planes[b*sb + k*sk + pixel*sp];
// labels [B, K] int64, valid and thing [B, K] bool.  Writes owner [B, HW]
// and keep [B, K] bool; counts is 3 B K int32 (zeroed here); words is
// [group, HW rounded up to 16] of
// 1, 2 or 4 bytes (by chunk) when they do not live in shared memory.
// Returns a cudaError_t as an int (0 = launched); a grid that cannot be
// resident at once is refused.
extern "C" int cs_claim_scan(const void* planes, long long sb, long long sk,
                             long long sp, const void* labels,
                             const void* valid, const void* thing,
                             float frac, int B, int K,
                             int HW, int lo, int hi, int blocks, int run,
                             int chunk, int own_smem, int bits_smem, int group,
                             void* owner, void* keep, void* counts,
                             void* words, void* stream) {
  if (chunk < 1 || chunk > claim::MAX_CHUNK || run % 16 ||
      (long long)blocks * run < HW || group < 1)
    return (int)cudaErrorInvalidValue;
  claim::Args a{};
  a.labels = static_cast<const int64_t*>(labels);
  a.valid = static_cast<const uint8_t*>(valid);
  a.thing = static_cast<const uint8_t*>(thing);
  a.frac = frac;
  a.B = B;
  a.K = K;
  a.HW = HW;
  a.group = group;
  a.lo = lo;
  a.hi = hi;
  a.run = run;
  a.chunk = chunk;
  a.own_smem = own_smem != 0;
  a.bits_smem = bits_smem != 0;
  a.owner = static_cast<int8_t*>(owner);
  a.keep = static_cast<uint8_t*>(keep);
  a.counts = static_cast<int32_t*>(counts);
  a.words = words;
  a.words_stride = ((size_t)HW + 15) / 16 * 16;
  const Planes pl{static_cast<const uint8_t*>(planes), sb, sk, sp};
  const void* kernel =
      chunk <= 8    ? (const void*)claim_scan_kernel<uint8_t>
      : chunk <= 16 ? (const void*)claim_scan_kernel<uint16_t>
                    : (const void*)claim_scan_kernel<uint32_t>;
  return (int)claim::launch(kernel, a, blocks, (cudaStream_t)stream, &pl);
}

extern "C" const char* cs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
