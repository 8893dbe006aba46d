// The greedy claim loop as one persistent launch: the part that the claim
// scan on binarized planes (claim_scan.cu) and the claim on planes
// binarized against theta (postproc_v3.cu, claim_kernel) share.
//
// The loop.  Slots are visited in slot order, over the valid thing slots
// of [lo, hi) only; slot i of video b is rejected when its pixel count n is
// 0 or H*W, or when its pixels already owned by a slot of its own class,
// divided by n (one correctly rounded f32 division, __fdiv_rn; no
// fast-math), exceed the fraction threshold; a kept slot claims its still
// unowned pixels.  Step s handles the s-th valid thing of every video, so
// the loop takes max_b(valid things of video b) steps.
//
// The grid.  One block of THREADS threads a streaming multiprocessor, all
// resident at once (a cooperative launch, which refuses a grid that is
// not), so a counter barrier in global memory between the steps is legal.
// Block j owns the pixels [j*run, (j+1)*run) of every video for the whole
// loop: its int8 owner tile and one bit word per pixel live in shared
// memory (or, past the shared-memory geometry, in device memory), and the
// owner tile is written out once at the end.
//
// Bits first.  For a chunk of up to 32 steps the block builds, in one pass
// over its pixels, the word "slot t of the chunk is on here" (the caller's
// Build functor: bytes of a binarized stack, or the x4 upsample against
// theta), and takes each slot's n from those words: warp-aggregated
// shared-memory counts, one global integer atomic per block and slot.
//
// A step.  One pass over the block's pixels applies the previous step's
// claim (if its slot was kept) and counts the current slot's same-class
// overlap.  The barrier is the count: each block adds "one arrival plus its
// overlap" to a 64-bit counter of the (video, step) with one atomic and
// waits until the counter holds every block's arrival; its low bits are
// then the overlap total.  Every block takes the same decision from the
// same totals with the same expression (integer sums do not depend on the
// order of the atomics, so the result is the same on every run).  Each
// step has its own counters: nothing is reset inside the loop.
//
// Videos.  A batch whose per-video arrays do not fit in shared memory runs
// in groups of videos, one group after the other inside the launch (each
// video has its own counters, and a block touches only its own pixels, so
// no grid-wide barrier is needed between groups).
//
// Geometry (run, chunk, where the tiles live, the group) comes from the
// wrapper's claim_geometry (ops/cuda/claim_scan.py), which states the same
// shared-memory layout as claim_smem_bytes below; the kernels obey it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace claim {

constexpr int THREADS = 1024;   // one block a streaming multiprocessor
constexpr int MAX_CHUNK = 32;   // slots a bits pass
constexpr int PER_VIDEO = 67;   // int32 a video: count, pending, ovl, n[32],
                                // the chunk's n totals [32]
constexpr unsigned long long ARRIVE = 1ull << 40;   // a step counter's unit

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int word_bytes(int chunk) {
  return chunk <= 8 ? 1 : chunk <= 16 ? 2 : 4;
}

// Dynamic shared memory of one block: labels [B*K] int32, the valid-thing
// lists [B*K] and each slot's place in them [B*K] (bytes), the per-video
// ints, the caller's staging (stage_per_slot bytes per chunk slot), then
// the owner tile [B*run] int8 and the bit words [B*run] when they live
// here.  Every region starts 16-byte aligned.
__host__ __device__ inline size_t claim_smem_bytes(int B, int K, int run,
                                                   int chunk, bool own_smem,
                                                   bool bits_smem,
                                                   int stage_per_slot) {
  return round16(sizeof(int32_t) * (size_t)B * K) +
         2 * round16((size_t)B * K) +
         round16(sizeof(int32_t) * PER_VIDEO * (size_t)B) +
         round16((size_t)stage_per_slot * chunk) +
         (own_smem ? round16((size_t)B * run) : 0) +
         (bits_smem ? round16((size_t)B * run * word_bytes(chunk)) : 0);
}

struct Args {
  const int64_t* labels;    // [B, K] class ids
  const uint8_t* valid;     // [B, K] bool
  const uint8_t* thing;     // [B, K] bool
  float frac;
  int B, K, HW;             // HW: pixels of one video's map
  int group;                // videos a pass (B in one pass when they fit)
  int lo, hi;               // the slot range holding every valid thing
  int run;                  // pixels of a video a block (a multiple of 16)
  int chunk;                // slots a bits pass, 1 .. 32
  bool own_smem, bits_smem;
  int stage_per_slot;
  int8_t* owner;            // [B, HW]
  uint8_t* keep;            // [B, K] bool
  int32_t* counts;          // [B, K] u64 step counters, [B, K] n; zeroed
  unsigned long long* ctr;  // the step counters in counts
  int32_t* n_tot;           // the pixel counts in counts
  void* words;              // [group, words_stride] when !bits_smem
  size_t words_stride;      // HW rounded up to 16
};

// The block's view of the loop: its pixel range and its shared memory.
template <typename Word>
struct Block {
  int p0, np;               // first pixel and pixel count of each video
  int v0, nv;               // the group: its first video, its videos
  int32_t* lab;             // [B*K]
  uint8_t* list;            // [B*K]: valid thing slots of each video
  int8_t* pos;              // [B*K]: slot -> index in list, -1 if none
  int32_t* cnt;             // [B] valid things
  int32_t* pend;            // [B] slot whose claim is still to be applied
  int32_t* ovl;             // [B] this step's overlap, summed by warps
  int32_t* nsum;            // [B*32] this chunk's pixel counts, the block's
  int32_t* ntot;            // [B*32] ... and the whole map's
  unsigned char* stage;     // the caller's staging buffer
  int8_t* own_base;         // tiles (shared or device memory)
  Word* bits_base;
  size_t own_stride, bits_stride;

  // video b of the group (all indices below are the group's)
  __device__ int8_t* own(int b) const { return own_base + b * own_stride; }
  __device__ Word* bits(int b) const { return bits_base + b * bits_stride; }
};

// The block's view of the group of videos that starts at v0; the shared
// memory is laid out for a.group videos.
template <typename Word>
__device__ Block<Word> carve(const Args& a, unsigned char* smem, int v0) {
  Block<Word> s;
  const size_t gk = (size_t)a.group * a.K;
  s.p0 = blockIdx.x * a.run;
  s.np = max(0, min(a.run, a.HW - s.p0));
  s.v0 = v0;
  s.nv = min(a.group, a.B - v0);
  unsigned char* p = smem;
  s.lab = reinterpret_cast<int32_t*>(p);
  p += round16(sizeof(int32_t) * gk);
  s.list = p;
  p += round16(gk);
  s.pos = reinterpret_cast<int8_t*>(p);
  p += round16(gk);
  s.cnt = reinterpret_cast<int32_t*>(p);
  s.pend = s.cnt + a.group;
  s.ovl = s.pend + a.group;
  s.nsum = s.ovl + a.group;
  s.ntot = s.nsum + 32 * a.group;
  p += round16(sizeof(int32_t) * PER_VIDEO * (size_t)a.group);
  s.stage = p;
  p += round16((size_t)a.stage_per_slot * a.chunk);
  if (a.own_smem) {
    s.own_base = reinterpret_cast<int8_t*>(p);
    s.own_stride = a.run;
    p += round16((size_t)a.group * a.run);
  } else {
    s.own_base = a.owner + (size_t)v0 * a.HW + s.p0;
    s.own_stride = a.HW;
  }
  if (a.bits_smem) {
    s.bits_base = reinterpret_cast<Word*>(p);
    s.bits_stride = a.run;
  } else {
    s.bits_base = static_cast<Word*>(a.words) + s.p0;
    s.bits_stride = a.words_stride;
  }
  return s;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Arrive at a step counter with `ovl` and wait until all gridDim.x blocks
// have; returns the total of their ovl.  A wait of more than BARRIER_NS (a
// grid that is not co-resident, which the cooperative launch rules out)
// traps, so a fault shows as a launch error, not a hung card.
constexpr unsigned long long BARRIER_NS = 5000000000ull;

__device__ __forceinline__ int arrive_and_sum(unsigned long long* ctr,
                                              int ovl) {
  const unsigned long long add = ARRIVE | (unsigned)ovl;
  unsigned long long v = atomicAdd(ctr, add) + add;
  const unsigned long long t0 = global_ns();
  while ((v >> 40) < gridDim.x) {
    if (global_ns() - t0 > BARRIER_NS) __trap();
    v = ld_acquire(ctr);
  }
  return (int)(v & (ARRIVE - 1));
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(0xffffffffu, x);
}

// Labels, the valid-thing list of each video (a warp a video, by ballot)
// and each slot's place in it; owner tiles to -1; block 0 zeroes keep.
template <typename Word>
__device__ void setup(const Args& a, const Block<Word>& s) {
  const int bk = s.nv * a.K;
  const size_t vk = (size_t)s.v0 * a.K;
  for (int e = threadIdx.x; e < bk; e += blockDim.x) {
    s.lab[e] = (int32_t)a.labels[vk + e];
    s.pos[e] = -1;
    if (blockIdx.x == 0) a.keep[vk + e] = 0;
  }
  for (int e = threadIdx.x; e < a.group * PER_VIDEO; e += blockDim.x)
    s.cnt[e] = 0;     // cnt, pend, ovl, nsum and ntot lie in one run
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < s.nv; b += blockDim.x >> 5) {
    int n = 0;
    for (int base = 0; base < a.K; base += 32) {
      const int k = base + lane;
      const bool f = k < a.K && k >= a.lo && k < a.hi &&
                     a.valid[vk + b * a.K + k] && a.thing[vk + b * a.K + k];
      const unsigned ball = __ballot_sync(0xffffffffu, f);
      if (f) {
        const int at = n + __popc(ball & ((1u << lane) - 1));
        s.list[b * a.K + at] = (uint8_t)k;
        s.pos[b * a.K + k] = (int8_t)at;
      }
      n += __popc(ball);
    }
    if (lane == 0) s.cnt[b] = n;
  }
  for (int b = 0; b < s.nv; ++b) {
    int8_t* o = s.own(b);
    for (int i = threadIdx.x; i < s.np; i += blockDim.x) o[i] = -1;
  }
  __syncthreads();
}

// Each chunk slot's pixel count in the block's words: warps aggregate equal
// words (__match_any_sync), shared counts, then one global atomic per block
// and slot.  Every thread of the block runs the same trip count.
template <typename Word>
__device__ void count_chunk(const Args& a, const Block<Word>& s, int cbase,
                            int nbits) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < s.nv; ++b) {
    const Word* w = s.bits(b);
    for (int base = 0; base < s.np; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const unsigned v = i < s.np ? (unsigned)w[i] : 0u;
      const unsigned peers = __match_any_sync(0xffffffffu, v);
      if (v && lane == __ffs(peers) - 1) {
        const int c = __popc(peers);
        for (unsigned r = v; r; r &= r - 1)
          atomicAdd(&s.nsum[b * 32 + __ffs(r) - 1], c);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < s.nv * 32; e += blockDim.x) {
    const int b = e >> 5, t = e & 31, step = cbase + t;
    const int v = s.nsum[e];
    if (v && t < nbits && step < s.cnt[b]) {
      atomicAdd(&a.n_tot[(s.v0 + b) * a.K + step], v);
      __threadfence();
    }
    s.nsum[e] = 0;
  }
}

// Pixel i's part of a step pass: the pending claim (slot ps at bit tp)
// where the pixel is unowned and on for ps, then the count of step slot cs
// (bit t, class cls) where it is on and owned by a slot of that class.
// ps or cs is -1 where there is none.  Returns whether o changed.
__device__ __forceinline__ bool step_pixel(unsigned v, int& o, int ps,
                                           int tp, int cs, int t, int cls,
                                           const int32_t* lab, int& n) {
  bool changed = false;
  if (ps >= 0 && o < 0 && ((v >> tp) & 1u)) {
    o = ps;
    changed = true;
  }
  if (cs >= 0 && o >= 0 && ((v >> t) & 1u) && lab[o] == cls) ++n;
  return changed;
}

template <typename Word>
struct alignas(4 * sizeof(Word)) Word4 {
  Word v[4];
};

// One pass over the block's pixels of every video: the pending claim
// (slot s.pend[b] at bit tp, if kept) first, then the overlap of step
// `step` (bit t) with pixels owned by a slot of its class.  With step < 0
// only the claims.  Four pixels at a time (one load of their words, one of
// their owners; a quad whose words hold neither bit is skipped) where the
// owner tile is 4-byte aligned, else one.  Each thread keeps to the same
// pixels in every pass, so no barrier is needed between a claim and the
// next count.
template <typename Word>
__device__ void claim_and_count(const Args& a, const Block<Word>& s, int tp,
                                int step, int t) {
  for (int b = 0; b < s.nv; ++b) {
    const int ps = tp >= 0 ? s.pend[b] : -1;
    const int cs = step >= 0 && step < s.cnt[b]
                       ? s.list[b * a.K + step] : -1;
    if (ps < 0 && cs < 0) continue;          // uniform across the block
    const int32_t* lab = s.lab + b * a.K;
    const int cls = cs >= 0 ? lab[cs] : 0;
    const unsigned mask = (ps >= 0 ? 1u << tp : 0u) | (cs >= 0 ? 1u << t : 0u);
    const Word* w = s.bits(b);
    int8_t* own = s.own(b);
    int n = 0;
    int i0 = 0;
    if ((reinterpret_cast<uintptr_t>(own) & 3) == 0) {
      const Word4<Word>* w4 = reinterpret_cast<const Word4<Word>*>(w);
      uint32_t* o4 = reinterpret_cast<uint32_t*>(own);
      const int n4 = s.np >> 2;
      for (int q = threadIdx.x; q < n4; q += blockDim.x) {
        const Word4<Word> wv = w4[q];
        if (((unsigned)(wv.v[0] | wv.v[1] | wv.v[2] | wv.v[3]) & mask) == 0)
          continue;
        uint32_t ov = o4[q];
        bool changed = false;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int o = (int8_t)(ov >> (8 * c));
          if (step_pixel(wv.v[c], o, ps, tp, cs, t, cls, lab, n)) {
            ov = (ov & ~(0xffu << (8 * c))) | ((uint32_t)(uint8_t)o << (8 * c));
            changed = true;
          }
        }
        if (changed) o4[q] = ov;
      }
      i0 = 4 * n4;
    }
    for (int i = i0 + threadIdx.x; i < s.np; i += blockDim.x) {
      int o = own[i];
      if (step_pixel(w[i], o, ps, tp, cs, t, cls, lab, n)) own[i] = (int8_t)o;
    }
    if (cs >= 0) {
      n = warp_sum(n);
      if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s.ovl[b], n);
    }
  }
}

// The loop.  build(cbase, nbits) fills every video's words for steps
// cbase .. cbase + nbits - 1 (bit t = step - cbase) and may use the
// staging buffer; it ends with the words visible to the whole block.
template <typename Word, typename Build>
__device__ void run_loop(const Args& a, Block<Word>& s, Build build) {
  setup(a, s);
  int steps = 0;
  for (int b = 0; b < s.nv; ++b) steps = max(steps, s.cnt[b]);
  int nbits = 0;
  for (int st = 0; st < steps; ++st) {
    const int t = st % a.chunk;
    if (t == 0) {
      if (st > 0) claim_and_count(a, s, a.chunk - 1, -1, 0);
      __syncthreads();     // the old words are read no more
      nbits = min(a.chunk, steps - st);
      build(st, nbits);
      count_chunk(a, s, st, nbits);
    }
    claim_and_count(a, s, t > 0 ? t - 1 : -1, st, t);
    __syncthreads();
    // the barrier: every video's counter of this step, a warp a video: lane
    // 0 arrives and takes the decision, after the lanes loaded the chunk's
    // pixel totals at its first step (complete once every block arrived)
    const int lane = threadIdx.x & 31;
    for (int b = threadIdx.x >> 5; b < s.nv; b += blockDim.x >> 5) {
      const size_t vk = ((size_t)s.v0 + b) * a.K;
      int to = 0;
      if (lane == 0) {
        if (t == 0) __threadfence();   // this block's pixel counts first
        to = arrive_and_sum(a.ctr + vk + st, s.ovl[b]);
        s.ovl[b] = 0;
        if (t == 0) __threadfence();   // acquire the other blocks' counts
      }
      if (t == 0) {
        __syncwarp();
        if (lane < nbits)
          s.ntot[b * 32 + lane] =
              st + lane < s.cnt[b] ? __ldcg(&a.n_tot[vk + st + lane]) : 0;
        __syncwarp();
      }
      if (lane == 0) {
        int kept_slot = -1;
        if (st < s.cnt[b]) {
          const int slot = s.list[b * a.K + st];
          const int tn = s.ntot[b * 32 + t];
          const bool reject =
              tn == 0 || tn == a.HW ||
              __fdiv_rn(__int2float_rn(to), __int2float_rn(max(tn, 1))) >
                  a.frac;
          if (!reject) kept_slot = slot;
          if (blockIdx.x == 0) a.keep[vk + slot] = reject ? 0 : 1;
        }
        s.pend[b] = kept_slot;
      }
    }
    __syncthreads();
  }
  if (steps > 0) claim_and_count(a, s, (steps - 1) % a.chunk, -1, 0);
  if (!a.own_smem) return;
  __syncthreads();
  for (int b = 0; b < s.nv; ++b) {
    int8_t* dst = a.owner + ((size_t)s.v0 + b) * a.HW + s.p0;
    const int8_t* src = s.own(b);
    int i0 = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
      const int n4 = s.np >> 2;
      for (int i = threadIdx.x; i < n4; i += blockDim.x)
        reinterpret_cast<uint32_t*>(dst)[i] =
            reinterpret_cast<const uint32_t*>(src)[i];
      i0 = 4 * n4;
    }
    for (int i = i0 + threadIdx.x; i < s.np; i += blockDim.x) dst[i] = src[i];
  }
}

// The loop over the videos in groups of a.group, one group after the
// other: build(block, cbase, nbits) fills the group's words.  The shared
// memory (and device words) of one group serve every group.
template <typename Word, typename Build>
__device__ void run_groups(const Args& a, unsigned char* smem, Build build) {
  for (int v0 = 0; v0 < a.B; v0 += a.group) {
    Block<Word> s = carve<Word>(a, smem, v0);
    run_loop(a, s, [&](int cbase, int nbits) { build(s, cbase, nbits); });
    __syncthreads();       // the shared memory serves the next group
  }
}

// How many blocks of `kernel` at `smem` bytes of dynamic shared memory can
// be resident at once on the current device (0 without cooperative
// launches), with the kernel's shared-memory limit raised to the device's
// opt-in maximum; cached per (kernel, device, smem).
inline cudaError_t resident_blocks(const void* kernel, size_t smem,
                                   int* blocks) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  constexpr int N_CACHE = 16;
  static Entry cache[N_CACHE];
  static int used = 0, next = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].smem == smem) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  int coop = 0, sms = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  *blocks = coop ? per_sm * sms : 0;
  cache[next] = Entry{kernel, dev, smem, *blocks};
  next = (next + 1) % N_CACHE;
  used = used < N_CACHE ? used + 1 : N_CACHE;
  return cudaSuccess;
}

// Launches kernel (a __global__ of an Args and one more argument, *extra)
// cooperatively on `blocks` blocks of THREADS threads with the layout's
// shared memory, after zeroing the counters on the stream.  A grid that
// cannot be resident at once, or a device without cooperative launches, is
// refused with an error; there is no other way to run the loop.
inline cudaError_t launch(const void* kernel, Args a, int blocks,
                          cudaStream_t stream, const void* extra) {
  const size_t smem = claim_smem_bytes(a.group, a.K, a.run, a.chunk,
                                       a.own_smem, a.bits_smem,
                                       a.stage_per_slot);
  a.ctr = reinterpret_cast<unsigned long long*>(a.counts);
  a.n_tot = a.counts + 2 * (size_t)a.B * a.K;
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, smem, &resident);
  if (err == cudaSuccess && blocks > resident)
    err = resident ? cudaErrorCooperativeLaunchTooLarge
                   : cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.counts, 0,
                          sizeof(int32_t) * 3 * (size_t)a.B * a.K, stream);
  if (err != cudaSuccess) return err;
  void* params[] = {&a, const_cast<void*>(extra)};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS),
                                     params, smem, stream);
}

}  // namespace claim
