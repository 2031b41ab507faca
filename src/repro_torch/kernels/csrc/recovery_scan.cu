// Recovery validity scan: stage i32[N] -> member mask bool[N] (stage == VALID)
// and a 5-bin stage histogram i32[5] (exact matches of 0..4).
//
// Replaces the Pallas kernel `scan_pallas` / `_scan_kernel` of
// src/repro/kernels/recovery_scan/kernel.py.  The TPU version walks the
// stage vector tile by tile on one core and carries the histogram across
// grid steps in scratch memory.  Here blocks run in parallel, in no order,
// so the histogram is a reduction across blocks, finished inside the same
// launch by the block that arrives last.
//
// Bound on an H100: memory.  The pass reads 4 bytes and writes 1 byte per
// node and does a handful of integer operations on them, so its least time
// is (5 N + 20) bytes / 3.35 TB/s (3.1 us at N = 2^21).  At the sizes the
// hybrid recovery and the queue's ring give it (N 8 to 2^16) that is well
// under a microsecond, and the launch's fixed cost is the time.  The
// design serves both:
//   * one launch per scan and nothing else: the wrapper allocates the mask
//     and the histogram with torch.empty, and the kernel writes all five
//     bins (no zero fill before it);
//   * a thread reads 16 consecutive stages a round as four 16-byte
//     `cp.async` copies into its own 64 bytes of shared memory, waits once
//     for all four, and writes their 16 mask bytes as one 16-byte store (a
//     warp: 2 KB in, 512 contiguous bytes out).  The copies write no
//     register, so the compiler cannot put a use between them: with four
//     register loads, ptxas scheduled the first load's tally between the
//     second and third (read from the SASS), and the warp then waited a
//     round trip before issuing the rest.  A warp's copy k reads bytes
//     16k to 16k + 15 of each lane's 64, so copies 0 and 1 (2 and 3) share
//     32-byte sectors; the copies go through L1 (`.ca`), which keeps the
//     sector the first fetched for the second, and device memory sees each
//     sector once (with `.cg`, L2 only, the scan took 1.8 us more at
//     2^23);
//   * the grid comes from the SM count: at most kBlocksPerSm = 4 blocks of
//     256 threads an SM, all resident at once (one wave), and no more
//     blocks than the rounds need (N = 2^16 takes 16 blocks, N <= 4096
//     one).  At 2^21 each thread does one round, at 2^23 about four;
//   * a thread counts its stages in one 32-bit word of five 6-bit fields
//     (1 << 6 s for stage s in 0..4, nothing for any other value) over a
//     round of at most 16 stages, then adds the fields to five counters:
//     about half the integer operations of five compares a stage;
//   * the block's totals come from warp shuffles and shared memory.  Then
//     thread k of each block adds (total_k << 16) + 1 to a 64-bit word of
//     bin k with one atomic that returns the old word: its low 16 bits
//     count the blocks already in (the grid is capped below 2^16), so the
//     thread that finds gridDim - 1 there holds the last block of that bin
//     and writes the bin's sum and zeroes the word, ready for the next
//     launch.  A grid of one block takes the same path (it finds 0).  The
//     count and the arrival travel in the same word, so no fence and no
//     second atomic is needed: one round trip after the block's sums,
//     where the textbook last-block reduction (partials, a fence, an
//     arrival counter, then a read of the partials) takes three.  The five
//     words are an operand, not a global of this library: the wrapper
//     keeps one zeroed set per CUDA stream, so scans on two streams never
//     share words, and scans on one stream run in order;
//   * any N is accepted: a scalar loop, four loads in flight a round (past
//     the end clamped to the last element, so that no select stands
//     between them), covers the tail past the last 16-stage chunk and the
//     whole vector when a pointer is not 16-byte aligned.  (The TPU
//     wrapper's N % 8 tiling gate does not apply.)
// Not a second pass or a cooperative grid sync: either adds a launch or a
// grid-wide barrier that every block waits at, where only the last block
// of a bin needs its sum.  Not a cluster: the grid has up to 528 blocks,
// and a cluster holds at most 16.  Not TMA: a thread's 64 bytes are its
// own, and the shared memory is only where its copies land, never shared
// between threads, so there is no tile to describe and no barrier.
//
// C interface, loaded with ctypes: every launcher returns cudaGetLastError()
// as an int, and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 5;
constexpr int kValid = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;          // loads a thread holds in flight
constexpr int kBlocksPerSm = 4;
constexpr int kChunk = 4 * kLoads;  // stages a thread reads a round
constexpr int kFieldBits = 6;      // a round counts at most kChunk < 64
constexpr int kArrivalBits = 16;   // blocks in, in the low bits of a bin
constexpr unsigned long long kArrivalMask = (1ull << kArrivalBits) - 1ull;

// One stage's tally in the packed word: 1 in the field of stages 0..4.
__device__ __forceinline__ unsigned tally(int s) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(kStages)
             ? 1u << (kFieldBits * s)
             : 0u;
}
__device__ __forceinline__ unsigned tally(const int4& v) {
  return tally(v.x) + tally(v.y) + tally(v.z) + tally(v.w);
}

__device__ __forceinline__ void unpack(unsigned p, int (&c)[kStages]) {
#pragma unroll
  for (int k = 0; k < kStages; ++k)
    c[k] += (p >> (kFieldBits * k)) & ((1u << kFieldBits) - 1u);
}

__device__ __forceinline__ unsigned member_bytes(const int4& v) {
  return static_cast<unsigned>(v.x == kValid) |
         static_cast<unsigned>(v.y == kValid) << 8 |
         static_cast<unsigned>(v.z == kValid) << 16 |
         static_cast<unsigned>(v.w == kValid) << 24;
}

// A 16-byte copy from device memory into shared memory, asynchronous,
// cached in L1 on its way.
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// The 16-stage chunks begin, begin + stride, ... below end: per chunk four
// 16-byte copies into ``mine`` (the thread's own kLoads int4 of shared
// memory), one wait, then one 16-byte store of its mask.
__device__ __forceinline__ void scan_chunks(const int4* __restrict__ stage4,
                                            uint4* __restrict__ mask16,
                                            int4* mine, long long begin,
                                            long long end, long long stride,
                                            int (&c)[kStages]) {
  for (long long i = begin; i < end; i += stride) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      copy16(mine + k, stage4 + i * kLoads + k);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    int4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = mine[k];
    mask16[i] = make_uint4(member_bytes(v[0]), member_bytes(v[1]),
                           member_bytes(v[2]), member_bytes(v[3]));
    unpack(tally(v[0]) + tally(v[1]) + tally(v[2]) + tally(v[3]), c);
  }
}

// The stages begin, begin + stride, ... below end, kLoads a round, every
// load of a round issued before any is used; a load past end reads
// element end - 1 and counts nothing.
__device__ __forceinline__ void scan_scalars(const int* __restrict__ stage,
                                             unsigned char* __restrict__ mask,
                                             long long begin, long long end,
                                             long long stride,
                                             int (&c)[kStages]) {
  for (long long i = begin; i < end; i += kLoads * stride) {
    int v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      v[k] = __ldg(stage + min(i + k * stride, end - 1));
    unsigned p = 0;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long j = i + k * stride;
      if (j < end) {
        mask[j] = (v[k] == kValid);
        p += tally(v[k]);
      }
    }
    unpack(p, c);
  }
}

__global__ void __launch_bounds__(kThreads)
recovery_scan_kernel(const int* __restrict__ stage,
                     unsigned char* __restrict__ mask,
                     int* __restrict__ hist,
                     unsigned long long* __restrict__ bins, long long n,
                     long long n_chunks) {
  int c[kStages] = {0, 0, 0, 0, 0};
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  __shared__ int4 staged[kThreads][kLoads];   // each thread's own 64 bytes
  scan_chunks(reinterpret_cast<const int4*>(stage),
              reinterpret_cast<uint4*>(mask), staged[threadIdx.x], tid,
              n_chunks, stride, c);
  scan_scalars(stage, mask, n_chunks * kChunk + tid, n, stride, c);

  // the block's totals: warp sums, then thread k < 5 adds bin k's warps
  __shared__ int warp_sum[kWarps][kStages];
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    int v = c[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32][k] = v;
  }
  __syncthreads();
  if (threadIdx.x >= kStages) return;
  int total = 0;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) total += warp_sum[wp][threadIdx.x];
  // bin k of the running scan: its count so far << 16 | the blocks in
  const unsigned long long old = atomicAdd(
      &bins[threadIdx.x],
      (static_cast<unsigned long long>(total) << kArrivalBits) + 1ull);
  if ((old & kArrivalMask) == gridDim.x - 1) {   // the bin's last block
    hist[threadIdx.x] = static_cast<int>((old >> kArrivalBits) + total);
    bins[threadIdx.x] = 0ull;
  }
}

}  // namespace

// stage: int32[n]; mask: bool[n]; hist: int32[5], every bin written;
// bins: uint64[5], zero before the launch and after it, used by no launch
// on another stream.
extern "C" int recovery_scan(const void* stage, void* mask, void* hist,
                             void* bins, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(stage) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  const long long n_chunks = aligned ? n / kChunk : 0;
  // thread-rounds: one a chunk, and one per kLoads scalars of the rest
  const long long work =
      n_chunks + (n - kChunk * n_chunks + kLoads - 1) / kLoads;
  static const int sms = [] {  // read once per process
    int device = 0, count = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  long long blocks = (work + kThreads - 1) / kThreads;
  long long cap = (long long)sms * kBlocksPerSm;
  if (cap > (long long)kArrivalMask) cap = (long long)kArrivalMask;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;   // N = 0 still writes the empty histogram
  recovery_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stage), static_cast<unsigned char*>(mask),
      static_cast<int*>(hist), static_cast<unsigned long long*>(bins), n,
      n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
