// Recovery validity scan: stage i32[N] -> member mask bool[N] (stage == VALID)
// and a 5-bin stage histogram i32[5] (exact matches of 0..4).
//
// Replaces the Pallas kernel `scan_pallas` / `_scan_kernel` of
// src/repro/kernels/recovery_scan/kernel.py.  The TPU version walks the
// stage vector tile by tile on one core and carries the histogram across
// grid steps in scratch memory; here blocks run in parallel, so each block
// counts in registers and shared memory and adds its 5 totals to the global
// histogram with atomics.
//
// Bound on an H100: memory.  The pass reads 4 bytes and writes 1 byte per
// node and does a handful of integer compares on them, so its least time is
// (5 N + 20) bytes / 3.35 TB/s (3.1 us at N = 2^21).  The design serves
// that bound:
//   * a grid-stride loop over 16-byte int4 loads of stages, with the four
//     mask bytes of each load stored as one 4-byte uchar4 write (neighbouring
//     threads on neighbouring addresses);
//   * the grid is capped at a few blocks per SM (the SM count is read once
//     per process) so that each thread loops several times and the
//     per-block epilogue (warp shuffles, 5 shared and 5 global atomics) is
//     paid rarely;
//   * any N is accepted: a scalar loop covers the tail past the last full
//     int4 and the whole vector when a pointer is not aligned.  (The TPU
//     wrapper's N % 8 tiling gate does not apply.)
//
// C interface, loaded with ctypes: every launcher returns cudaGetLastError()
// as an int, and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 5;
constexpr int kValid = 3;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void count(int s, int (&c)[kStages]) {
#pragma unroll
  for (int k = 0; k < kStages; ++k) c[k] += (s == k);
}

__global__ void __launch_bounds__(kThreads)
recovery_scan_kernel(const int* __restrict__ stage,
                     unsigned char* __restrict__ mask,
                     int* __restrict__ hist, long long n, long long n_vec) {
  __shared__ int block_hist[kStages];
  if (threadIdx.x < kStages) block_hist[threadIdx.x] = 0;
  __syncthreads();

  int c[kStages] = {0, 0, 0, 0, 0};
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  const int4* stage4 = reinterpret_cast<const int4*>(stage);
  uchar4* mask4 = reinterpret_cast<uchar4*>(mask);
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 v = __ldg(stage4 + i);
    mask4[i] = make_uchar4(v.x == kValid, v.y == kValid, v.z == kValid,
                           v.w == kValid);
    count(v.x, c);
    count(v.y, c);
    count(v.z, c);
    count(v.w, c);
  }
  for (long long i = n_vec * 4 + tid; i < n; i += stride) {
    const int s = __ldg(stage + i);
    mask[i] = (s == kValid);
    count(s, c);
  }

  // warp sums, then one shared atomic per warp and bin
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    int v = c[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&block_hist[k], v);
  }
  __syncthreads();
  if (threadIdx.x < kStages && block_hist[threadIdx.x])
    atomicAdd(&hist[threadIdx.x], block_hist[threadIdx.x]);
}

}  // namespace

// stage: int32[n]; mask: bool[n]; hist: int32[5], zeroed by the caller.
extern "C" int recovery_scan(const void* stage, void* mask, void* hist,
                             long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool aligned = (reinterpret_cast<uintptr_t>(stage) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(mask) % 4 == 0);
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec + (n - 4 * n_vec);
  static const int sms = [] {  // read once per process
    int device = 0, count = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  recovery_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(stage), static_cast<unsigned char*>(mask),
      static_cast<int*>(hist), n, n_vec);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
