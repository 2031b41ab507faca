// Bucketized hash-table probe: for each query (bucket, key), the node id of
// the way whose key matches the query in its bucket row, else -1 (the max
// over matching ways; ids are unique, empty ways hold -1).
//
// Replaces the Pallas kernel `probe_pallas` / `_probe_kernel` of
// src/repro/kernels/hash_probe/kernel.py.  The TPU version turns the
// random bucket gather into a one-hot matrix product on the matrix unit,
// with keys split into 16-bit halves so that they survive float32, and
// sweeps every bucket tile for every query tile.  None of that is needed
// here: one thread per query reads its own bucket row directly, so the
// work is O(B * W) instead of O(B * NB * W), and keys and ids stay int32
// (no 2^24 id budget).
//
// Bound on an H100: memory.  The function must read each query's bucket
// index and key (8 bytes), the W keys and W ids of each distinct bucket row
// it touches (8 W bytes), and write one id (4 bytes); the compares are
// negligible.  The design serves that bound:
//   * a row is read with 16-byte int4 loads when W % 4 == 0 and the table
//     is 16-byte aligned (two loads of keys and two of ids at W = 8), else
//     with scalar loads;
//   * queries are independent, so there is no shared memory, no atomics and
//     no synchronisation; a block of 256 threads covers 256 queries.
//
// C interface, loaded with ctypes: every launcher returns cudaGetLastError()
// as an int, and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int* __restrict__ bucket_keys,
                  const int* __restrict__ bucket_ids,
                  const int* __restrict__ q_bucket,
                  const int* __restrict__ q_keys, int* __restrict__ out,
                  int b, int nb, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int qb = __ldg(q_bucket + i);
  const int q = __ldg(q_keys + i);
  int best = -1;
  if (qb >= 0 && qb < nb) {   // out-of-range buckets match nothing
    const long long row = (long long)qb * w;
    if (kVec) {
      const int4* k4 = reinterpret_cast<const int4*>(bucket_keys + row);
      const int4* d4 = reinterpret_cast<const int4*>(bucket_ids + row);
      for (int j = 0; j < w / 4; ++j) {
        const int4 k = __ldg(k4 + j);
        const int4 d = __ldg(d4 + j);
        if (d.x >= 0 && k.x == q) best = max(best, d.x);
        if (d.y >= 0 && k.y == q) best = max(best, d.y);
        if (d.z >= 0 && k.z == q) best = max(best, d.z);
        if (d.w >= 0 && k.w == q) best = max(best, d.w);
      }
    } else {
      for (int j = 0; j < w; ++j) {
        const int k = __ldg(bucket_keys + row + j);
        const int d = __ldg(bucket_ids + row + j);
        if (d >= 0 && k == q) best = max(best, d);
      }
    }
  }
  out[i] = best;
}

}  // namespace

// bucket_keys, bucket_ids: int32[nb, w]; q_bucket, q_keys, out: int32[b].
extern "C" int hash_probe(const void* bucket_keys, const void* bucket_ids,
                          const void* q_bucket, const void* q_keys, void* out,
                          int b, int nb, int w, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  const bool vec = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(bucket_keys) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(bucket_ids) % 16 == 0);
  const unsigned blocks = (unsigned)((b + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bk = static_cast<const int*>(bucket_keys);
  const int* bi = static_cast<const int*>(bucket_ids);
  const int* qb = static_cast<const int*>(q_bucket);
  const int* qk = static_cast<const int*>(q_keys);
  int* o = static_cast<int*>(out);
  if (vec)
    hash_probe_kernel<true><<<blocks, kThreads, 0, s>>>(bk, bi, qb, qk, o, b,
                                                        nb, w);
  else
    hash_probe_kernel<false><<<blocks, kThreads, 0, s>>>(bk, bi, qb, qk, o, b,
                                                         nb, w);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
