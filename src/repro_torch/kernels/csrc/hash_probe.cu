// Hash-table probes: the two routes of the Pallas kernel `probe_pallas` /
// `_probe_kernel` of src/repro/kernels/hash_probe/kernel.py, one entry each.
//
// hash_probe: the bucket backend's lookup.  For each query (bucket, key),
// the node id of the way whose key matches the query in its bucket row,
// else -1 (the max over matching ways; ids are unique, empty ways hold -1).
//
// The TPU kernel turns the random bucket gather into a one-hot matrix
// product on the matrix unit, with keys split into 16-bit halves so that
// they survive float32, and sweeps every bucket tile for every query
// tile.  None of that is needed here: one thread per query reads its own
// bucket row directly, so the work is O(B * W) instead of O(B * NB * W),
// and keys and ids stay int32 (no 2^24 id budget).
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
// table_probe: the probe backend's lookup (the JAX package's
// `table_lookup`, src/repro/kernels/hash_probe/ops.py, which gathers each
// query's 128-slot window into a bucket row of its own and calls
// `probe_pallas` at W = 128).  For each query key q, with home slot
// h = hash32(q) & (T - 1): the largest live id (>= 0) among the slots
// table[(h + d) & (T - 1)], d < max_probe, whose pool key pool_keys[id]
// equals q, else -1.  The whole window is read (no early exit), so the
// answer is right for any table, as the TPU route's is.
//
// Bound on an H100: memory, and at the map's shapes latency.  The function
// must read each query key and write its id (8 bytes), read the windows the
// queries touch (4 bytes a slot, 512 bytes a query at max_probe 128), and
// gather the pool key of each live slot in them.  The design:
//   * one warp per query: lane l reads the aligned 4-slot group l of the
//     window with one 16-byte load, so the warp sweeps the 512-byte window
//     in one coalesced pass (a window that does not start on a 4-slot
//     boundary touches 33 groups; lane 0 reads the last one).  The table's
//     length is a power of two of at least 4 and its start is 16-byte
//     aligned (the wrapper copies a table that is not), so an aligned group
//     never straddles the wrap at T - 1;
//   * pool keys are gathered only for live slots, in the same pass;
//   * `__reduce_max_sync` folds the lanes' bests; lane 0 stores.  No
//     shared memory, no atomics, and no (B, max_probe) plane in device
//     memory, where the TPU route materialises two.
//   * the hash is computed in the kernel, so the wrapper launches nothing
//     else.
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


constexpr int kWarpsPerBlock = 8;

// The JAX package's hash32 (splitmix-style avalanche) in uint32.
__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The id of a slot if it is live and its pool key is q, else -1.  An id past
// the pool reads the last key, as the reference's clipped gather does.
__device__ __forceinline__ int slot_match(int id, int q,
                                          const int* __restrict__ pool_keys,
                                          int n) {
  if (id < 0) return -1;
  return __ldg(pool_keys + min(id, n - 1)) == q ? id : -1;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
table_probe_kernel(const int* __restrict__ table,
                   const int* __restrict__ pool_keys,
                   const int* __restrict__ q_keys, int* __restrict__ out,
                   int b, unsigned tmask, int n, int max_probe) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= b) return;  // the whole warp leaves together
  const int q = __ldg(q_keys + i);
  const unsigned h = hash32(static_cast<unsigned>(q)) & tmask;
  const int r = static_cast<int>(h & 3u);  // window start within group 0
  const unsigned base = h - r;
  const int groups = (max_probe + r + 3) / 4;
  int best = -1;
  for (int g = lane; g < groups; g += 32) {
    const unsigned p = (base + 4u * static_cast<unsigned>(g)) & tmask;
    const int4 v = __ldg(reinterpret_cast<const int4*>(table + p));
    const int d = 4 * g - r;  // probe step of v.x
    if (d >= 0 && d < max_probe)
      best = max(best, slot_match(v.x, q, pool_keys, n));
    if (d + 1 >= 0 && d + 1 < max_probe)
      best = max(best, slot_match(v.y, q, pool_keys, n));
    if (d + 2 >= 0 && d + 2 < max_probe)
      best = max(best, slot_match(v.z, q, pool_keys, n));
    if (d + 3 < max_probe)
      best = max(best, slot_match(v.w, q, pool_keys, n));
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) out[i] = best;
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

// table: int32[t], 16-byte aligned, t a power of two >= 4; pool_keys:
// int32[n], n >= 1; q_keys, out: int32[b].
extern "C" int table_probe(const void* table, const void* pool_keys,
                           const void* q_keys, void* out, int b, int t, int n,
                           int max_probe, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* pk = static_cast<const int*>(pool_keys);
  const int* qk = static_cast<const int*>(q_keys);
  int* o = static_cast<int*>(out);
  const unsigned tmask = static_cast<unsigned>(t) - 1u;
  table_probe_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      tb, pk, qk, o, b, tmask, n, max_probe);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
