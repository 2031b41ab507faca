// Hash-table probes: the two routes of the Pallas kernel `probe_pallas` /
// `_probe_kernel` of src/repro/kernels/hash_probe/kernel.py, one entry each.
//
// hash_probe: the bucket backend's lookup, the whole of the JAX package's
// `ops.lookup` (src/repro/kernels/hash_probe/ops.py): for each query key q,
// its bucket qb = hash32(q) % NB, then the node id of the way of row qb
// whose key equals q, else -1 (the max over matching ways; ids are unique,
// empty ways hold -1).  One kernel body serves two sources of the bucket, a
// template parameter: "computed" (the hash above, in uint32, any NB >= 1),
// the engine's lookup; and "read" (a given q_bucket operand, the literal
// function of `probe_pallas`, where a bucket outside [0, NB) matches
// nothing), which the TPU route carried over at W = 128 and the tests use.
//
// The TPU kernel turns the random bucket gather into a one-hot matrix
// product on the matrix unit, with keys split into 16-bit halves so that
// they survive float32, and sweeps every bucket tile for every query
// tile.  None of that is needed here: one thread per query reads its own
// bucket row directly, so the work is O(B * W) instead of O(B * NB * W),
// and keys and ids stay int32 (no 2^24 id budget).  The JAX package hashes
// in the wrapper; here the hash is computed in the kernel, so the lookup
// is one launch and no (B,) bucket plane or int64 temporaries of the
// hash reach device memory.
//
// Bound on an H100.  By bytes: each query key in and id out (8 bytes), and
// the W keys and W ids of each distinct row touched (64 bytes at W = 8);
// the hash and compares are a few dozen integer operations a query.  At
// the map's batches (B 1024, a shard's 256) the bytes take well under a
// tenth of a microsecond, so latency bounds the launch: each query is two
// dependent round trips to device memory, its key and then its row (the
// key's hash says where).  At B 65536 over NB 2^19 rows the rows are
// random 32-byte sectors, two a query, with no reuse to speak of.  The
// design keeps every query to those two trips:
//   * a row whose W is a multiple of 4, in a 16-byte aligned table (every
//     spec of the port: SetSpec.bucket_width = 8), is read by int4 pairs
//     of keys and ids, else by scalars.  At W = 8 ptxas issues the row's
//     four 16-byte loads together, before any compare: the loop needs no
//     width of its own (the SASS, PERF.md);
//   * queries are independent: no shared memory, no atomics, no
//     synchronisation;
//   * 64-thread blocks: a shard's B 256 spreads over 4 SMs and B 1024 over
//     16, where 256-thread blocks put them on 1 and 4.  Every block is a
//     chain of two trips however few queries it holds, so more blocks
//     only add SMs in flight; 64, 128 and 256 threads were timed at B
//     256, 1024 and 65536 (PERF.md).
// Not TMA, `wgmma` or shared memory: the rows are 64-byte gathers at
// addresses known only after the key's hash, read once each.  There is no
// tile to stage, nothing a block reads twice, and no product.
//
// table_probe: the probe backend's lookup (the JAX package's
// `table_lookup`, src/repro/kernels/hash_probe/ops.py, which gathers each
// query's 128-slot window into a bucket row of its own and calls
// `probe_pallas` at W = 128).  For each query key q, with home slot
// h = hash32(q) & (T - 1): the largest live id (>= 0) among the slots
// table[(h + d) & (T - 1)], d < max_probe, whose pool key pool_keys[id]
// equals q, else -1.  The whole window is read (no early exit), so the
// answer is right for any table, as the TPU route's is.  A window of T or
// more slots holds every slot of the table, so the launcher reads
// min(max_probe, T) slots: the same set, each slot once.
//
// Bound on an H100: memory, and at the map's shapes (a shard's B = 256,
// the map's B = 1024) latency.  The function must read each query key and
// write its id (8 bytes), read the windows the queries touch (4 bytes a
// slot, 512 bytes a query at max_probe 128), and gather the pool key of
// each live slot in them.  Each query is a chain of three dependent round
// trips to device memory: its key, then its window (the key's hash says
// where), then the pool keys of the window's live ids.  The design keeps
// every query to those three, whatever the window's offset, and many
// queries' chains in flight at once:
//   * a group of G = 8 lanes serves one query, four queries a warp.  The
//     group's lanes load the query key from one address (one request a
//     warp for its four consecutive keys), and each lane hashes it;
//   * lane s of the group holds the aligned 4-slot groups s, s + 8, ...,
//     s + 32 of the window in K = 5 int4 registers, and issues all five
//     16-byte loads before it uses any of them.  40 groups (160 slots)
//     cover a 128-slot window at every start offset (it touches 33 groups
//     when h % 4 != 0).  The table's length is a power of two of at least
//     4 and its start is 16-byte aligned (the wrapper copies a table that
//     is not), so an aligned group never straddles the wrap at T - 1;
//   * then the lane issues the pool-key gathers of every live slot it
//     holds, all together, and only then compares them with q;
//   * three `__shfl_xor_sync` steps fold the group's bests, and one lane
//     stores.  Every lane of a warp takes part in the shuffles (a group
//     past B loads nothing and stores nothing), so no lane leaves early;
//   * a window longer than 160 slots (max_probe up to 2^30 by the
//     wrapper's check, cut to T) runs the same load-then-gather pass once
//     per 40 groups;
//   * 64-thread blocks, eight queries a block: a shard's B = 256 spreads
//     over 32 SMs and the map's B = 1024 over 128, where larger blocks
//     would leave most SMs idle at those batches.  At B = 65536 there are
//     8192 blocks, so every SM holds as many as its registers allow, each
//     with its chains in flight.
// Why G = 8 and K = 5: one pass covers a 128-slot window with five 16-byte
// loads and at most twenty 4-byte gathers in flight in each lane.  Fewer
// lanes a query need more registers a lane for the same window.  More
// lanes (a warp a query) spread a window over lanes that then load
// nothing, and at 33 groups leave one lane a second load and gather in
// series behind its first pair.
// Not TMA, `wgmma` or shared memory: this is a gather of 512-byte windows
// at random addresses, then 4-byte gathers at addresses read from them.
// There is no tile to stage, nothing a block reads twice, and no product.
// No atomics, and no (B, max_probe) plane in device memory, where the TPU
// route materialises two.  The hash is computed in the kernel, so the
// wrapper launches nothing else.
//
// C interface, loaded with ctypes: every launcher returns cudaGetLastError()
// as an int, and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBucketThreads = 64;

// The JAX package's hash32 (splitmix-style avalanche) in uint32.
__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int match4(const int4& k, const int4& d, int q,
                                      int best) {
  if (d.x >= 0 && k.x == q) best = max(best, d.x);
  if (d.y >= 0 && k.y == q) best = max(best, d.y);
  if (d.z >= 0 && k.z == q) best = max(best, d.z);
  if (d.w >= 0 && k.w == q) best = max(best, d.w);
  return best;
}

// kHash: the bucket is hash32(q) % nb; else it is read from q_bucket.
// kVec: the row is read by int4 pairs (W % 4 == 0, 16-byte aligned).
template <bool kHash, bool kVec>
__global__ void __launch_bounds__(kBucketThreads)
hash_probe_kernel(const int* __restrict__ bucket_keys,
                  const int* __restrict__ bucket_ids,
                  const int* __restrict__ q_bucket,
                  const int* __restrict__ q_keys, int* __restrict__ out,
                  int b, unsigned nb, int w) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kBucketThreads + threadIdx.x;
  if (i >= b) return;
  const int q = __ldg(q_keys + i);
  unsigned qb;
  if (kHash) {
    qb = hash32(static_cast<unsigned>(q)) % nb;
  } else {
    qb = static_cast<unsigned>(__ldg(q_bucket + i));
    if (qb >= nb) {   // out-of-range buckets (negative too) match nothing
      out[i] = -1;
      return;
    }
  }
  const long long row = static_cast<long long>(qb) * w;
  int best = -1;
  if (kVec) {
    const int4* k4 = reinterpret_cast<const int4*>(bucket_keys + row);
    const int4* d4 = reinterpret_cast<const int4*>(bucket_ids + row);
    for (int j = 0; j < w / 4; ++j)
      best = match4(__ldg(k4 + j), __ldg(d4 + j), q, best);
  } else {
    for (int j = 0; j < w; ++j) {
      const int k = __ldg(bucket_keys + row + j);
      const int d = __ldg(bucket_ids + row + j);
      if (d >= 0 && k == q) best = max(best, d);
    }
  }
  out[i] = best;
}

template <bool kHash>
void launch_hash_probe(bool vec, unsigned blocks, cudaStream_t s,
                       const int* bk, const int* bi, const int* qb,
                       const int* qk, int* o, int b, unsigned nb, int w) {
  if (vec)
    hash_probe_kernel<kHash, true><<<blocks, kBucketThreads, 0, s>>>(
        bk, bi, qb, qk, o, b, nb, w);
  else
    hash_probe_kernel<kHash, false><<<blocks, kBucketThreads, 0, s>>>(
        bk, bi, qb, qk, o, b, nb, w);
}


constexpr int kProbeLanes = 8;     // G: lanes serving one query
constexpr int kProbeLoads = 5;     // K: window loads a lane holds in flight
constexpr int kProbeGroups = kProbeLanes * kProbeLoads;  // groups a pass
constexpr int kProbeThreads = 64;
constexpr int kProbeQueries = kProbeThreads / kProbeLanes;  // a block's

__device__ __forceinline__ int slot_of(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// window: the slots read, min(max_probe, T).
__global__ void __launch_bounds__(kProbeThreads)
table_probe_kernel(const int* __restrict__ table,
                   const int* __restrict__ pool_keys,
                   const int* __restrict__ q_keys, int* __restrict__ out,
                   int b, unsigned tmask, int n, int window) {
  const int s = threadIdx.x % kProbeLanes;
  const long long i = static_cast<long long>(blockIdx.x) * kProbeQueries +
                      threadIdx.x / kProbeLanes;
  const bool active = i < b;
  const int q = active ? __ldg(q_keys + i) : 0;
  const unsigned h = hash32(static_cast<unsigned>(q)) & tmask;
  const int r = static_cast<int>(h & 3u);  // window start within group 0
  const unsigned base = h - r;
  const int groups = active ? (window + r + 3) / 4 : 0;
  int best = -1;
  for (int g0 = 0; g0 < groups; g0 += kProbeGroups) {
    // every window load of the pass, before any of them is used
    int4 v[kProbeLoads];
#pragma unroll
    for (int k = 0; k < kProbeLoads; ++k) {
      const int g = g0 + s + kProbeLanes * k;
      v[k] = make_int4(-1, -1, -1, -1);
      if (g < groups)
        v[k] = __ldg(reinterpret_cast<const int4*>(
            table + ((base + 4u * static_cast<unsigned>(g)) & tmask)));
    }
    // then the pool key of every live slot in the window, all gathered
    // before any is compared; an id past the pool reads the last key, as
    // the reference's clipped gather does
    int id[kProbeLoads][4], key[kProbeLoads][4];
#pragma unroll
    for (int k = 0; k < kProbeLoads; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * (g0 + s + kProbeLanes * k) + c - r;  // probe step
        id[k][c] = (d >= 0 && d < window) ? slot_of(v[k], c) : -1;
        key[k][c] = 0;
        if (id[k][c] >= 0)
          key[k][c] = __ldg(pool_keys + min(id[k][c], n - 1));
      }
    }
#pragma unroll
    for (int k = 0; k < kProbeLoads; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (id[k][c] >= 0 && key[k][c] == q) best = max(best, id[k][c]);
  }
  // the lanes of a group differ only in their low three bits
#pragma unroll
  for (int off = kProbeLanes / 2; off > 0; off /= 2)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (active && s == 0) out[i] = best;
}

}  // namespace

// bucket_keys, bucket_ids: int32[nb, w]; q_keys, out: int32[b]; q_bucket:
// int32[b], or null for the buckets hash32(q) % nb (then nb >= 1).
extern "C" int hash_probe(const void* bucket_keys, const void* bucket_ids,
                          const void* q_bucket, const void* q_keys, void* out,
                          int b, int nb, int w, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  if (nb < 0 || w < 0 || (q_bucket == nullptr && nb == 0))
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(bucket_keys) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(bucket_ids) % 16 == 0);
  const bool vec = aligned && w % 4 == 0;
  const unsigned blocks =
      (unsigned)(((long long)b + kBucketThreads - 1) / kBucketThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bk = static_cast<const int*>(bucket_keys);
  const int* bi = static_cast<const int*>(bucket_ids);
  const int* qb = static_cast<const int*>(q_bucket);
  const int* qk = static_cast<const int*>(q_keys);
  int* o = static_cast<int*>(out);
  if (qb == nullptr)
    launch_hash_probe<true>(vec, blocks, s, bk, bi, qb, qk, o, b,
                            (unsigned)nb, w);
  else
    launch_hash_probe<false>(vec, blocks, s, bk, bi, qb, qk, o, b,
                             (unsigned)nb, w);
  return (int)cudaGetLastError();
}

// table: int32[t], 16-byte aligned, t a power of two >= 4; pool_keys:
// int32[n], n >= 1; q_keys, out: int32[b].
extern "C" int table_probe(const void* table, const void* pool_keys,
                           const void* q_keys, void* out, int b, int t, int n,
                           int max_probe, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)(((long long)b + kProbeQueries - 1) / kProbeQueries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* pk = static_cast<const int*>(pool_keys);
  const int* qk = static_cast<const int*>(q_keys);
  int* o = static_cast<int*>(out);
  const unsigned tmask = static_cast<unsigned>(t) - 1u;
  table_probe_kernel<<<blocks, kProbeThreads, 0, s>>>(
      tb, pk, qk, o, b, tmask, n, max_probe < t ? max_probe : t);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
