// GQA flash attention for prefill, masked by sequence index or by
// per-token positions, optionally windowed.
// out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j,
// h / G] with G = H / KV query heads sharing each KV head, over the live
// keys j:
//  - by index (no positions; Sq == Sk = S): j <= i, and j > i - window
//    when window > 0 (causal prefill at the default positions);
//  - by positions (int32 qpos [B, Sq], kpos [B, Sk]; Sk free): kpos[b, j]
//    <= qpos[b, i], and kpos[b, j] > qpos[b, i] - window when window > 0,
//    the masks of the JAX model's attention_dense.  M-RoPE's temporal
//    positions repeat (an image's patches share one); all-zero positions
//    make every pair live (whisper's encoder and cross-attention, Sk the
//    1500 frames).  A query with no live key averages every value, as the
//    plain version's -1e30 logits do.
//
// Replaces the Pallas kernel `flash_prefill_pallas` / `_kernel` of
// src/repro/kernels/flash_prefill/kernel.py.  The TPU version runs the key
// tiles along the innermost sequential grid axis with the online softmax
// state (m, l, acc) in VMEM scratch, and skips dead (q-tile, k-tile) pairs
// with pl.when.  Here one block owns one (batch row, query head, 64-query
// tile) and loops over the live key tiles itself, so dead pairs are never
// visited: the loop starts at the first tile that holds a key > q0 - window
// and stops after the tile that holds the tile's last query, which is the
// same test as the TPU kernel's `live` (k_base <= q_base + qt - 1 and
// k_base + kt - 1 > q_base - window).  The S x S logits never reach device
// memory.  The TPU wrapper's S % 128 gate and its transpose to
// (B, KV, S, G, D) are gone: the kernel reads [B, S, H, D] through strides;
// rows and keys >= S are zero-filled and masked.  Masked logits are -1e30
// and the result is acc / max(l, 1e-30), as in the TPU kernel, so a row
// with no live key in a tile behaves as there.
//
// Bound on an H100 at the serving shape (B 8, S 512, H 64, KV 8, D 128,
// bf16, causal): bytes, 151.0 MB of q, k, v and out at 3.35 TB/s = 45.07
// us; operations, 34.43 GFLOP of the causal half at 989 TFLOP/s = 34.8 us.
// q and out are 134 of the 151 MB.
//
// bf16 inputs (`flash_prefill_tc_kernel`) run on the tensor cores, with
// wgmma and TMA (sm_90a):
//  - One warpgroup (4 warps x 16 query rows) owns 64 queries of one query
//    head; key tiles are 64 keys.  S = Q K^T is wgmma m64n64k16 with Q and
//    K read from shared memory, bf16 operands and f32 accumulation: a
//    product of two bf16 values is exact in f32, so this is the TPU
//    kernel's f32 dot up to the order of the sums.
//  - P V at f32 accuracy, as in the TPU kernel (which keeps p in f32): the
//    f32 P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two
//    wgmmas (A from registers) against the same bf16 V tile go into one f32
//    accumulator.  P_hi + P_lo carries about 16 significant bits; a P
//    rounded to bf16 alone (8 bits) would not be this function.  The P V
//    product costs twice the tensor-core work of a bf16-P kernel.
//  - Copies are TMA: one thread loads Q, and then the K and V tiles into a
//    ring of three shared-memory slots with an mbarrier each, so that the
//    next tile is in flight while this one is computed; out-of-range rows
//    and head-dim columns arrive as zeros.  O is staged in Q's buffer and
//    leaves by TMA store, which writes only rows < S and columns < D.  No
//    load or store instruction of the threads touches q, k, v or out.
//  - 65 KB of shared memory and about 160 registers a thread at D = 128
//    keep 3 blocks on an SM, so one block's softmax and waits overlap
//    another's wgmmas.
//  - The G query heads of one KV head and one query tile are neighbours in
//    launch order, so each K/V tile comes from device memory about once
//    and from L2 for the other G - 1 heads.  The query tiles with the most
//    key tiles are launched first, so the causal triangle leaves no tail
//    of idle SMs.
//  - Only the diagonal and window-edge tiles (and the ragged tile at S)
//    apply the element mask; O is rescaled only when a row's max moved.
//  - Head dims that are not a multiple of 64 (D = 8, 120, ...) run in the
//    next instantiation up (64, 128, 192, 256) with zero columns.
//  - By positions (a second instantiation of each, so the index path's code
//    is as before): the K and V maps take Sk rows; every tile applies the
//    element mask, with the tile's 64 key positions staged in shared memory
//    while its Q K^T runs and each thread's two query rows' positions in
//    registers; keys past Sk are -inf, so they weigh nothing even in a row
//    with no live key.  Every key tile is visited (no tile is skipped by
//    positions); the launch order stays the index path's.
// What is left for later: warp specialization (a producer warp and two
// consumer warpgroups in ping-pong, as in FlashAttention-3) and 128-query
// tiles, so that K and V tiles are read from L2 fewer times; issuing the
// next tile's Q K^T before this tile's softmax was tried and gained
// nothing over 3 blocks per SM.
//
// f32 inputs (`flash_prefill_kernel`) keep the CUDA-core design, so that
// they keep f32 accuracy (3e-5): both products in f32 from shared memory
// with 4 x 2 and 4 x 8 register tiles per thread.  By positions it visits
// every key tile and masks each element.
//
// Per process, not per launch: each instantiation's shared-memory opt-in
// and libcuda's cuTensorMapEncodeTiled are set up once (function-local
// statics); the four TMA descriptors are encoded on the host per launch.
// C interface, loaded with ctypes: every launcher returns a CUDA error code
// as an int, and never synchronises.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 32;         // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

struct Strides {            // element strides of one [B, S, heads, D] tensor
  long long b, s, h;
};

// Shared memory, in floats: qs[BQ][D + 1], ks[BK][D + 1], vs[BK][D],
// ss[BQ][BK + 1], then m[BQ], l[BQ], alpha[BQ], and with positions the
// int32 positions of the block's queries and of the current key tile.  The
// odd row pitches put the rows that one warp reads together in distinct
// banks.
size_t smem_bytes(int d, bool pos) {
  return sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                          (size_t)kBK * d + (size_t)kBQ * (kBK + 1) +
                          3 * (size_t)kBQ + (pos ? kBQ + kBK : 0));
}

// -inf: a key past the end of the keys, which weighs nothing even in a
// query row that has no live key (masked keys weigh exp(0) there)
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Position masks (POS): a pair is live when kpos <= qpos and, with a
// window, kpos > qpos - window, in int32 arithmetic that wraps as JAX's
__device__ __forceinline__ bool pos_live(int kp, int qp, int window) {
  return kp <= qp &&
         (window == 0 || kp > (int)((unsigned)qp - (unsigned)window));
}

// NJ: head-dim columns each thread accumulates (D <= 16 * NJ).  S is the
// number of queries; Sk the number of keys, equal to S without positions.
template <typename T, int NJ, bool POS>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_, int S,
                     int Sk, int G, int D, int window, float scale,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qsm = smem;
  float* ksm = qsm + kBQ * DP;
  float* vsm = ksm + kBK * DP;
  float* ssm = vsm + kBK * D;
  float* ms = ssm + kBQ * (kBK + 1);
  float* ls = ms + kBQ;
  float* as = ls + kBQ;
  int* qps = reinterpret_cast<int*>(as + kBQ);   // POS only
  int* kps = qps + kBQ;

  // the heaviest query tiles (most key tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = h / G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + n * ks_.h;
  const T* vb = v + b * vs_.b + n * vs_.h;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qsm[r * DP + d] = q0 + r < S ? to_f32(qb[(q0 + r) * qs_.s + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
    if (POS) qps[r] = q0 + r < S ? qpos[(long long)b * S + q0 + r] : 0;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // by index: the live key tiles only (through the tile of the last
  // query); by positions: every key tile
  const int k_last = POS ? Sk - 1 : min(q0 + kBQ, S) - 1;
  const int k_first = !POS && window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / kBK * kBK; k0 <= k_last; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < Sk;
      ksm[j * DP + d] = in ? to_f32(kb[(k0 + j) * ks_.s + d]) : 0.f;
      vsm[j * D + d] = in ? to_f32(vb[(k0 + j) * vs_.s + d]) : 0.f;
    }
    if (POS && tid < kBK && k0 + tid < Sk)
      kps[tid] = kpos[(long long)b * Sk + k0 + tid];
    __syncthreads();

    // logits: rows ty + 16 i, keys tx + 16 j
    float sacc[4][2] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qsm[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ksm[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qp = q0 + ty + 16 * i, kp = k0 + tx + 16 * j;
        float x;
        if (POS) {   // keys past Sk weigh nothing, even in a dead row
          x = kp >= Sk ? neg_inf()
              : pos_live(kps[tx + 16 * j], qps[ty + 16 * i], window)
                  ? sacc[i][j] * scale : kNegInf;
        } else {
          bool live = kp < S && kp <= qp;
          if (window > 0) live = live && kp > qp - window;
          x = live ? sacc[i][j] * scale : kNegInf;
        }
        ssm[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = x;
      }
    __syncthreads();

    // online softmax: 4 threads per row, 8 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* srow = ssm + r * (kBK + 1) + part * 8;
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < 8; ++t) mx = fmaxf(mx, srow[t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float p = expf(srow[t] - m_new);
        srow[t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        as[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = as[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ssm[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? vsm[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();   // the last tile's l is written

  T* ob = out + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) ob[(q0 + r) * os_.s + d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ, bool POS>
int launch(const T* q, const T* k, const T* v, T* out, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int S, int Sk, int H,
           int KV, int D, int window, const int* qpos, const int* kpos,
           cudaStream_t s) {
  // the opt-in covers the largest D of this instantiation, once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<T, NJ, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(16 * NJ, POS));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_prefill_kernel<T, NJ, POS>
      <<<grid, kThreads, smem_bytes(D, POS), s>>>(
          q, k, v, out, sq, sk, sv, so, S, Sk, H / KV, D, window,
          1.0f / sqrtf((float)D), qpos, kpos);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // one warpgroup: 4 warps x 16 query rows
constexpr int kTcBQ = 64;         // queries per block
constexpr int kTcBK = 64;         // keys per tile
constexpr int kBox = 64 * 128;    // bytes of one TMA box: 64 rows x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: the Q tile (which later stages O for the TMA store), then
// three slots for the block's sequence of K and V tiles, then one mbarrier
// each, and 1024 bytes to align the tiles.  Each [64][DP] tile is DP / 64
// TMA boxes of 64 rows x 128 bytes in the 128-byte swizzle (16-byte chunk c
// of row r stored at chunk c ^ (r % 8)): the layout that wgmma reads as
// K-major (Q, K: rows along M or N, D along K) and as MN-major (V: keys
// along K, D along N).  At D = 128 that is 65 KB and 157 registers a
// thread: 3 blocks per SM.
// With positions (POS), 256 bytes more after the barriers: the current key
// tile's positions (64 ints).
template <int DP, bool POS>
struct TcShape {
  static constexpr int kTile = DP / 64 * kBox;
  static constexpr size_t kSmem = 4 * (size_t)kTile + 32 + 1024 +
                                  (POS ? 256 : 0);
  static constexpr int kMinBlocks = DP <= 64 ? 4 : (DP <= 128 ? 3 : 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// one box of rows [row, row + 64) and columns [col, col + 64) of head
// `head` of batch row `b`; zeros where the box leaves the tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col),
         "r"(head), "r"(row), "r"(b)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, leading
// and stride byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin accumulator registers in place around the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B, m64n64k16, A and B both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A in registers (the mma.sync A-fragment layout of
// each warp's 16 rows), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) = hi + lo, each a packed bf16 pair: about 16 significant bits
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One warpgroup per (query tile, batch row, query head): blockIdx.x runs
// over the heads fastest, then the batch rows, then the query tiles from
// the last (most key tiles, by index) to the first.  S queries, Sk keys
// (Sk == S without positions).
template <int DP, bool POS>
__global__ void __launch_bounds__(kTcThreads, TcShape<DP, POS>::kMinBlocks)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to, int S, int Sk,
                        int H, int G, int n_qt, int window, float scale_log2,
                        const int* __restrict__ qpos,
                        const int* __restrict__ kpos) {
  constexpr int kTile = TcShape<DP, POS>::kTile;
  extern __shared__ unsigned char smem_tc[];
  const uint32_t q_addr = (smem_u32(smem_tc) + 1023) & ~1023u;
  const uint32_t bars = q_addr + 4 * kTile;   // Q, then the 3 slots
  const int bh = gridDim.x / n_qt;
  const int t = blockIdx.x / bh, rem = blockIdx.x - t * bh;
  const int h = rem % H, b = rem / H, n = h / G;
  const int q0 = (n_qt - 1 - t) * kTcBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int kt_first, n_kt;
  int* kps = nullptr;   // POS: the current key tile's positions
  int qp[2] = {0, 0};   // POS: the positions of rows r0 and r0 + 8
  if constexpr (POS) {
    qpos += (long long)b * S;
    kpos += (long long)b * Sk;
    kps = reinterpret_cast<int*>(smem_tc +
                                 (bars + 32 - smem_u32(smem_tc)));
    kt_first = 0;   // every key tile, each element masked
    n_kt = (Sk + kTcBK - 1) / kTcBK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < S) qp[r] = qpos[row];
    }
  } else {
    const int q_last = min(q0 + kTcBQ, S) - 1;
    kt_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kTcBK;
    n_kt = q_last / kTcBK - kt_first + 1;
  }

  // the block's K and V tiles form one sequence K0 V0 K1 V1 ...; element e
  // lands in slot e % 3.  K_t's slot is refilled (with V_t+1) as soon as
  // Q K_t^T is done, V_t's (with K_t+2) as soon as P V_t is: each copy has
  // about a tile's compute to arrive in.
  auto load_elem = [&](int e) {
    const int slot = e % 3, kt = kt_first + e / 2;
    const uint32_t bar = bars + 8 * (1 + slot);
    const CUtensorMap* map = (e & 1) ? &tv : &tk;
    mbar_expect(bar, kTile);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(q_addr + (1 + slot) * kTile + c * kBox, map, c * 64, n,
               kt * kTcBK, b, bar);
  };
  auto wait_elem = [&](int e) {
    mbar_wait(bars + 8 * (1 + e % 3), (e / 3) & 1);
    return q_addr + (1 + e % 3) * kTile;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars, kTile);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(q_addr + c * kBox, &tq, c * 64, h, q0, b, bars);
    load_elem(0);
    load_elem(1);
    if (n_kt > 1) load_elem(2);
  }
  __syncthreads();   // the barriers are initialized

  float o[DP / 64][32];
#pragma unroll
  for (int i = 0; i < DP / 64; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8
  mbar_wait(bars, 0);

  for (int it = 0; it < n_kt; ++it) {
    const int kt = kt_first + it;
    int kp_next = 0;   // POS: this tile's key positions, on their way
    if (POS && threadIdx.x < kTcBK && kt * kTcBK + threadIdx.x < Sk)
      kp_next = kpos[kt * kTcBK + threadIdx.x];
    const uint32_t k_addr = wait_elem(2 * it);

    // S = Q K^T: 64 queries x 64 keys, 16 rows per warp; a 16-column step
    // of D is 32 bytes into a swizzled 128-byte row
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
      wgmma_ss(s, desc(q_addr + off, 16, 1024), desc(k_addr + off, 16, 1024),
               kk);
    }
    wg_commit_wait();
    fence_regs(s);
    if (POS && threadIdx.x < kTcBK) kps[threadIdx.x] = kp_next;
    __syncthreads();   // every warp has read K_t: refill its slot
    if (threadIdx.x == 0 && it + 1 < n_kt) load_elem(2 * it + 3);

    // scale to log2 units; by index the element mask only on the diagonal
    // and window-edge tiles and the ragged tile at S, by positions on
    // every tile (keys past Sk at -inf)
    const int k0 = kt * kTcBK;
    const bool edge = k0 + kTcBK - 1 > q0 || k0 + kTcBK > S ||
                      (window > 0 && k0 <= q0 + kTcBQ - 1 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * scale_log2;
      if constexpr (POS) {
        const int c = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        if (k0 + c >= Sk)
          x = neg_inf();
        else if (!pos_live(kps[c], qp[(e >> 1) & 1], window))
          x = kNegInf;
      } else if (edge) {
        const int qp = r0 + ((e >> 1) & 1) * 8;
        const int kp = k0 + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
        const bool live = kp < S && kp <= qp &&
                          (window == 0 || kp > qp - window);
        if (!live) x = kNegInf;
      }
      s[e] = x;
    }

    // online softmax; a row's 64 logits live in the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 2 * r] = exp2_approx(s[4 * j + 2 * r] - mx);
        s[4 * j + 2 * r + 1] = exp2_approx(s[4 * j + 2 * r + 1] - mx);
        sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;   // this lane's part of the row sum
      if (__any_sync(0xffffffffu, alpha != 1.f)) {   // a row max moved
#pragma unroll
        for (int i = 0; i < DP / 64; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[i][4 * j + 2 * r] *= alpha;
            o[i][4 * j + 2 * r + 1] *= alpha;
          }
      }
    }

    // O += (P_hi + P_lo) V: the accumulator fragments of two 8-key column
    // groups of S are the A fragment of one 16-key step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_bf16x2(s[8 * j], s[8 * j + 1], ph[j][0], pl[j][0]);
      split_bf16x2(s[8 * j + 2], s[8 * j + 3], ph[j][1], pl[j][1]);
      split_bf16x2(s[8 * j + 4], s[8 * j + 5], ph[j][2], pl[j][2]);
      split_bf16x2(s[8 * j + 6], s[8 * j + 7], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int i = 0; i < DP / 64; ++i) fence_regs(o[i]);
    const uint32_t v_addr = wait_elem(2 * it + 1);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < DP / 64; ++i) {
        // 16 keys = 16 swizzled rows of 128 bytes; 64 columns = one box.
        // P_hi and P_lo go against the same V fragment into one f32 sum.
        const uint64_t dv = desc(v_addr + i * kBox + j * 2048, 8192, 1024);
        wgmma_rs(o[i], ph[j], dv);
        wgmma_rs(o[i], pl[j], dv);
      }
    wg_commit_wait();
#pragma unroll
    for (int i = 0; i < DP / 64; ++i) fence_regs(o[i]);

    __syncthreads();   // every warp is done with V_t: refill its slot
    if (threadIdx.x == 0 && it + 2 < n_kt) load_elem(2 * it + 4);
  }

  // O / l in bf16 into the Q buffer, in the same swizzled boxes, then one
  // TMA store per box; rows >= S and columns >= D are not written
  unsigned char* ot = smem_tc + (q_addr - smem_u32(smem_tc));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = warp * 16 + (lane >> 2) + 8 * r;
#pragma unroll
    for (int i = 0; i < DP / 64; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            ot + i * kBox + row * 128 + ((j ^ (row & 7)) << 4) +
            (lane & 3) * 4) =
            __floats2bfloat162_rn(o[i][4 * j + 2 * r] * inv,
                                  o[i][4 * j + 2 * r + 1] * inv);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < DP / 64; ++i)
      tma_store(&to, q_addr + i * kBox, i * 64, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once per process (the library
// links against the CUDA runtime only; libcuda is loaded by then)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A [B, S, heads, D] bf16 tensor as a 4-d TMA map with dims (D, heads, S,
// B), boxes of 64 x 1 x 64 x 1, 128-byte swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, Strides st, int B, int S,
              int heads, int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool POS>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out,
              Strides sq, Strides sk, Strides sv, Strides so, int B, int S,
              int Sk, int H, int KV, int D, int window, const int* qpos,
              const int* kpos, cudaStream_t s) {
  constexpr size_t smem = TcShape<DP, POS>::kSmem;
  // the shared-memory opt-in, once per process and instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<DP, POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, sq, B, S, H, D) ||
      !make_map(&tk, k, sk, B, Sk, KV, D) ||
      !make_map(&tv, v, sv, B, Sk, KV, D) ||
      !make_map(&to, out, so, B, S, H, D))
    return (int)cudaErrorInvalidValue;
  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const unsigned grid = (unsigned)n_qt * (unsigned)B * (unsigned)H;
  flash_prefill_tc_kernel<DP, POS><<<grid, kTcThreads, smem, s>>>(
      tq, tk, tv, to, S, Sk, H, H / KV, n_qt, window,
      kLog2e / sqrtf((float)D), qpos, kpos);
  return (int)cudaGetLastError();
}

template <bool POS>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const long long* strides, int B, int S, int Sk, int H, int KV,
             int D, int window, int dtype, const int* qpos, const int* kpos,
             cudaStream_t s) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  if (dtype == 0) {
    const float* qt = static_cast<const float*>(q);
    const float* kt = static_cast<const float*>(k);
    const float* vt = static_cast<const float*>(v);
    float* ot = static_cast<float*>(out);
    if (D <= 64)
      return launch<float, 4, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk,
                                   H, KV, D, window, qpos, kpos, s);
    if (D <= 128)
      return launch<float, 8, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk,
                                   H, KV, D, window, qpos, kpos, s);
    return launch<float, 16, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk,
                                  H, KV, D, window, qpos, kpos, s);
  }
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(out);
  if (D <= 64)
    return launch_tc<64, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk, H,
                              KV, D, window, qpos, kpos, s);
  if (D <= 128)
    return launch_tc<128, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk, H,
                               KV, D, window, qpos, kpos, s);
  if (D <= 192)
    return launch_tc<192, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk, H,
                               KV, D, window, qpos, kpos, s);
  return launch_tc<256, POS>(qt, kt, vt, ot, sq, sk, sv, so, B, S, Sk, H,
                             KV, D, window, qpos, kpos, s);
}

}  // namespace

// q, out: [B, Sq, H, D]; k, v: [B, Sk, KV, D], each with a unit stride
// along D and the element strides (batch, sequence, head) given in
// `strides` (q, k, v, out: 12 values).  dtype 0 = float32, 1 = bfloat16
// (then every pointer 16-byte aligned and every stride a multiple of 8); D
// a multiple of 8 in [8, 256]; window 0 = no window.  qpos and kpos: both
// null (the mask is causal by index; Sq == Sk), or contiguous int32
// [B, Sq] and [B, Sk] (the mask is by position).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int B,
                             int Sq, int Sk, int H, int KV, int D, int window,
                             int dtype, const void* qpos, const void* kpos,
                             void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  const bool pos = qpos != nullptr;
  if (KV <= 0 || H % KV != 0 || D < 8 || D > 256 || D % 8 != 0 ||
      window < 0 || (dtype != 0 && dtype != 1) || Sk <= 0 ||
      pos != (kpos != nullptr) || (!pos && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos)
    return dispatch<true>(q, k, v, out, strides, B, Sq, Sk, H, KV, D,
                          window, dtype, qp, kp, st);
  return dispatch<false>(q, k, v, out, strides, B, Sq, Sk, H, KV, D, window,
                         dtype, qp, kp, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
