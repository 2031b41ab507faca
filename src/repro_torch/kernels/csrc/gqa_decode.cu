// GQA decode attention: one query token per batch row against a KV cache.
// out[b, n*G + g] = sum_s p_s v[b, s, n] with p = softmax over all S slots
// of q[b, n*G + g] . k[b, s, n] / sqrt(D), where the slots s >= length[b]
// have logit -1e30; the result is acc / max(l, 1e-30).  So a row with
// length <= 0 attends uniformly over all S slots, and length > S reads S.
//
// Replaces the Pallas kernel `gqa_decode_pallas` / `_decode_kernel` of
// src/repro/kernels/gqa_decode/kernel.py.  The TPU version walks the cache
// in sequence tiles along a sequential grid axis, carrying the online
// softmax state (m, l, acc) in VMEM from one grid step to the next.
//
// Bound on an H100: memory.  Each (b, KV head) must read its live K and V
// prefix once, 2 * live * D * elt bytes with live = min(length, S) (S when
// length <= 0); q and out are 1/S of that.  The G * live * D multiply-adds
// are two orders of magnitude under either core type's rate.  At the
// serving shape (B 8, H 64, KV 8, D 128, S 544, bf16) the whole cache is
// 17.8 MB, 5.3 us at 3.35 TB/s, so the kernel's fixed costs (launch,
// first-byte latency, the merge) weigh as much as its bytes.
//
// The design:
//  * Split.  Each (b, KV head) cuts [0, S) into `chunks` chunks of
//    `chunk_len` slots, one block each; the plan comes from the wrapper
//    (`split_plan` in kernels/gqa_decode/kernel.py: whole 64-slot tiles,
//    enough chunks for two blocks per SM, at most 8), computed once per
//    shape.  The host cannot read `length` without a sync, so the plan
//    depends on S, B, KV and the SM count only; a chunk that starts at or
//    past its row's live end loads nothing and adds an empty partial.  At
//    the serving shape: 5 chunks of 128 slots, 320 blocks on 132 SMs
//    (shared memory has room for three on an SM).  G > 8 adds a grid row per 8 query heads, each
//    of which reads the K/V again.
//  * Merge, in the same launch.  The chunks of one (b, KV head, 8 heads)
//    form one thread-block cluster (chunks <= 8, the portable size).  Each
//    block merges its four warps' partials (m, l, acc[8][D]) in shared
//    memory, then pushes its (m, l) to every block of the cluster and each
//    slice of its acc to the block that writes that slice of the output,
//    by stores to distributed shared memory, into an inbox beside the
//    ring; one cluster barrier later every block reads only its own
//    inbox: m* = max m_i, l = sum l_i 2^(m_i - m*), acc = sum acc_i
//    2^(m_i - m*), out = acc / max(l, 1e-30).  Stores do not wait on the
//    remote SM, so the merge costs one barrier, not a chain of remote
//    loads; a barrier arrival at the kernel's start, waited on only before
//    the first remote store, guarantees every inbox exists by then.  A
//    workspace in device memory with a last-block merge would need an
//    arrival counter kept zeroed between launches, a fence and a second
//    read of the partials from L2; a second launch would cost the host
//    about 20 us on a step that the host already bounds.  Masked logits
//    stay -1e30 and the running max starts at -1e30, so an empty or
//    all-masked partial (m -1e30) weighs 0 or 1, never NaN; slots past a
//    chunk's end (the ragged last tile, zero-filled) get -inf, which adds
//    exp2(-inf) = 0.  Softmax runs in base 2 (logits scaled by log2 e).
//  * Bytes.  Four warps; a two-stage ring of 64-slot tiles (32 in f32) of
//    K and V in shared memory, filled by 16-byte cp.async (8 bf16 or 4 f32
//    a thread, neighbouring threads on neighbouring vectors of a row).
//    Both stages are issued before q is loaded, so a two-tile chunk (the
//    serving shape's) has all its bytes in flight at once; a longer chunk
//    refills a stage as soon as its tile is computed, so one tile is in
//    flight during each tile's compute.  Rows are padded by 16 bytes
//    (conflict-free ldmatrix) and out to DP = 64, 128 or 256 columns
//    (bf16) or 128 or 256 (f32): vectors past D and rows past the chunk
//    are zero-filled by cp.async.  So D = 8 or 120 (15 bf16 vectors, not a
//    power of two) only adds zero columns: in bf16 the mma tiles walk DP
//    in steps of 16; in f32 lane j owns vectors j and j + 32 of the padded
//    row, and a lane past D multiplies zeros.
//  * Compute, bf16: each warp takes 16 slots of the tile and runs
//    mma.sync.m16n8k16 with slots as M and the 8 heads as N: S = K Q^T
//    (K by ldmatrix, Q^T fragments in registers for the whole kernel),
//    then out^T += V^T P^T (V by ldmatrix.trans), P^T from S's accumulator
//    by movmatrix.trans.  P goes in as two bf16 halves, P_hi = bf16(p) and
//    P_lo = bf16(p - P_hi), into one f32 sum: about 16 bits of p, as in
//    flash_prefill.cu, where bf16 P alone gave 4x the error.  m, l and the
//    f32 accumulator stay in registers.  f32: the tensor cores have no f32
//    product, so each warp takes 8 slots one at a time on the CUDA cores,
//    the 8 dot products summed across lanes by shuffles; q (pre-scaled)
//    and acc in registers.
//  * Registers (ptxas -v, sm_90a, nvcc 12.9): bf16 DP 64 / 128 / 256 use
//    64 / 94 / 164, f32 DP 128 / 256 use 128 / 241; every instantiation
//    has 0 bytes of stack frame and of spills.
//
// What separates it from the bound (measured on an NVIDIA H100 80GB HBM3
// at 700 W: PERF.md): the launch of a clustered grid, the read of `length`
// before any copy can be sized, one DRAM latency before the first tile,
// the two block-wide merges and the cluster barrier; at random lengths the
// chunks past a row's end still occupy their block.  Accumulation is f32
// throughout in both types.
//
// Setup is once per process: cudaFuncSetAttribute per instantiation
// (function-local static); the launcher queries no device attribute.
//
// C interface, loaded with ctypes: the launcher returns a CUDA error code
// as an int, and never synchronises.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;       // query heads of a block: the mma's N
constexpr int kChunkTile = 64;  // the split plan's unit, in slots
constexpr int kMaxChunks = 8;   // blocks per cluster: the portable size
constexpr int kStages = 2;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <typename T, int DP>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kSub = kBf16 ? 16 : 8;    // slots per warp and tile
  static constexpr int kTile = kWarps * kSub;     // slots per ring stage
  static constexpr int kVecs = DP * (int)sizeof(T) / 16;  // per padded row
  static constexpr int kRow = DP * (int)sizeof(T) + 16;   // bytes, padded
  static constexpr int kStage = 2 * kTile * kRow;          // K tile, V tile
  // after the loop the ring holds the block's merge: wacc[kWarps][kHeads]
  // [DP], wm, wl, ww [kWarps][kHeads], cw[kMaxChunks][kHeads],
  // lsum[kHeads]
  static constexpr int kMergeFloats = kWarps * kHeads * DP +
                                      3 * kWarps * kHeads +
                                      kMaxChunks * kHeads + kHeads;
  static constexpr int kRingBytes = kStages * kStage > kMergeFloats * 4
                                        ? kStages * kStage
                                        : kMergeFloats * 4;
  // the inbox, written by the cluster: m, l [kMaxChunks][kHeads], and each
  // chunk's slice of acc (chunks x ceil(kHeads DP / chunks) floats)
  static constexpr int kInboxFloats =
      2 * kMaxChunks * kHeads + kHeads * DP + kMaxChunks;
  static constexpr size_t kSmem = (size_t)kRingBytes + 4 * kInboxFloats;
  static_assert(kChunkTile % kTile == 0, "a chunk is whole ring tiles");
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cluster's barrier, split: arrive, then wait (acquire: writes made
// before the other blocks arrived are visible)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// One stage of the ring: rows [s0, s0 + rows) of K and V (slot stride
// `stride` elements), each row's first nv 16-byte vectors; the rest of the
// kTile x kVecs tile is zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* kb,
                                          const T* vb, long long stride,
                                          int s0, int rows, int nv) {
  using C = Cfg<T, DP>;
  constexpr int kPer = C::kTile * C::kVecs;
  constexpr int kElts = 16 / (int)sizeof(T);
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * kPer; i += kThreads) {
    const int which = i / kPer, r = (i % kPer) / C::kVecs, c = i % C::kVecs;
    const bool ok = r < rows && c < nv;
    const T* src = (which ? vb : kb) +
                   (ok ? (long long)(s0 + r) * stride + c * kElts : 0);
    cp_async16(dst + (which * C::kTile + r) * C::kRow + c * 16, src,
               ok ? 16 : 0);
  }
}

template <typename T, int DP>
struct WarpState;

// bf16 on the tensor cores.  Lane (gid = lane / 4, tig = lane % 4) holds
// the logits of slots gid and gid + 8 for heads 2 tig and 2 tig + 1, and
// the accumulator out^T[d][h] for d = 16 mt + gid (+ 8), the same heads.
template <int DP>
struct WarpState<bf16, DP> {
  static constexpr int kK = DP / 16;
  uint32_t qf[kK][2];  // Q^T as the B operand of S = K Q^T
  float acc[kK][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kK; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void load_q(const bf16* q0, int gcount, int D,
                                         float, int lane) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + 2 * tig;
        float lo = 0.f, hi = 0.f;
        if (g < gcount && d < D) {
          lo = __bfloat162float(q0[(long long)g * D + d]);
          hi = __bfloat162float(q0[(long long)g * D + d + 1]);
        }
        qf[kk][half] = pack_bf16(lo, hi);
      }
  }

  // rows r0 .. r0 + 15 of the stage at `st`, the first at slot `slot0`
  __device__ __forceinline__ void tile(const unsigned char* st, int r0,
                                       int slot0, int c1, bool none_live,
                                       float qk_scale, int lane) {
    constexpr int kRow = Cfg<bf16, DP>::kRow;
    const uint32_t sk = smem_addr(st);
    const uint32_t sv = sk + Cfg<bf16, DP>::kTile * kRow;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sk + (r0 + (lane & 15)) * kRow + kk * 32 + (lane >> 4) * 16);
      mma_bf16(s, a, qf[kk][0], qf[kk][1]);
    }
    const int sa = slot0 + (lane >> 2), sb = sa + 8;
    float x[4];
    x[0] = sa < c1 ? (none_live ? kMasked : s[0] * qk_scale) : -INFINITY;
    x[1] = sa < c1 ? (none_live ? kMasked : s[1] * qk_scale) : -INFINITY;
    x[2] = sb < c1 ? (none_live ? kMasked : s[2] * qk_scale) : -INFINITY;
    x[3] = sb < c1 ? (none_live ? kMasked : s[3] * qk_scale) : -INFINITY;
    float mx0 = fmaxf(x[0], x[2]), mx1 = fmaxf(x[1], x[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = exp2f(m[0] - mn0), al1 = exp2f(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    const float p0 = exp2f(x[0] - mn0), p1 = exp2f(x[1] - mn1);
    const float p2 = exp2f(x[2] - mn0), p3 = exp2f(x[3] - mn1);
    l[0] = l[0] * al0 + p0 + p2;
    l[1] = l[1] * al1 + p1 + p3;
    // P^T as the B operand of out^T += V^T P^T, in a high and a low half
    const uint32_t h01 = pack_bf16(p0, p1), h23 = pack_bf16(p2, p3);
    const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
    const uint32_t bh0 = transpose8x8(h01), bh1 = transpose8x8(h23);
    const uint32_t bl0 = transpose8x8(pack_bf16(p0 - f01.x, p1 - f01.y));
    const uint32_t bl1 = transpose8x8(pack_bf16(p2 - f23.x, p3 - f23.y));
#pragma unroll
    for (int mt = 0; mt < kK; ++mt) {
      acc[mt][0] *= al0;
      acc[mt][1] *= al1;
      acc[mt][2] *= al0;
      acc[mt][3] *= al1;
      uint32_t a[4];
      ldsm_x4_trans(a, sv + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kRow +
                           mt * 32 + ((lane >> 3) & 1) * 16);
      mma_bf16(acc[mt], a, bh0, bh1);
      mma_bf16(acc[mt], a, bl0, bl1);
    }
  }

  // this warp's partial: wm, wl [kHeads]; wacc [kHeads][DP]
  __device__ __forceinline__ void store(float* wm, float* wl, float* wacc,
                                        int lane) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
    }
    const int g = lane >> 2, h = 2 * (lane & 3);
    if (g == 0) {
      wm[h] = m[0];
      wm[h + 1] = m[1];
      wl[h] = l[0];
      wl[h + 1] = l[1];
    }
#pragma unroll
    for (int mt = 0; mt < kK; ++mt) {
      const int d = mt * 16 + g;
      wacc[h * DP + d] = acc[mt][0];
      wacc[(h + 1) * DP + d] = acc[mt][1];
      wacc[h * DP + d + 8] = acc[mt][2];
      wacc[(h + 1) * DP + d + 8] = acc[mt][3];
    }
  }
};

// f32 on the CUDA cores: one slot at a time for all 8 heads; lane owns the
// 4-float vectors lane + 32 v of a row (v < DP / 128).  m and l are the
// same in every lane.
template <int DP>
struct WarpState<float, DP> {
  static constexpr int kV = DP / 128;
  float4 qv[kHeads][kV];  // q * log2(e) / sqrt(D)
  float4 acc[kHeads][kV];
  float m[kHeads], l[kHeads];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[g][v] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[g] = kMasked;
      l[g] = 0.f;
    }
  }

  __device__ __forceinline__ void load_q(const float* q0, int gcount, int D,
                                         float qk_scale, int lane) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int d = 4 * (lane + 32 * v);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < gcount && d < D) {
          const float* p = q0 + (long long)g * D + d;
          x = make_float4(p[0] * qk_scale, p[1] * qk_scale, p[2] * qk_scale,
                          p[3] * qk_scale);
        }
        qv[g][v] = x;
      }
  }

  __device__ __forceinline__ void tile(const unsigned char* st, int r0,
                                       int slot0, int c1, bool none_live,
                                       float, int lane) {
    constexpr int kRow = Cfg<float, DP>::kRow;
    constexpr int kSub = Cfg<float, DP>::kSub;
    const unsigned char* vt = st + Cfg<float, DP>::kTile * kRow;
#pragma unroll 1
    for (int i = 0; i < kSub && slot0 + i < c1; ++i) {
      const float4* kr =
          reinterpret_cast<const float4*>(st + (r0 + i) * kRow) + lane;
      const float4* vr =
          reinterpret_cast<const float4*>(vt + (r0 + i) * kRow) + lane;
      float4 kx[kV], vx[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        kx[v] = kr[32 * v];
        vx[v] = vr[32 * v];
      }
      float dot[kHeads];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kV; ++v)
          s += qv[g][v].x * kx[v].x + qv[g][v].y * kx[v].y +
               qv[g][v].z * kx[v].z + qv[g][v].w * kx[v].w;
        dot[g] = s;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kHeads; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float x = none_live ? kMasked : dot[g];
        const float mn = fmaxf(m[g], x);
        const float al = exp2f(m[g] - mn), p = exp2f(x - mn);
        m[g] = mn;
        l[g] = l[g] * al + p;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          acc[g][v].x = acc[g][v].x * al + p * vx[v].x;
          acc[g][v].y = acc[g][v].y * al + p * vx[v].y;
          acc[g][v].z = acc[g][v].z * al + p * vx[v].z;
          acc[g][v].w = acc[g][v].w * al + p * vx[v].w;
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* wm, float* wl, float* wacc,
                                        int lane) {
    if (lane < kHeads) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g)
        if (g == lane) {
          wm[g] = m[g];
          wl[g] = l[g];
        }
    }
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
#pragma unroll
      for (int v = 0; v < kV; ++v)
        reinterpret_cast<float4*>(wacc + g * DP)[lane + 32 * v] = acc[g][v];
  }
};

// grid (chunks, KV * ceil(G / 8), B), cluster (chunks, 1, 1), kThreads
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ length,
                  T* __restrict__ out, int S, int KV, int G, int D,
                  int chunk_len, float qk_scale) {
  using C = Cfg<T, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  // this block runs: once every block of the cluster has said so, their
  // inboxes may be written
  cluster_arrive_relaxed();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head_tiles = (G + kHeads - 1) / kHeads;
  const int n = blockIdx.y / head_tiles;
  const int h0 = (blockIdx.y - n * head_tiles) * kHeads;
  const int b = blockIdx.z;
  const int gcount = min(kHeads, G - h0);
  const long long H = (long long)KV * G;
  const long long q_off = ((long long)b * H + (long long)n * G + h0) * D;

  const int len = length[b];
  const bool none_live = len <= 0;  // every slot masked: uniform over S
  const int end = none_live ? S : min(len, S);
  const int c0 = blockIdx.x * chunk_len;
  const int c1 = min(c0 + chunk_len, end);
  const int ntiles = c0 < c1 ? (c1 - c0 + C::kTile - 1) / C::kTile : 0;
  const long long stride = (long long)KV * D;  // elements from slot to slot
  const T* kb = k + ((long long)b * S * KV + n) * D;
  const T* vb = v + ((long long)b * S * KV + n) * D;
  const int nv = D * (int)sizeof(T) / 16;
  const uint32_t ring = smem_addr(smem);

  // every stage of the ring in flight first, then q (its loads would
  // otherwise hold back the copies' issue)
#pragma unroll
  for (int t = 0; t < kStages; ++t) {
    if (t < ntiles)
      load_tile<T, DP>(ring + t * C::kStage, kb, vb, stride,
                       c0 + t * C::kTile, min(C::kTile, c1 - c0 - t * C::kTile),
                       nv);
    cp_async_commit();
  }
  WarpState<T, DP> ws;
  ws.init();
  if (ntiles > 0) ws.load_q(q + q_off, gcount, D, qk_scale, lane);

  const int r0 = warp * C::kSub;
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile t landed, for every thread's copies
    const int slot0 = c0 + t * C::kTile + r0;
    if (slot0 < c1)
      ws.tile(smem + (t % kStages) * C::kStage, r0, slot0, c1, none_live,
              qk_scale, lane);
    const int tn = t + kStages;
    if (tn < ntiles) {
      __syncthreads();  // every warp is done with this stage
      load_tile<T, DP>(ring + (t % kStages) * C::kStage, kb, vb, stride,
                       c0 + tn * C::kTile,
                       min(C::kTile, c1 - c0 - tn * C::kTile), nv);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the ring now holds the block's merge; the inbox after it receives the
  // cluster's partials of the output slice this block writes
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps][kHeads][DP]
  float* wm = wacc + kWarps * kHeads * DP;        // [kWarps][kHeads]
  float* wl = wm + kWarps * kHeads;
  float* ww = wl + kWarps * kHeads;
  float* cw = ww + kWarps * kHeads;               // [kMaxChunks][kHeads]
  float* lsum = cw + kMaxChunks * kHeads;         // [kHeads]
  float* im = reinterpret_cast<float*>(smem + C::kRingBytes);  // [chunk][h]
  float* il = im + kMaxChunks * kHeads;
  float* iacc = il + kMaxChunks * kHeads;         // [chunk][per]
  ws.store(wm + warp * kHeads, wl + warp * kHeads,
           wacc + warp * kHeads * DP, lane);
  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (kHeads * DP + nblocks - 1) / nblocks;  // slice per block
  __syncthreads();
  cluster_wait();
  if (tid < kHeads) {  // the block's (m, l) of head tid, to every block
    float mx = kMasked;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kHeads + tid]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(wm[w * kHeads + tid] - mx);
      ww[w * kHeads + tid] = e;
      sum += wl[w * kHeads + tid] * e;
    }
    for (int j = 0; j < nblocks; ++j) {
      cluster.map_shared_rank(im, j)[rank * kHeads + tid] = mx;
      cluster.map_shared_rank(il, j)[rank * kHeads + tid] = sum;
    }
  }
  __syncthreads();
  for (int i = tid; i < kHeads * DP; i += kThreads) {  // acc, to its owner
    const int g = i / DP, owner = i / per;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += wacc[w * kHeads * DP + i] * ww[w * kHeads + g];
    cluster.map_shared_rank(iacc, owner)[rank * per + i - owner * per] = a;
  }
  cluster_arrive();
  cluster_wait();  // every partial is in its owner's inbox

  if (tid < kHeads) {
    float mx = kMasked;
    for (int j = 0; j < nblocks; ++j) mx = fmaxf(mx, im[j * kHeads + tid]);
    float sum = 0.f;
    for (int j = 0; j < nblocks; ++j) {
      const float e = exp2f(im[j * kHeads + tid] - mx);
      cw[j * kHeads + tid] = e;
      sum += il[j * kHeads + tid] * e;
    }
    lsum[tid] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const int lo = rank * per, hi = min(lo + per, kHeads * DP);
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int g = i / DP, d = i - g * DP;
    if (g >= gcount || d >= D) continue;
    float a = 0.f;
    for (int j = 0; j < nblocks; ++j)
      a += iacc[j * per + i - lo] * cw[j * kHeads + g];
    out[q_off + (long long)g * D + d] = from_f32<T>(a / lsum[g]);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, int B, int S, int H, int KV, int D, int chunk_len,
           int chunks, cudaStream_t s) {
  using C = Cfg<T, DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gqa_decode_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int G = H / KV;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)chunks,
                     (unsigned)(KV * ((G + kHeads - 1) / kHeads)),
                     (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)chunks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gqa_decode_kernel<T, DP>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<T*>(out), S, KV, G, D,
      chunk_len, kLog2e / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, H, D]; k, v: [B, S, KV, D], all contiguous, of one type:
// dtype 0 = float32, 1 = bfloat16; k and v 16-byte aligned.  length:
// int32[B].  D a multiple of 8 in [8, 256].  The split plan: `chunks`
// chunks of `chunk_len` slots (a multiple of 64) cover [0, S), none empty.
extern "C" int gqa_decode(const void* q, const void* k, const void* v,
                          const void* length, void* out, int B, int S, int H,
                          int KV, int D, int dtype, int chunk_len, int chunks,
                          void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || D % 8 != 0 || D < 8 || D > 256 || S <= 0 ||
      chunks < 1 || chunks > kMaxChunks || chunk_len <= 0 ||
      chunk_len % kChunkTile != 0 || (long long)chunks * chunk_len < S ||
      (long long)(chunks - 1) * chunk_len >= S ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return D <= 128
               ? launch<float, 128>(q, k, v, length, out, B, S, H, KV, D,
                                    chunk_len, chunks, s)
               : launch<float, 256>(q, k, v, length, out, B, S, H, KV, D,
                                    chunk_len, chunks, s);
  if (dtype == 1)
    return D <= 64    ? launch<bf16, 64>(q, k, v, length, out, B, S, H, KV,
                                         D, chunk_len, chunks, s)
           : D <= 128 ? launch<bf16, 128>(q, k, v, length, out, B, S, H, KV,
                                          D, chunk_len, chunks, s)
                      : launch<bf16, 256>(q, k, v, length, out, B, S, H, KV,
                                          D, chunk_len, chunks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
