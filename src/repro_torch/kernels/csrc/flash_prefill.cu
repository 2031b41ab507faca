// Causal, optionally sliding-window, GQA flash attention for prefill.
// out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j,
// h / G] over the keys j <= i (and j > i - window when window > 0), with
// G = H / KV query heads sharing each KV head.
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
// memory: a 64 x 32 tile of them lives in shared memory.  The TPU wrapper's
// S % 128 gate and its transpose to (B, KV, S, G, D) are gone: the kernel
// reads [B, S, H, D] through strides and masks the ragged edge (rows and
// keys >= S are zero-filled and masked).
//
// Bound on an H100 at the serving shape (B 8, S 512, H 64, KV 8, D 128,
// bf16): memory, barely (151 MB of q, k, v and out against 34 GFLOP of the
// causal half on the tensor cores).  This first version does not approach
// it: both products run on the CUDA cores in f32 (so the f32 path keeps f32
// accuracy), from shared memory, with 4 x 2 and 4 x 8 register tiles per
// thread; shared-memory bandwidth then sets the pace.  Tensor cores
// (mma.sync or wgmma on bf16 tiles), K/V shared by the G heads of a group
// and a TMA pipeline are the later work.
// Accumulation is f32 throughout; masked logits are -1e30 and the result is
// acc / max(l, 1e-30), as in the TPU kernel.
//
// C interface, loaded with ctypes: every launcher returns a CUDA error code
// as an int, and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 32;         // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {            // element strides of one [B, S, heads, D] tensor
  long long b, s, h;
};

// Shared memory, in floats: qs[BQ][D + 1], ks[BK][D + 1], vs[BK][D],
// ss[BQ][BK + 1], then m[BQ], l[BQ], alpha[BQ].  The odd row pitches put
// the rows that one warp reads together in distinct banks.
size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                          (size_t)kBK * d + (size_t)kBQ * (kBK + 1) +
                          3 * (size_t)kBQ);
}

// NJ: head-dim columns each thread accumulates (D <= 16 * NJ).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     Strides qs_, Strides ks_, Strides vs_, Strides os_, int S,
                     int G, int D, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qsm = smem;
  float* ksm = qsm + kBQ * DP;
  float* vsm = ksm + kBK * DP;
  float* ssm = vsm + kBK * D;
  float* ms = ssm + kBQ * (kBK + 1);
  float* ls = ms + kBQ;
  float* as = ls + kBQ;

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
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / kBK * kBK; k0 <= q_last; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < S;
      ksm[j * DP + d] = in ? to_f32(kb[(k0 + j) * ks_.s + d]) : 0.f;
      vsm[j * D + d] = in ? to_f32(vb[(k0 + j) * vs_.s + d]) : 0.f;
    }
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
        bool live = kp < S && kp <= qp;
        if (window > 0) live = live && kp > qp - window;
        ssm[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] =
            live ? sacc[i][j] * scale : kNegInf;
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

template <typename T, int NJ>
int launch(const T* q, const T* k, const T* v, T* out, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int S, int H, int KV,
           int D, int window, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_prefill_kernel<T, NJ><<<grid, kThreads, smem, s>>>(
      q, k, v, out, sq, sk, sv, so, S, H / KV, D, window,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             const long long* strides, int B, int S, int H, int KV, int D,
             int window, cudaStream_t s) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D <= 64)
    return launch<T, 4>(qt, kt, vt, ot, sq, sk, sv, so, B, S, H, KV, D,
                        window, s);
  if (D <= 128)
    return launch<T, 8>(qt, kt, vt, ot, sq, sk, sv, so, B, S, H, KV, D,
                        window, s);
  return launch<T, 16>(qt, kt, vt, ot, sq, sk, sv, so, B, S, H, KV, D, window,
                       s);
}

}  // namespace

// q, out: [B, S, H, D]; k, v: [B, S, KV, D], each with a unit stride along
// D and the element strides (batch, sequence, head) given in `strides`
// (q, k, v, out: 12 values).  dtype 0 = float32, 1 = bfloat16; D a multiple
// of 8 in [8, 256]; window 0 = full causal.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int B,
                             int S, int H, int KV, int D, int window,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || D < 8 || D > 256 || D % 8 != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, strides, B, S, H, KV, D, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, strides, B, S, H, KV, D,
                                   window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
