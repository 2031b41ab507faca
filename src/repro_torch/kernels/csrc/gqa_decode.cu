// GQA decode attention: one query token per batch row against a KV cache
// prefix.  out[b, h] = softmax_s(q[b, h] . k[b, s, h / G] / sqrt(D)) v[b, s,
// h / G] over the slots s < length[b], with G = H / KV query heads sharing
// each KV head.
//
// Replaces the Pallas kernel `gqa_decode_pallas` / `_decode_kernel` of
// src/repro/kernels/gqa_decode/kernel.py.  The TPU version walks the cache
// in sequence tiles along a sequential grid axis and carries the online
// softmax state (m, l, acc) in VMEM scratch from one grid step to the next.
// GPU blocks do not run in order, so here the sequence loop lives inside
// the block: one block per (batch row, KV head) walks the cache tile by
// tile with (m, l, acc) in shared memory.  The G query heads of the KV head
// share each K/V tile, which is read from device memory exactly once.
//
// Bound on an H100: memory.  The function must read the K and V prefix it
// attends over (2 * length * D elements per (b, kv-head)), q, and write out;
// the G * length * D multiply-adds are far below the card's rate.  The
// design serves that bound only in part, and says so:
//   * the loop stops at `length` (masked slots add nothing once a live slot
//     has been seen), so the bytes read follow the data, not the cache size;
//   * loads are coalesced along D (neighbouring threads, neighbouring
//     elements) and converted to f32 once, into shared memory;
//   * but B * KV blocks (64 at the serving shape) do not fill 132 SMs, and
//     each block loads a tile, waits, computes: there is no split over the
//     sequence and no copy in flight during compute.  Split-K and a
//     cp.async/TMA pipeline are the later work that closes the gap.
// Accumulation is f32 throughout; masked logits are -1e30 and the result is
// acc / max(l, 1e-30), as in the TPU kernel.  With length <= 0 every slot is
// masked and the softmax is uniform over the S slots, as in the reference.
//
// C interface, loaded with ctypes: every launcher returns a CUDA error code
// as an int, and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory, in floats: qs[G][D], acc[G][D], ks[ST][D + 1] (padded so
// that neighbouring slots fall in distinct banks), vs[ST][D], ps[G][ST],
// then m[G], l[G], alpha[G].
size_t smem_bytes(int g, int d, int st) {
  return sizeof(float) * ((size_t)2 * g * d + (size_t)st * (d + 1) +
                          (size_t)st * d + (size_t)g * st + 3 * (size_t)g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ length,
                  T* __restrict__ out, int S, int KV, int G, int D, int ST,
                  float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;          // KV head
  const int b = blockIdx.y;          // batch row
  const int H = KV * G;
  const int DP = D + 1;
  float* qs = smem;
  float* acc = qs + G * D;
  float* ks = acc + G * D;
  float* vs = ks + ST * DP;
  float* ps = vs + ST * D;
  float* ms = ps + G * ST;
  float* ls = ms + G;
  float* as = ls + G;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  // the G query heads of KV head n are rows n*G .. n*G+G-1 of q[b]
  const T* qb = q + ((long long)b * H + (long long)n * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    qs[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const int len = length[b];
  const int end = len > 0 ? min(len, S) : S;
  __syncthreads();

  for (int s0 = 0; s0 < end; s0 += ST) {
    const int st = min(ST, end - s0);
    for (int i = tid; i < st * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const long long off = (((long long)b * S + s0 + j) * KV + n) * D + d;
      ks[j * DP + d] = to_f32(k[off]);
      vs[j * D + d] = to_f32(v[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * st; i += blockDim.x) {
      const int g = i / st, j = i - g * st;
      const float* qg = qs + g * D;
      const float* kj = ks + j * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kj[d], dot);
      ps[g * ST + j] = (s0 + j < len) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float* pg = ps + g * ST;
      float mx = kNegInf;
      for (int j = lane; j < st; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < st; j += 32) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pg = ps + g * ST;
      float a = acc[i] * as[g];
      for (int j = 0; j < st; ++j) a = fmaf(pg[j], vs[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

  T* ob = out + ((long long)b * H + (long long)n * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x)
    ob[i] = from_f32<T>(acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* out, int B, int S, int H, int KV, int D, cudaStream_t s) {
  const int G = H / KV;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  int st = 64;
  while (st > 8 && smem_bytes(G, D, st) > (size_t)optin) st >>= 1;
  const size_t smem = smem_bytes(G, D, st);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(gqa_decode_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)KV, (unsigned)B);
  gqa_decode_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<T*>(out), S, KV, G, D, st, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [B, H, D]; k, v: [B, S, KV, D], all contiguous, of one type:
// dtype 0 = float32, 1 = bfloat16.  length: int32[B].
extern "C" int gqa_decode(const void* q, const void* k, const void* v,
                          const void* length, void* out, int B, int S, int H,
                          int KV, int D, int dtype, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV != 0 || D <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, length, out, B, S, H, KV, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, out, B, S, H, KV, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
