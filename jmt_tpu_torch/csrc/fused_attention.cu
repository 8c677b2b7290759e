// Fused attention core: out = softmax(q k^T) v over BH independent problems.
// q (BH, Lq, D) arrives pre-scaled by D**-0.5; k, v (BH, Lk, D); f32 or bf16.
//
// Replaces the TPU kernel jmt_tpu/ops/pallas/fused_attention.py
// (fused_attention, body _kernel). Numerics follow it and the XLA path
// _core_xla: scores and softmax in f32 (with max subtraction), P cast to v's
// dtype before P.V, P.V accumulated in f32 and cast to v's dtype.
//
// The TPU gate (jmt_tpu/ops/attention.py, _pallas_ok) admitted only
// head_dim <= 256: a VMEM/tiling limit of the TPU's Mosaic lowering, not a
// property of the function. With one head at E = 512 (the flagship), every
// attention fell back to XLA there. This kernel keeps only the scores in
// shared memory (Lq x Lk f32, at most 64 KB) and streams q, k, v from
// L2/L1, so head_dim = 512 costs no shared memory and the port's gate is
// Lq, Lk <= 128, D <= 512.
//
// What bounds it on an H100: the fusion stack's problems are tiny (L = 2,
// 6, 16 tokens, D = 512), so bytes bound it (q, k, v read once, out written
// once, about 3 flops per byte in bf16), and at these sizes in practice the
// launch and the few serial steps inside a block. The design answers with
// one launch for all BH problems, one block per problem, and no round trip
// of scores or probabilities through device memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;
constexpr int kMaxD = 512;
constexpr int kRows = 16;  // query rows accumulated in registers at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// One block per problem. Dynamic shared memory: Lq * Lk f32 scores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                 int d) {
  extern __shared__ float s[];
  const size_t b = blockIdx.x;
  q += b * lq * d;
  k += b * lk * d;
  v += b * lk * d;
  o += b * lq * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // scores: one warp per (i, j) dot product, lanes stride over D
  for (int t = warp; t < lq * lk; t += kWarps) {
    const int i = t / lk, j = t - i * lk;
    const T* qi = q + (size_t)i * d;
    const T* kj = k + (size_t)j * d;
    float acc = 0.0f;
    for (int e = lane; e < d; e += 32) acc = fmaf(to_f(qi[e]), to_f(kj[e]), acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s[t] = acc;
  }
  __syncthreads();

  // softmax: one warp per row, f32, max-subtracted; P rounded to T
  for (int i = warp; i < lq; i += kWarps) {
    float* row = s + i * lk;
    float m = -CUDART_INF_F;
    for (int j = lane; j < lk; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < lk; j += 32) row[j] = to_f(from_f<T>(row[j] / sum));
  }
  __syncthreads();

  // P.V: each thread owns output columns; kRows query rows per sweep of v
  for (int e = threadIdx.x; e < d; e += kThreads) {
    for (int i0 = 0; i0 < lq; i0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int j = 0; j < lk; ++j) {
        const float vj = to_f(v[(size_t)j * d + e]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (i0 + r < lq) acc[r] = fmaf(s[(i0 + r) * lk + j], vj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < lq) o[(size_t)(i0 + r) * d + e] = from_f<T>(acc[r]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int lq, int lk, int d, cudaStream_t s) {
  const size_t smem = sizeof(float) * lq * lk;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * kMaxL * kMaxL));
    if (e != cudaSuccess) return (int)e;
  }
  attention_kernel<T><<<bh, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lq, lk, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int jmt_attention_max_l() { return kMaxL; }
int jmt_attention_max_d() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous.
int jmt_fused_attention(const void* q, const void* k, const void* v, void* o,
                        int bh, int lq, int lk, int d, int dtype,
                        void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || lq > kMaxL || lk > kMaxL ||
      d > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(q, k, v, o, bh, lq, lk, d, s)
                    : launch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, s);
}

}  // extern "C"
