// A 3x3x3 stride-1 SAME max pool padded with -inf, then a 1x1 product:
// out = maxpool(x) . k with f32 accumulation, cast to x's dtype; no bias,
// no ReLU. x (N, T, H, W, C) in channels-last rows, any sign; f32 or bf16.
//
// Replaces the TPU kernel tools/pallas_pool1x1_experiment.py (pool3_1x1,
// :65, pallas_call :76; body _kernel, :45): the inception b3 branch on its
// own, an experiment that is not wired into the model.
//
// What bounds it on an H100: bytes. At (128, 8, 14, 14, 512) -> 64 in bf16
// it moves about 231 MB (x in, out) against 13 GFLOP, 0.07 ms at 3.35 TB/s
// against 0.013 ms at 989 TFLOP/s.
//
// The design: the same implicit GEMM as the inception kernel's b3 problem
// (implicit_gemm.cuh, variant kNegInf). The pool is gathered while a tile
// of A is loaded (27 loads of 16 bytes a vector, a position past the map
// skipped: -inf padding, as the TPU kernel padded with the dtype's lowest
// value), so the pooled x never reaches device memory; the epilogue writes
// the cast sum. One launch. The TPU kernel's in-kernel H-tile loop answered
// a 16 MB VMEM (its 28 x 28 x 256 and C = 832 shapes did not compile) and
// is not carried over: a block here holds one 128 x 128 output tile.
#include "implicit_gemm.cuh"

namespace {

template <typename T>
int run(const void* x, const void* k, void* out, int n, int t, int h, int w,
        int c, int co, cudaStream_t stream) {
  using C = Tile<T>;
  Launch L = {};
  L.nprob = 1;
  L.rows = n * t * h * w;
  L.t = t;
  L.h = h;
  L.w = w;
  L.p[0] = problem(x, k, nullptr, kPoolGemm, c, c, 0, co,
                   out_seg(out, nullptr, 0, co, co, 0, 0));
  dim3 grid((L.rows + C::BM - 1) / C::BM, (co + C::BN - 1) / C::BN, 1);
  inception_gemm<T, kNegInf><<<grid, kThreads, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, T, H, W, C) rows, k (C, co), out (N, T, H, W, co) rows, all in the
// working dtype and contiguous; C and co multiples of 8. dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int jmt_pool3_1x1(const void* x, const void* k, void* out, int n,
                             int t, int h, int w, int c, int co, int dtype,
                             void* stream) {
  const bool ok = n > 0 && t > 0 && h > 0 && w > 0 && c > 0 && c % 8 == 0 &&
                  co > 0 && co % 8 == 0 && (dtype == 0 || dtype == 1) &&
                  (long long)n * t * h * w < INT_MAX;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 0 ? run<float>(x, k, out, n, t, h, w, c, co, st)
                    : run<bf16>(x, k, out, n, t, h, w, c, co, st);
}
