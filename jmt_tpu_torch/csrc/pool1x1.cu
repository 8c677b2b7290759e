// A 3x3x3 stride-1 SAME max pool padded with -inf, then a 1x1 product:
// out = maxpool(x) . k with f32 accumulation, cast to x's dtype; no bias,
// no ReLU. x (N, T, H, W, C) in channels-last rows, any sign; f32 or bf16.
//
// Replaces the TPU kernel tools/pallas_pool1x1_experiment.py (pool3_1x1,
// :65, pallas_call :76; body _kernel, :45): the inception b3 branch on its
// own, an experiment that is not wired into the model.
//
// What bounds it on an H100: bytes. At (128, 8, 14, 14, 512) -> 64 in bf16
// it moves about 231 MB (x in, out and k) against 13 GFLOP, 0.069 ms at
// 3.35 TB/s against 0.013 ms at 989 TFLOP/s; every shape of the TPU tool is
// bounded by bytes, the products 2-10x under them.
//
// The design, bf16 (pool1x1_sm90.cuh): each input byte comes from HBM
// about once. A persistent block stages the halo of a strip of output rows
// by TMA, pools it separably in shared memory (T, then W by warp shuffles,
// then H in registers) straight into the wgmma A tile, runs wgmma with N
// the column tile (Co itself for the tool's shapes) against k by TMA, and
// writes 16-byte vectors; see that header. It replaces a first design that
// gathered the 27 neighbours of every row from global memory for every
// 16-byte vector (28 loads each) and stored one element at a time.
//
// f32 stays on the parity path, implicit_gemm.cuh's kNegInf variant: the
// pool gathered while a tile of A is loaded (a position past the map
// skipped: -inf padding, as the TPU kernel padded with the dtype's lowest
// value), the product in full fp32 FMA (no TF32) to hold 1e-5 of the plain
// version, which wgmma, having no fp32 mode, cannot. One launch either way.
// The TPU kernel's in-kernel H-tile loop answered a 16 MB VMEM (its 28 x 28
// x 256 and C = 832 shapes did not compile); here a strip of H rows is what
// shared memory holds.
#include "pool1x1_sm90.cuh"

namespace {

// f32: the implicit GEMM of implicit_gemm.cuh, 128 x 128 tiles.
int run_f32(const void* x, const void* k, void* out, int n, int t, int h,
            int w, int c, int co, cudaStream_t stream) {
  using C = Tile<float>;
  Launch L = {};
  L.nprob = 1;
  L.rows = n * t * h * w;
  L.t = t;
  L.h = h;
  L.w = w;
  L.p[0] = problem(x, k, nullptr, kPoolGemm, c, c, 0, co,
                   out_seg(out, nullptr, 0, co, co, 0, 0));
  dim3 grid((L.rows + C::BM - 1) / C::BM, (co + C::BN - 1) / C::BN, 1);
  inception_gemm<float, kNegInf><<<grid, kThreads, 0, stream>>>(L);
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
  return dtype == 0 ? run_f32(x, k, out, n, t, h, w, c, co, st)
                    : k4::launch(x, k, out, n, t, h, w, c, co, st);
}
