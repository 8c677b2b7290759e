// One whole I3D inception module with frozen BN folded into kernels and
// biases, on x (N, T, H, W, C) >= 0 in channels-last rows; f32 or bf16.
//
// Replaces the TPU kernel jmt_tpu/ops/inception_pallas.py
// (inception_module_fused, :364; body _kernel, :150). What it computes, with
// the same cast points:
//   b0 | b1a | b2a  one merged 1x1 GEMM (K = C, N = o0+o1+o3), + f32 bias,
//                   the result rounded to the working dtype;
//   b0              relu of its columns -> output channels [0, o0);
//   b1b, b2b        SAME 3x3x3 convs (K = 27*o1, 27*o3) over relu(a1),
//                   relu(a2), f32 accumulation, + bias, relu, cast on emit;
//                   a pad position contributes 0 (not relu(bias));
//   b3              3x3x3 stride-1 max pool of x with zero padding (equal to
//                   -inf padding because x >= 0), then a 1x1 GEMM (K = C,
//                   N = o5), + bias, relu;
//   avg_tail        (Mixed_5c) per branch the f32 sum over (H, W) of each t,
//                   then (s[t] + s[t+1]) / (2 H W): output (N, T-1, co);
//   pool_in         (Mixed_3b, 4b, 5b absorbing MaxPool3d_3a, 4a, 5a) x is
//                   the pre-pool map, and the module runs on its TF-SAME
//                   (kt, k, k) stride-(1, 2, 2) max pool, zero padded.
//
// What bounds it on an H100: operations. A bucket-8 forward (128 clips, T 8)
// runs the nine modules at about 4.8 TFLOP against well under 1 GB of
// input and output each, so the tensor cores set the least time (about
// 4.9 ms at 989 TFLOP/s bf16), not the 3.35 TB/s of HBM.
//
// The design answers with implicit GEMMs that keep the two im2col tensors
// out of device memory (on the f32 path the pooled x too): the 3x3x3 taps
// (and there the pool) are gathered while a tile of A is written into
// shared memory, with zero fill giving the SAME padding. Two GEMM
// launches: the merged 1x1 GEMM (writing b0 and the relu'd branch-a
// activations to a scratch tensor), then b1b, b2b and b3 as three problems
// of one grid; avg_tail adds per-(n, t) sums by atomicAdd in the
// epilogues and a small last pass. The TPU's halo tiles, merged-row layout
// and H-tile table answered a 16 MB VMEM and XLA fusion seams and are not
// carried over.
//
// The launches dispatch on dtype:
// - bf16, the served path: the Hopper pipeline of igemm_sm90.cuh (TMA for
//   the weights, cp.async or register gathers for A into a ring of 3 to 8
//   stages, warp-specialised wgmma, persistent blocks, 16-byte stores and
//   per-warp avg_tail sums). One block covers up to 512 columns, so the
//   merged 1x1 GEMM gathers each row (and pool_in's window) once at every
//   module but Mixed_5c (N = 624: two column tiles); the second launch
//   lists b1b's long-K tiles first, then b2b's and b3's. b3's 3x3x3 pool
//   is a pass of its own (pool3x3x3) into a scratch of N*T*H*W*C, and b3
//   a 1x1 GEMM over it: three launches, four with avg_tail.
// - f32, the parity path (full fp32, no TF32, as the tolerance 5e-5
//   needs): implicit_gemm.cuh's FMA tiles of 128 x 128, double-buffered
//   through registers, one grid sized by the widest problem.
//
// pool_in: the first launch gathers each A row as the max over its
// pre-pool window (kt * k * k loads of 16 bytes), so the pooled map needs
// no launch of its own. b3 then needs the 3x3x3 pool of the POOLED map.
// Gathering that composed window from the pre-pool x would cost up to
// 5 x 7 x 7 loads a vector (Mixed_4b) and must not let a pad position of
// the pooled map pull in the real pre-pool rows beside it; instead the
// column-tile-0 blocks of the first launch also write the pooled rows
// (N*T*H*W*C in the working dtype, a quarter of the pre-pool bytes) to a
// scratch tensor, and b3 reads it as it reads x without pool_in. The
// cost: that write and its read back (on the f32 path also the pre-pool
// window gathered again by each of the first launch's column tiles).
#include "igemm_sm90.cuh"

namespace {

// avg_tail's last pass: out[n, t, c] = (s[n, t, c] + s[n, t+1, c]) * scale.
template <typename T>
__global__ void avg_tail_finish(const float* __restrict__ sums,
                                T* __restrict__ out, int n, int t, int co,
                                float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * (t - 1) * co) return;
  const int c = (int)(i % co);
  const size_t r = i / co;
  const size_t tt = r % (t - 1), nn = r / (t - 1);
  const float* s = sums + (nn * t + tt) * co + c;
  out[i] = from_f<T>((s[0] + s[co]) * scale);
}

// b3's pool on the bf16 path, one pass ahead of the GEMMs: dst row r,
// channels [8 v, 8 v + 8), is the 3x3x3 stride-1 max of src around r, with
// zero padding (equal to -inf padding: src >= 0). One thread per 16-byte
// vector, so that many warps hide the 27 loads' latency, which the GEMM's
// four producer warps could not (measured).
__global__ void pool3x3x3(const bf16* __restrict__ src, bf16* __restrict__ dst,
                          int rows, int t, int h, int w, int c) {
  const int nv = c / 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * nv) return;
  const int row = (int)(i / nv), k = (int)(i - (size_t)row * nv) * 8;
  const int ww = row % w, hh = (row / w) % h, tt = (row / (h * w)) % t;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  for (int dt = -1; dt <= 1; ++dt) {
    if (tt + dt < 0 || tt + dt >= t) continue;
    for (int dh = -1; dh <= 1; ++dh) {
      if (hh + dh < 0 || hh + dh >= h) continue;
#pragma unroll
      for (int dw = -1; dw <= 1; ++dw)
        if (ww + dw >= 0 && ww + dw < w)
          x = vmax<bf16>(x, ldg16(src + (size_t)(row + (dt * h + dh) * w + dw) *
                                            c + k));
    }
  }
  *reinterpret_cast<uint4*>(dst + (size_t)row * c + k) = x;
}

template <typename T>
int run(const void* x, void* out, void* scratch, void* pooled, float* sums,
        const void* k1, const float* b1, const void* kb1, const float* bb1,
        const void* kb2, const float* bb2, const void* k3, const float* b3,
        int n, int t, int h, int w, int c, const int* o, int pool_kt,
        int pool_k, cudaStream_t stream) {
  using C = Tile<T>;
  const int o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3], o4 = o[4], o5 = o[5];
  const int co = o0 + o2 + o4 + o5, sa = o1 + o3;
  Launch L = {};
  L.rows = n * t * h * w;
  L.t = t;
  L.h = h;
  L.w = w;
  L.pool_kt = pool_kt;
  L.pool_k = pool_k;

  // 1) merged b0 | b1a | b2a GEMM: b0 to the output, relu(a1) | relu(a2)
  //    to the scratch rows; with pool_in its rows are pooled from the
  //    pre-pool x and also written to the pooled rows
  L.nprob = 1;
  L.p[0] = problem(x, k1, b1, kGemm1x1, c, c, 0, o0 + o1 + o3,
                   out_seg(out, sums, 0, o0, co, 0, 1));
  L.p[0].nseg = 3;
  L.p[0].seg[1] = out_seg(scratch, nullptr, o0, o0 + o1, sa, 0, 1);
  L.p[0].seg[2] = out_seg(scratch, nullptr, o0 + o1, o0 + o1 + o3, sa, o1, 1);
  L.p[0].pool_dst = pooled;
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    e = (cudaError_t)sm90::launch(L, stream);
  } else {
    dim3 grid1((L.rows + C::BM - 1) / C::BM,
               (o0 + o1 + o3 + C::BN - 1) / C::BN, 1);
    if (pool_k)
      inception_gemm<T, kPoolIn><<<grid1, kThreads, 0, stream>>>(L);
    else
      inception_gemm<T, kPlain><<<grid1, kThreads, 0, stream>>>(L);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;

  // 2) b1b, b2b (3x3x3 over the scratch) and b3 (pool + 1x1 over x, or
  //    over the pooled rows with pool_in); in bf16 b3's pool is a pass of
  //    its own into the pooled buffer (its second half with pool_in), and
  //    b3 a 1x1 GEMM over it
  L.pool_kt = L.pool_k = 0;  // pool_in is the first launch's alone
  const void* b3_src = pool_k ? pooled : x;
  int b3_mode = kPoolGemm;
  if constexpr (sizeof(T) == 2) {
    bf16* pool3 =
        static_cast<bf16*>(pooled) + (pool_k ? (size_t)L.rows * c : 0);
    const size_t vecs = (size_t)L.rows * (c / 8);
    pool3x3x3<<<(unsigned)((vecs + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(b3_src), pool3, L.rows, t, h, w, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    b3_src = pool3;
    b3_mode = kGemm1x1;
  }
  L.nprob = 3;
  L.p[0] = problem(scratch, kb1, bb1, kConv3x3x3, o1, sa, 0, o2,
                   out_seg(out, sums, 0, o2, co, o0, 0));
  L.p[1] = problem(scratch, kb2, bb2, kConv3x3x3, o3, sa, o1, o4,
                   out_seg(out, sums, 0, o4, co, o0 + o2, 0));
  L.p[2] = problem(b3_src, k3, b3, b3_mode, c, c, 0, o5,
                   out_seg(out, sums, 0, o5, co, o0 + o2 + o4, 0));
  if constexpr (sizeof(T) == 2) {
    e = (cudaError_t)sm90::launch(L, stream);
  } else {
    int widest = o2 > o4 ? o2 : o4;
    widest = widest > o5 ? widest : o5;
    dim3 grid2((L.rows + C::BM - 1) / C::BM, (widest + C::BN - 1) / C::BN, 3);
    inception_gemm<T, kPlain><<<grid2, kThreads, 0, stream>>>(L);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || sums == nullptr) return (int)e;

  // 3) avg_tail: (s[t] + s[t+1]) / (2 H W)
  const size_t total = (size_t)n * (t - 1) * co;
  avg_tail_finish<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      sums, static_cast<T*>(out), n, t, co, 1.0f / (float)(2 * h * w));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (N, T, H, W, C) channels-last rows, or with pool_k > 0 the pre-pool
// map (N, T, 2H, 2W, C) of a (pool_kt, pool_k, pool_k) stride-(1, 2, 2)
// TF-SAME max pool, pool_kt in {1, 2, 3}, pool_k in {2, 3}; H, W are the
// module's (pooled) map. out (N, T, H, W, co) rows, or (N, T-1, co) with
// avg_tail; scratch (N*T*H*W, o1+o3); pooled (N*T*H*W, C) in bf16, twice
// that with pool_k > 0 in bf16, (N*T*H*W, C) with pool_k > 0 in f32, else
// null; sums (N*T, co) f32 zeroed, used only with avg_tail (else
// null). Kernels k1 (C, o0+o1+o3), kb1 (27, o1, o2), kb2 (27, o3, o4), k3
// (C, o5) in the working dtype, biases f32. dtype: 0 = float32,
// 1 = bfloat16. All tensors contiguous.
int jmt_inception_module(const void* x, void* out, void* scratch,
                         void* pooled, void* sums, const void* k1,
                         const void* b1, const void* kb1, const void* bb1,
                         const void* kb2, const void* bb2, const void* k3,
                         const void* b3, int n, int t, int h, int w, int c,
                         int o0, int o1, int o2, int o3, int o4, int o5,
                         int pool_kt, int pool_k, int avg_tail, int dtype,
                         void* stream) {
  const int o[6] = {o0, o1, o2, o3, o4, o5};
  bool ok = n > 0 && t > 0 && h > 0 && w > 0 && c > 0 && c % 8 == 0 &&
            (dtype == 0 || dtype == 1) && (!avg_tail || (t >= 2 && sums));
  for (int i = 0; i < 6; ++i) ok = ok && o[i] > 0 && o[i] % 8 == 0;
  ok = ok && (pool_k == 0 || ((pool_k == 2 || pool_k == 3) && pool_kt >= 1 &&
                              pool_kt <= 3 && pooled));
  ok = ok && (dtype == 0 || pooled);
  // rows are int (the pre-pool map's too), addresses 64-bit
  ok = ok && (long long)n * t * (2 * h) * (2 * w) < INT_MAX;
  if (!ok) return (int)cudaErrorInvalidValue;
  float* s = avg_tail ? static_cast<float*>(sums) : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fb1 = static_cast<const float*>(b1),
              *fbb1 = static_cast<const float*>(bb1),
              *fbb2 = static_cast<const float*>(bb2),
              *fb3 = static_cast<const float*>(b3);
  return dtype == 0
             ? run<float>(x, out, scratch, pooled, s, k1, fb1, kb1, fbb1, kb2,
                          fbb2, k3, fb3, n, t, h, w, c, o, pool_kt, pool_k, st)
             : run<bf16>(x, out, scratch, pooled, s, k1, fb1, kb1, fbb1, kb2,
                         fbb2, k3, fb3, n, t, h, w, c, o, pool_kt, pool_k, st);
}

}  // extern "C"
