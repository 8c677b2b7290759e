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
//                   then (s[t] + s[t+1]) / (2 H W): output (N, T-1, co).
//
// What bounds it on an H100: operations. A bucket-8 forward (128 clips, T 8)
// runs the nine modules at about 4.8 TFLOP against well under 1 GB of
// input and output each, so the tensor cores set the least time (about
// 4.9 ms at 989 TFLOP/s bf16), not the 3.35 TB/s of HBM.
//
// The design answers with implicit GEMMs on the tensor cores (bf16 in, f32
// accumulate through nvcuda::wmma; the f32 path is full-fp32 FMA, no TF32,
// for parity) and keeps the two im2col tensors and the pooled x out of
// device memory: the 3x3x3 taps and the pool are gathered while a tile of
// A is loaded into shared memory, with bounds-checked zero fill giving the
// SAME padding. Two launches: the merged 1x1 GEMM (writing b0 and the
// relu'd branch-a activations to a scratch tensor), then b1b, b2b and b3 as
// three problems of one grid; avg_tail adds per-(n, t) sums by atomicAdd
// in the epilogues and a small last pass. The TPU's halo tiles, merged-row
// layout and H-tile table answered a 16 MB VMEM and XLA fusion seams and
// are not carried over. Tiles are 128 x 128, double-buffered through
// registers; wgmma, TMA and persistence are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxSeg = 3;
constexpr int kMaxProb = 3;

enum Mode : int { kGemm1x1 = 0, kConv3x3x3 = 1, kPoolGemm = 2 };

// A run of GEMM columns [begin, end) and where its epilogue writes: row r,
// column c goes to dst[r * ld + off + c - begin] in the working dtype, or,
// with sums, is added to sums[(r / (H W)) * ld + off + c - begin] in f32.
struct Seg {
  void* dst;
  float* sums;
  int begin, end, ld, off;
  int round_first;  // round acc + bias to the working dtype before relu
};

// One GEMM: rows of A (lda apart, from channel aoff) against w (k, ncols).
struct Problem {
  const void* a;
  const void* w;
  const float* bias;
  int mode, cin, lda, aoff, k, ncols, nseg;
  Seg seg[kMaxSeg];
};

struct Launch {
  Problem p[kMaxProb];
  int nprob, rows, t, h, w;  // rows = N * T * H * W
};

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BM = 128, BN = 128, BK = 32, VEC = 8, PAD = 8;
};
template <> struct Tile<float> {
  static constexpr int BM = 128, BN = 128, BK = 16, VEC = 4, PAD = 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

template <typename T>
__device__ __forceinline__ uint4 ldg16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T> __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b);
template <> __device__ __forceinline__ uint4 vmax<float>(uint4 a, uint4 b) {
  uint4 r;
  r.x = __float_as_uint(fmaxf(__uint_as_float(a.x), __uint_as_float(b.x)));
  r.y = __float_as_uint(fmaxf(__uint_as_float(a.y), __uint_as_float(b.y)));
  r.z = __float_as_uint(fmaxf(__uint_as_float(a.z), __uint_as_float(b.z)));
  r.w = __float_as_uint(fmaxf(__uint_as_float(a.w), __uint_as_float(b.w)));
  return r;
}
template <> __device__ __forceinline__ uint4 vmax<bf16>(uint4 a, uint4 b) {
  uint4 r;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) pr[i] = __hmax2(pa[i], pb[i]);
  return r;
}

// The (t, h, w) of one A row this thread loads, fixed for the whole block.
struct RowInfo {
  int row, t, h, w;
  bool ok;
};

// VEC consecutive A values of row ri at GEMM depth k (k is a multiple of
// VEC, and every channel count a multiple of 8, so the VEC values share
// one tap and one 16-byte load).
template <typename T>
__device__ __forceinline__ uint4 load_a(const Problem& p, const Launch& L,
                                        const RowInfo& ri, int k) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!ri.ok || k >= p.k) return zero;
  const T* a = static_cast<const T*>(p.a) + p.aoff;
  if (p.mode == kGemm1x1) return ldg16(a + (size_t)ri.row * p.lda + k);
  if (p.mode == kConv3x3x3) {
    const int tap = k / p.cin, c = k - tap * p.cin;
    const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
    const int tt = ri.t + dt - 1, hh = ri.h + dh - 1, ww = ri.w + dw - 1;
    if (tt < 0 || tt >= L.t || hh < 0 || hh >= L.h || ww < 0 || ww >= L.w)
      return zero;
    const long long nb =
        (long long)ri.row + ((dt - 1) * L.h + (dh - 1)) * L.w + (dw - 1);
    return ldg16(a + nb * p.lda + c);
  }
  // kPoolGemm: zero-padded 3x3x3 stride-1 max of channels [k, k + VEC)
  uint4 r = ldg16(a + (size_t)ri.row * p.lda + k);
  for (int dt = -1; dt <= 1; ++dt)
    for (int dh = -1; dh <= 1; ++dh)
      for (int dw = -1; dw <= 1; ++dw) {
        const int tt = ri.t + dt, hh = ri.h + dh, ww = ri.w + dw;
        uint4 v = zero;
        if (tt >= 0 && tt < L.t && hh >= 0 && hh < L.h && ww >= 0 &&
            ww < L.w) {
          const long long nb = (long long)ri.row + (dt * L.h + dh) * L.w + dw;
          v = ldg16(a + nb * p.lda + k);
        }
        r = vmax<T>(r, v);
      }
  return r;
}

template <typename T>
__device__ __forceinline__ void emit(const Problem& p, int hw, int row,
                                     int col, float acc) {
  float v = acc + p.bias[col];
  int s = 0;
  while (s + 1 < p.nseg && col >= p.seg[s].end) ++s;
  const Seg& g = p.seg[s];
  if (g.round_first) v = to_f(from_f<T>(v));
  v = fmaxf(v, 0.0f);
  const int c = g.off + col - g.begin;
  if (g.sums != nullptr)
    atomicAdd(g.sums + (size_t)(row / hw) * g.ld + c, v);
  else
    static_cast<T*>(g.dst)[(size_t)row * g.ld + c] = from_f<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
inception_gemm(const __grid_constant__ Launch L) {
  using C = Tile<T>;
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, VEC = C::VEC;
  constexpr int LDA = BK + C::PAD, LDB = BN + C::PAD;
  constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  constexpr int A_PER_ROW = BK / VEC, B_PER_ROW = BN / VEC;
  constexpr int A_LOADS = BM * BK / VEC / kThreads;
  constexpr int B_LOADS = BK * BN / VEC / kThreads;
  constexpr int kSmem = 2 * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static_assert(kSmem >= 8 * 256 * 4, "epilogue patches reuse the tiles");
  static_assert(BM % (kThreads / A_PER_ROW) == 0, "A rows per pass");
  __shared__ __align__(128) unsigned char smem[kSmem];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * A_ELEMS;

  if ((int)blockIdx.z >= L.nprob) return;
  const Problem& p = L.p[blockIdx.z];
  const int n0 = blockIdx.y * BN;
  if (n0 >= p.ncols) return;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int hw = L.h * L.w;

  RowInfo ri[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int row = m0 + (tid + i * kThreads) / A_PER_ROW;
    ri[i].row = row;
    ri[i].ok = row < L.rows;
    ri[i].w = row % L.w;
    ri[i].h = (row / L.w) % L.h;
    ri[i].t = (row / hw) % L.t;
  }
  const T* wmat = static_cast<const T*>(p.w);
  uint4 ra[A_LOADS], rb[B_LOADS];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int kv = (tid + i * kThreads) % A_PER_ROW;
      ra[i] = load_a<T>(p, L, ri[i], k0 + kv * VEC);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int v = tid + i * kThreads;
      const int k = k0 + v / B_PER_ROW, col = n0 + (v % B_PER_ROW) * VEC;
      rb[i] = (k < p.k && col < p.ncols)
                  ? ldg16(wmat + (size_t)k * p.ncols + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + buf * A_ELEMS + (v / A_PER_ROW) * LDA +
                                (v % A_PER_ROW) * VEC) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(Bs + buf * B_ELEMS + (v / B_PER_ROW) * LDB +
                                (v % B_PER_ROW) * VEC) = rb[i];
    }
  };

  const int nk = (p.k + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();

  if constexpr (sizeof(T) == 2) {
    // 8 warps as 4 (rows) x 2 (columns); each warp owns 32 x 64 outputs as
    // 2 x 4 fragments of 16 x 16.
    using namespace nvcuda;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = n0 + wn * 64 + j * 16 < p.ncols;

    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) fetch((kt + 1) * BK);
      const T* a_s = As + cur * A_ELEMS;
      const T* b_s = Bs + cur * B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) continue;
          wmma::load_matrix_sync(fb, b_s + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      if (kt + 1 < nk) stash(cur ^ 1);
      __syncthreads();
    }

    // epilogue through a 16 x 16 f32 patch per warp (reusing the tiles)
    float* patch = reinterpret_cast<float*>(smem) + warp * 256;
    const int r = lane >> 1, cb = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live[j]) continue;
        wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int row = m0 + wm * 32 + i * 16 + r;
        const int col0 = n0 + wn * 64 + j * 16 + cb;
        if (row < L.rows)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col0 + e < p.ncols)
              emit<T>(p, hw, row, col0 + e, patch[r * 16 + cb + e]);
        __syncwarp();
      }
  } else {
    // full-fp32 FMA: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j
    const int ty = tid >> 4, tx = tid & 15;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) fetch((kt + 1) * BK);
      const T* a_s = As + cur * A_ELEMS;
      const T* b_s = Bs + cur * B_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(a_s[(ty + 16 * i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f(b_s[kk * LDB + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (kt + 1 < nk) stash(cur ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= L.rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < p.ncols) emit<T>(p, hw, row, col, acc[i][j]);
      }
    }
  }
}

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

Seg out_seg(void* out, float* sums, int begin, int end, int co, int off,
            int round_first) {
  Seg g;
  g.dst = sums != nullptr ? nullptr : out;
  g.sums = sums;
  g.begin = begin;
  g.end = end;
  g.ld = co;
  g.off = off;
  g.round_first = round_first;
  return g;
}

Problem problem(const void* a, const void* w, const float* bias, int mode,
                int cin, int lda, int aoff, int ncols, Seg g) {
  Problem p = {};
  p.a = a;
  p.w = w;
  p.bias = bias;
  p.mode = mode;
  p.cin = cin;
  p.lda = lda;
  p.aoff = aoff;
  p.k = mode == kConv3x3x3 ? 27 * cin : cin;
  p.ncols = ncols;
  p.nseg = 1;
  p.seg[0] = g;
  return p;
}

template <typename T>
int run(const void* x, void* out, void* scratch, float* sums, const void* k1,
        const float* b1, const void* kb1, const float* bb1, const void* kb2,
        const float* bb2, const void* k3, const float* b3, int n, int t,
        int h, int w, int c, const int* o, cudaStream_t stream) {
  using C = Tile<T>;
  const int o0 = o[0], o1 = o[1], o2 = o[2], o3 = o[3], o4 = o[4], o5 = o[5];
  const int co = o0 + o2 + o4 + o5, sa = o1 + o3;
  Launch L = {};
  L.rows = n * t * h * w;
  L.t = t;
  L.h = h;
  L.w = w;

  // 1) merged b0 | b1a | b2a GEMM: b0 to the output, relu(a1) | relu(a2)
  //    to the scratch rows
  L.nprob = 1;
  L.p[0] = problem(x, k1, b1, kGemm1x1, c, c, 0, o0 + o1 + o3,
                   out_seg(out, sums, 0, o0, co, 0, 1));
  L.p[0].nseg = 3;
  L.p[0].seg[1] = out_seg(scratch, nullptr, o0, o0 + o1, sa, 0, 1);
  L.p[0].seg[2] = out_seg(scratch, nullptr, o0 + o1, o0 + o1 + o3, sa, o1, 1);
  dim3 grid1((L.rows + C::BM - 1) / C::BM, (o0 + o1 + o3 + C::BN - 1) / C::BN,
             1);
  inception_gemm<T><<<grid1, kThreads, 0, stream>>>(L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // 2) b1b, b2b (3x3x3 over the scratch) and b3 (pool + 1x1 over x)
  L.nprob = 3;
  L.p[0] = problem(scratch, kb1, bb1, kConv3x3x3, o1, sa, 0, o2,
                   out_seg(out, sums, 0, o2, co, o0, 0));
  L.p[1] = problem(scratch, kb2, bb2, kConv3x3x3, o3, sa, o1, o4,
                   out_seg(out, sums, 0, o4, co, o0 + o2, 0));
  L.p[2] = problem(x, k3, b3, kPoolGemm, c, c, 0, o5,
                   out_seg(out, sums, 0, o5, co, o0 + o2 + o4, 0));
  int widest = o2 > o4 ? o2 : o4;
  widest = widest > o5 ? widest : o5;
  dim3 grid2((L.rows + C::BM - 1) / C::BM, (widest + C::BN - 1) / C::BN, 3);
  inception_gemm<T><<<grid2, kThreads, 0, stream>>>(L);
  e = cudaGetLastError();
  if (e != cudaSuccess || sums == nullptr) return (int)e;

  // 3) avg_tail: (s[t] + s[t+1]) / (2 H W)
  const size_t total = (size_t)n * (t - 1) * co;
  avg_tail_finish<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      sums, static_cast<T*>(out), n, t, co, 1.0f / (float)(2 * h * w));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// x (N, T, H, W, C) channels-last rows; out (N, T, H, W, co) rows, or
// (N, T-1, co) with avg_tail; scratch (N*T*H*W, o1+o3); sums (N*T, co) f32
// zeroed, used only with avg_tail (else null). Kernels k1 (C, o0+o1+o3),
// kb1 (27, o1, o2), kb2 (27, o3, o4), k3 (C, o5) in the working dtype,
// biases f32. dtype: 0 = float32, 1 = bfloat16. All tensors contiguous.
int jmt_inception_module(const void* x, void* out, void* scratch, void* sums,
                         const void* k1, const void* b1, const void* kb1,
                         const void* bb1, const void* kb2, const void* bb2,
                         const void* k3, const void* b3, int n, int t, int h,
                         int w, int c, int o0, int o1, int o2, int o3, int o4,
                         int o5, int avg_tail, int dtype, void* stream) {
  const int o[6] = {o0, o1, o2, o3, o4, o5};
  bool ok = n > 0 && t > 0 && h > 0 && w > 0 && c > 0 && c % 8 == 0 &&
            (dtype == 0 || dtype == 1) && (!avg_tail || (t >= 2 && sums));
  for (int i = 0; i < 6; ++i) ok = ok && o[i] > 0 && o[i] % 8 == 0;
  ok = ok && (long long)n * t * h * w < INT_MAX;  // rows are int, addresses 64-bit
  if (!ok) return (int)cudaErrorInvalidValue;
  float* s = avg_tail ? static_cast<float*>(sums) : nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fb1 = static_cast<const float*>(b1),
              *fbb1 = static_cast<const float*>(bb1),
              *fbb2 = static_cast<const float*>(bb2),
              *fb3 = static_cast<const float*>(b3);
  return dtype == 0 ? run<float>(x, out, scratch, s, k1, fb1, kb1, fbb1, kb2,
                                 fbb2, k3, fb3, n, t, h, w, c, o, st)
                    : run<bf16>(x, out, scratch, s, k1, fb1, kb1, fbb1, kb2,
                                fbb2, k3, fb3, n, t, h, w, c, o, st);
}

}  // extern "C"
