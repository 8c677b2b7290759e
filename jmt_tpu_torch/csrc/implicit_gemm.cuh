// The implicit GEMM shared by the inception module (inception.cu, K3) and
// the pool + 1x1 kernel (pool1x1.cu, K4): rows of A are (n, t, h, w)
// positions of a channels-last map, gathered while a tile is loaded into
// shared memory (1x1 rows, 3x3x3 taps, 3x3x3 pools, pooled rows), against
// a (K, ncols) weight matrix, with f32 accumulation: bf16 on the tensor
// cores through nvcuda::wmma, f32 as full-fp32 FMA (no TF32). Tiles are
// 128 x 128, double-buffered through registers.
#pragma once

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

// What a kernel instance does beyond the modes (a template argument, so
// that each variant compiles to its own code):
//   kPlain   K3: zero-filled pool padding, epilogue relu(acc + bias);
//   kPoolIn  K3's first launch with pool_in: a kGemm1x1 row is the max
//            over its pre-pool window (Launch::pool_kt, pool_k), and the
//            column-tile-0 blocks also write it to Problem::pool_dst;
//   kNegInf  K4: -inf pool padding (pad positions are skipped), epilogue
//            the cast of acc alone (no bias, no relu).
enum Variant : int { kPlain = 0, kPoolIn = 1, kNegInf = 2 };

// A run of GEMM columns [begin, end) and where its epilogue writes: row r,
// column c goes to dst[r * ld + off + c - begin] in the working dtype, or,
// with sums (avg_tail), into a slot of its (n, t) group in f32 (avg_slots).
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
  void* pool_dst;  // kPoolIn: the pooled rows (rows, cin), else unused
  int mode, cin, lda, aoff, k, ncols, nseg;
  Seg seg[kMaxSeg];
};

struct Launch {
  Problem p[kMaxProb];
  int nprob, rows, t, h, w;  // rows = N * T * H * W
  int pool_kt, pool_k;       // kPoolIn: window (kt, k, k), stride (1, 2, 2)
  int slots;                 // avg_tail: slots per (n, t) group
};

// avg_tail's sums in a fixed order. The epilogues write each f32 partial
// sum of an (n, t) group (H W rows) by a plain store into a slot of its
// own, and the last pass adds a group's slots in index order, so that the
// sums are the same bits run to run (atomics added them in whatever order
// the warps came). Group g's slot j of column c is
// sums[(g * slots + j) * ld + c]. The bf16 epilogue (igemm_sm90.cuh) writes
// one slot per 16-row block the group touches (its warp's sum over its
// rows of the group), hw + 14 rows at most, so (hw + 14) / 16 + 1 slots;
// the f32 one (emit) one slot per row.
__host__ __device__ inline int avg_slots(int hw, bool bf16) {
  return bf16 ? (hw + 14) / 16 + 1 : hw;
}

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

// kPoolIn: the TF-SAME (kt, k, k) stride-(1, 2, 2) max pool of channels
// [k, k + VEC) at pooled row ri, from the pre-pool map (T, 2H, 2W) at a:
// window t - (kt - 1) / 2 + [0, kt), 2h + [0, k), 2w + [0, k). Positions
// past the map are zero fill, the same as -inf because x >= 0.
template <typename T>
__device__ __forceinline__ uint4 load_pooled(const T* a, const Problem& p,
                                             const Launch& L,
                                             const RowInfo& ri, int k) {
  const int hp = 2 * L.h, wp = 2 * L.w;
  const long long nt = ri.row / (L.h * L.w) - ri.t;  // n * T
  const int t0 = ri.t - (L.pool_kt - 1) / 2;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  for (int tt = t0; tt < t0 + L.pool_kt; ++tt) {
    if (tt < 0 || tt >= L.t) continue;
    for (int hh = 2 * ri.h; hh < 2 * ri.h + L.pool_k && hh < hp; ++hh)
      for (int ww = 2 * ri.w; ww < 2 * ri.w + L.pool_k && ww < wp; ++ww) {
        const long long pre = ((nt + tt) * hp + hh) * wp + ww;
        r = vmax<T>(r, ldg16(a + pre * p.lda + k));
      }
  }
  return r;
}

// VEC consecutive A values of row ri at GEMM depth k (k is a multiple of
// VEC, and every channel count a multiple of 8, so the VEC values share
// one tap and one 16-byte load).
template <typename T, int V>
__device__ __forceinline__ uint4 load_a(const Problem& p, const Launch& L,
                                        const RowInfo& ri, int k) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!ri.ok || k >= p.k) return zero;
  const T* a = static_cast<const T*>(p.a) + p.aoff;
  if (p.mode == kGemm1x1) {
    if constexpr (V == kPoolIn) return load_pooled<T>(a, p, L, ri, k);
    return ldg16(a + (size_t)ri.row * p.lda + k);
  }
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
  // kPoolGemm: 3x3x3 stride-1 max of channels [k, k + VEC); a pad
  // position is a zero (K3) or is skipped (kNegInf: -inf padding)
  uint4 r = ldg16(a + (size_t)ri.row * p.lda + k);
  for (int dt = -1; dt <= 1; ++dt)
    for (int dh = -1; dh <= 1; ++dh)
      for (int dw = -1; dw <= 1; ++dw) {
        const int tt = ri.t + dt, hh = ri.h + dh, ww = ri.w + dw;
        const bool in = tt >= 0 && tt < L.t && hh >= 0 && hh < L.h &&
                        ww >= 0 && ww < L.w;
        const long long nb = (long long)ri.row + (dt * L.h + dh) * L.w + dw;
        if constexpr (V == kNegInf) {
          if (in) r = vmax<T>(r, ldg16(a + nb * p.lda + k));
        } else {
          uint4 v = zero;
          if (in) v = ldg16(a + nb * p.lda + k);
          r = vmax<T>(r, v);
        }
      }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void emit(const Problem& p, int hw, int row,
                                     int col, float acc) {
  if constexpr (V == kNegInf) {
    const Seg& g = p.seg[0];
    static_cast<T*>(g.dst)[(size_t)row * g.ld + g.off + col] = from_f<T>(acc);
    return;
  }
  float v = acc + p.bias[col];
  int s = 0;
  while (s + 1 < p.nseg && col >= p.seg[s].end) ++s;
  const Seg& g = p.seg[s];
  if (g.round_first) v = to_f(from_f<T>(v));
  v = fmaxf(v, 0.0f);
  const int c = g.off + col - g.begin;
  if (g.sums != nullptr)  // slot row % hw of group row / hw: row itself
    g.sums[(size_t)row * g.ld + c] = v;
  else
    static_cast<T*>(g.dst)[(size_t)row * g.ld + c] = from_f<T>(v);
}

template <typename T, int V>
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
      const int k = k0 + ((tid + i * kThreads) % A_PER_ROW) * VEC;
      ra[i] = load_a<T, V>(p, L, ri[i], k);
      if constexpr (V == kPoolIn) {
        if (blockIdx.y == 0 && ri[i].ok && k < p.k)
          *reinterpret_cast<uint4*>(static_cast<T*>(p.pool_dst) +
                                    (size_t)ri[i].row * p.cin + k) = ra[i];
      }
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
              emit<T, V>(p, hw, row, col0 + e, patch[r * 16 + cb + e]);
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
        if (col < p.ncols) emit<T, V>(p, hw, row, col, acc[i][j]);
      }
    }
  }
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

}  // namespace

extern "C" const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
