// Fused attention core: out = softmax(q k^T) v over BH independent problems.
// q (BH, Lq, D) arrives pre-scaled by D**-0.5; k, v (BH, Lk, D); f32 or bf16.
//
// Replaces the TPU kernel jmt_tpu/ops/pallas/fused_attention.py
// (fused_attention, body _kernel). Numerics follow it and the XLA path
// _core_xla: scores and softmax in f32 (with max subtraction), P cast to v's
// dtype before P.V, P.V accumulated in f32 and cast to v's dtype.
//
// The TPU gate (jmt_tpu/ops/attention.py, _pallas_ok) admitted only
// head_dim <= 256 and L <= 128: a VMEM/tiling limit of the TPU's Mosaic
// lowering, not a property of the function; JAX sends every other shape to
// _core_xla. The port's gate is any Lq, Lk >= 1 at D <= 512 (E = 512 with
// one head or more: every attention of the JAX lattice). Lq, Lk <= 128
// take the short path below; anything longer the long path at the end of
// this note.
//
// What bounds it on an H100: the served problems are tiny (L = 2, 6 or 16
// tokens, D = 512, BH 8 to 128), so bytes bound it (q, k, v read once, out
// written once, about 3 flops per byte in bf16): a few MB, about a
// microsecond at 3.35 TB/s. In practice the launch, the host's call path
// and the serial steps inside a block set the time.
//
// The design, for the served shapes first:
// - Spread over the card: grid (BH, S). Block (b, s) owns the D slice s of
//   problem b's output and recomputes the (cheap) scores itself, so a
//   problem is spread over S blocks without a second pass or atomics. S is
//   picked so that about two blocks per SM are in flight (BH 8 and 16: S 8,
//   64-wide slices; BH 128: S 3) and so that no thread owns more than
//   kItems output vectors. Packing several L = 2 problems into one block
//   was the other choice; splitting D needs no cross-problem indexing and
//   helps every served shape.
// - Staging: q and k are copied into shared memory a 16-row tile at a time
//   over the whole of D, with 16-byte cp.async and zero fill past Lq, Lk
//   (bf16 at L = 16, D = 512: 16 KB each), rows padded by 16 bytes so that
//   eight rows fall in eight bank groups. Above 16 tokens the tiles stream:
//   each (16 x 16) score tile stages its own q and k rows, so shared memory
//   stays within 138 KB up to the gate's L = 128, D = 512 in f32.
// - Scores: the 8 warps split D into 8 contiguous ranges; a lane holds a
//   2 x 4 patch of the 16 x 16 score tile and runs f32 FMA over its warp's
//   range from 16-byte shared-memory vectors (full fp32, no TF32 and no
//   tensor cores: the f32 tolerance is 2e-5, and at 16 x 16 x 512 the FMAs
//   take less than the staging). The 8 partial sums are added in warp order
//   in shared memory.
// - Softmax as the TPU kernel casts it (one warp per row); P rounded to v's
//   dtype and kept in shared memory as f32.
// - P.V: v's slice is staged 16 rows at a time in the k buffer; a thread
//   owns up to kItems (row, 16-byte vector) outputs, accumulates in f32
//   over j in order and stores 16-byte vectors.
// Rows not 16-byte aligned (D not a multiple of 8 in bf16 or 4 in f32, or
// an unaligned pointer) take the same kernel with scalar staging and
// stores (template argument kVec).
//
// The long path (Lq or Lk > 128: NoJR's encoders over more than 128 batch
// rows, an encoder over a window longer than 128 steps). The short path
// keeps the whole Lq x Lk score matrix in shared memory, which stops
// fitting near L = 180 in f32; past 128 the work is instead spread by query
// tile. What bounds it once L is in the hundreds: operations, 4 Lq Lk D
// (about 0.74 GFLOP at BH 4, L 300, D 512), which on the FMA units (67
// TFLOP/s f32, no tensor cores, as above) is ~11 us; bytes are ~5 MB
// (~1.5 us). Its design:
// - grid (BH x query tiles of 16 rows, D slices): the block of (problem,
//   tile, slice) stages its 16 q rows once and streams the key tiles of 16
//   rows through shared memory, computing each 16 x 16 score tile exactly
//   as the short path does (the same 8 warp D ranges and order), so the
//   scores are the same bits;
// - two passes over the key tiles, to keep _core_xla's rounding points:
//   pass one keeps each row's running max m and sum of exp(s - m) in f32
//   (the 16 lanes of a row reduce by shuffles, the sum rescaled when m
//   grows); pass two recomputes each score tile, forms the NORMALIZED
//   P = exp(s - m) / l, rounds it to v's dtype, stages v's slice of the
//   key tile and accumulates P.V in f32 over j in order. A flash-style
//   online softmax would round an unnormalized P instead; the second pass
//   costs the scores once more (half of the work);
// - shared memory: q and k/v tiles, the warps' partial scores and one
//   16 x 16 P tile, 75 KB at D = 512 in f32, whatever L is.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;
constexpr int kMaxD = 512;
constexpr int kTile = 16;       // score tile: kTile query x kTile key rows
constexpr int kItems = 4;       // P.V output vectors per thread at most
constexpr int kTargetBlocks = 264;  // two per SM of an H100

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

template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements in 16 bytes
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// 16-byte cp.async; src-size 0 zero-fills (rows past L)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy rows [r0, r0 + kTile) x columns [c0, c0 + w) of the (l, d) matrix g
// into dst (kTile rows, pitch elements); rows >= l and columns >= d are
// zero. kVec: w, d and the pointers are 16-byte multiples.
template <typename T, bool kVec>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* g, int l,
                                      int d, int r0, int c0, int w) {
  constexpr int V = Vec<T>::N;
  const int wr = round_up(w, V);
  if constexpr (kVec) {
    const int nv = wr / V;
    for (int t = threadIdx.x; t < kTile * nv; t += kThreads) {
      const int r = t / nv, c = (t - r * nv) * V;
      const bool ok = r0 + r < l;
      cp_async16(dst + r * pitch + c,
                 ok ? g + (size_t)(r0 + r) * d + c0 + c : g, ok);
    }
    cp_async_wait_all();
  } else {
    for (int t = threadIdx.x; t < kTile * wr; t += kThreads) {
      const int r = t / wr, c = t - r * wr;
      dst[r * pitch + c] = (r0 + r < l && c0 + c < d && c < w)
                               ? g[(size_t)(r0 + r) * d + c0 + c]
                               : from_f<T>(0.0f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(float* out, const T* p) {
  constexpr int V = Vec<T>::N;
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

// The score of this thread's (i, j) = (tid / kTile, tid % kTile) in the
// kTile x kTile tile of the query rows staged in qs against key rows
// [j0, j0 + kTile) of k, which it stages into ks: warp w sums D range
// [w dw, (w + 1) dw) by f32 FMA (lane rows ri, ri + 8, columns cj + 4 c),
// and the 8 partial sums are added in warp order. Every thread has left
// ks when it returns.
template <typename T, bool kVec>
__device__ __forceinline__ float tile_score(const T* qs, T* ks, float* part,
                                            int pitch, const T* k, int lk,
                                            int d, int j0) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int dr = round_up(d, V);
  const int dw = round_up((dr + kWarps - 1) / kWarps, V);
  const int e0 = warp * dw, e1 = min(dr, e0 + dw);
  const int ri = lane >> 2, cj = lane & 3;
  stage<T, kVec>(ks, pitch, k, lk, d, j0, 0, d);
  __syncthreads();
  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  for (int e = e0; e < e1; e += V) {
    float qv[2][V], kv[4][V];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      load_vec<T>(qv[a], qs + (ri + 8 * a) * pitch + e);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      load_vec<T>(kv[c], ks + (cj + 4 * c) * pitch + e);
#pragma unroll
    for (int x = 0; x < V; ++x)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[a][c] = fmaf(qv[a][x], kv[c][x], acc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[warp * kTile * kTile + (ri + 8 * a) * kTile + cj + 4 * c] =
          acc[a][c];
  __syncthreads();
  float sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += part[w * kTile * kTile + tid];
  return sum;
}

// P.V of one key chunk: thread item m is output vector tid + m kThreads
// (row i, vector cv of the slice); p (row i at p + i ld) and the chunk's
// v rows in vs (jn rows, pitch apart) are in shared memory; f32 FMA over
// j in order.
template <typename T>
__device__ __forceinline__ void accumulate_pv(
    float (&acc)[kItems][Vec<T>::N], const float* p, int ld, const T* vs,
    int pitch, int jn, int nv, int n_items) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int item = threadIdx.x + m * kThreads;
    if (item < n_items) {
      const int i = item / nv, cv = item - i * nv;
      for (int jj = 0; jj < jn; ++jj) {
        const float pj = p[i * ld + jj];
        float vv[V];
        load_vec<T>(vv, vs + jj * pitch + cv * V);
#pragma unroll
        for (int x = 0; x < V; ++x) acc[m][x] = fmaf(pj, vv[x], acc[m][x]);
      }
    }
  }
}

// The thread's output vectors (as accumulate_pv numbers them) rounded to
// T into rows of o (d apart), columns [c0, c0 + w).
template <typename T, bool kVec>
__device__ __forceinline__ void store_out(
    const float (&acc)[kItems][Vec<T>::N], T* o, int d, int c0, int w,
    int nv, int n_items) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int item = threadIdx.x + m * kThreads;
    if (item >= n_items) continue;
    const int i = item / nv, cv = item - i * nv;
    T* dst = o + (size_t)i * d + c0 + cv * V;
    if constexpr (kVec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int x = 0; x < V; ++x) e[x] = from_f<T>(acc[m][x]);
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x)
        if (cv * V + x < w) dst[x] = from_f<T>(acc[m][x]);
    }
  }
}

// Shared memory: qs and ks (kTile x pitch each; ks also holds the v
// chunks), the warps' partial scores (kWarps x kTile^2 f32), the scores
// (lq x lk f32).
template <typename T>
__host__ __device__ constexpr int pitch_of(int d) {
  return round_up(d, 16 / (int)sizeof(T)) + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int lq, int lk, int d) {
  return 2 * sizeof(T) * kTile * pitch_of<T>(d) +
         sizeof(float) * (kWarps * kTile * kTile + lq * lk);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                 int d, int slice) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = pitch_of<T>(d);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * pitch;
  float* part = reinterpret_cast<float*>(ks + kTile * pitch);
  float* s = part + kWarps * kTile * kTile;

  const size_t b = blockIdx.x;
  q += b * lq * d;
  k += b * lk * d;
  v += b * lk * d;
  o += b * lq * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // scores, one 16 x 16 tile at a time
  for (int i0 = 0; i0 < lq; i0 += kTile) {
    stage<T, kVec>(qs, pitch, q, lq, d, i0, 0, d);
    for (int j0 = 0; j0 < lk; j0 += kTile) {
      const float sum =
          tile_score<T, kVec>(qs, ks, part, pitch, k, lk, d, j0);
      const int i = tid / kTile, j = tid - i * kTile;
      if (i0 + i < lq && j0 + j < lk) s[(i0 + i) * lk + j0 + j] = sum;
      __syncthreads();
    }
  }

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

  // P.V over this block's slice [c0, c0 + w) of D, v staged 16 rows at a
  // time; thread item m is output vector tid + m kThreads: row i, vector cv
  const int c0 = blockIdx.y * slice, w = min(slice, d - c0);
  const int nv = round_up(w, V) / V, n_items = lq * nv;
  float acc[kItems][V];
#pragma unroll
  for (int m = 0; m < kItems; ++m)
#pragma unroll
    for (int x = 0; x < V; ++x) acc[m][x] = 0.0f;
  for (int j0 = 0; j0 < lk; j0 += kTile) {
    __syncthreads();  // softmax done / the previous chunk consumed
    stage<T, kVec>(ks, pitch, v, lk, d, j0, c0, w);
    __syncthreads();
    accumulate_pv<T>(acc, s + j0, lk, ks, pitch, min(kTile, lk - j0), nv,
                     n_items);
  }
  store_out<T, kVec>(acc, o, d, c0, w, nv, n_items);
}

// The long path (Lq or Lk > kMaxL): block (b qtiles + query tile, D
// slice), two passes over the key tiles (see the note at the top).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int lq,
                      int lk, int d, int slice, int qtiles) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = pitch_of<T>(d);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * pitch;
  float* part = reinterpret_cast<float*>(ks + kTile * pitch);
  float* pt = part + kWarps * kTile * kTile;  // the P tile, kTile x kTile

  const size_t b = blockIdx.x / qtiles;
  const int i0 = (int)(blockIdx.x - b * qtiles) * kTile;
  const int rows = min(kTile, lq - i0);
  q += (b * lq + i0) * d;
  k += b * lk * d;
  v += b * lk * d;
  o += (b * lq + i0) * d;
  const int tid = threadIdx.x;
  stage<T, kVec>(qs, pitch, q, rows, d, 0, 0, d);

  // pass one: this thread's row (tid / kTile) max m and sum l of
  // exp(s - m), held alike by the row's 16 lanes
  float m = -CUDART_INF_F, l = 0.0f;
  for (int j0 = 0; j0 < lk; j0 += kTile) {
    const float s = tile_score<T, kVec>(qs, ks, part, pitch, k, lk, d, j0);
    const bool in = j0 + tid % kTile < lk;
    float mt = in ? s : -CUDART_INF_F;
    for (int off = kTile / 2; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float mn = fmaxf(m, mt);  // finite: column j0 is in
    float e = in ? expf(s - mn) : 0.0f;
    for (int off = kTile / 2; off > 0; off >>= 1)
      e += __shfl_xor_sync(0xffffffffu, e, off);
    l = l * expf(m - mn) + e;
    m = mn;
  }

  // pass two: the same scores, P = exp(s - m) / l rounded to T, P.V over
  // this block's slice [c0, c0 + w) of D
  const int c0 = blockIdx.y * slice, w = min(slice, d - c0);
  const int nv = round_up(w, V) / V, n_items = rows * nv;
  float acc[kItems][V];
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int x = 0; x < V; ++x) acc[i][x] = 0.0f;
  for (int j0 = 0; j0 < lk; j0 += kTile) {
    const float s = tile_score<T, kVec>(qs, ks, part, pitch, k, lk, d, j0);
    pt[tid] =
        j0 + tid % kTile < lk ? to_f(from_f<T>(expf(s - m) / l)) : 0.0f;
    stage<T, kVec>(ks, pitch, v, lk, d, j0, c0, w);
    __syncthreads();
    accumulate_pv<T>(acc, pt, kTile, ks, pitch, min(kTile, lk - j0), nv,
                     n_items);
    __syncthreads();  // ks and pt consumed
  }
  store_out<T, kVec>(acc, o, d, c0, w, nv, n_items);
}

// The D slice of one block: at least one 16-byte vector, few enough
// vectors that lq x (vectors) <= kThreads x kItems, and about
// kTargetBlocks blocks in all.
template <typename T>
int slice_of(int bh, int lq, int d) {
  constexpr int V = Vec<T>::N;
  const int nvec = (d + V - 1) / V;
  const int max_vec = kThreads * kItems / lq;  // lq <= 128: >= 8
  // spread: about kTargetBlocks blocks, slices of 64 elements or more
  int split = (kTargetBlocks + bh - 1) / bh;
  const int most = (d + 63) / 64;
  split = split < most ? split : most;
  const int need = (nvec + max_vec - 1) / max_vec;
  split = split > need ? split : need;
  return ((nvec + split - 1) / split) * V;
}

constexpr int kMaxDevices = 64;

// Raise kernel's dynamic shared memory limit to bytes, once per device:
// the attribute holds for the current device only.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done[dev] = e == cudaSuccess;
  return e;
}

template <typename T, bool kVec>
int launch_as(const void* q, const void* k, const void* v, void* o, int bh,
              int lq, int lk, int d, cudaStream_t s) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v);
  T* to = static_cast<T*>(o);
  cudaError_t e;
  if (lq <= kMaxL && lk <= kMaxL) {
    static bool attr_set[kMaxDevices];
    e = allow_smem(attention_kernel<T, kVec>,
                   smem_bytes<T>(kMaxL, kMaxL, kMaxD), attr_set);
    if (e != cudaSuccess) return (int)e;
    const int slice = slice_of<T>(bh, lq, d);
    const dim3 grid(bh, (d + slice - 1) / slice);
    attention_kernel<T, kVec><<<grid, kThreads, smem_bytes<T>(lq, lk, d), s>>>(
        tq, tk, tv, to, lq, lk, d, slice);
  } else {
    static bool attr_set[kMaxDevices];
    e = allow_smem(attention_long_kernel<T, kVec>,
                   smem_bytes<T>(kTile, kTile, kMaxD), attr_set);
    if (e != cudaSuccess) return (int)e;
    const int qtiles = (lq + kTile - 1) / kTile;
    const int slice = slice_of<T>(bh * qtiles, kTile, d);
    const dim3 grid(bh * qtiles, (d + slice - 1) / slice);
    attention_long_kernel<T, kVec>
        <<<grid, kThreads, smem_bytes<T>(kTile, kTile, d), s>>>(
            tq, tk, tv, to, lq, lk, d, slice, qtiles);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int lq, int lk, int d, cudaStream_t s) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)o | (uintptr_t)(d * sizeof(T));
  return any % 16 == 0 ? launch_as<T, true>(q, k, v, o, bh, lq, lk, d, s)
                       : launch_as<T, false>(q, k, v, o, bh, lq, lk, d, s);
}

}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous.
int jmt_fused_attention(const void* q, const void* k, const void* v, void* o,
                        int bh, int lq, int lk, int d, int dtype,
                        void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || d < 1 || d > kMaxD ||
      (long long)bh * ((lq + kTile - 1) / kTile) > INT_MAX ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float>(q, k, v, o, bh, lq, lk, d, s)
                    : launch<__nv_bfloat16>(q, k, v, o, bh, lq, lk, d, s);
}

}  // extern "C"
