// int8 inference (ops/quant.py): K5, an s8 x s8 -> s32 implicit-GEMM
// convolution with a dequantizing epilogue, and K6, the per-tensor
// activation quantizer that feeds it.
//
// Neither replaces a TPU kernel: the JAX package computes its int8 conv
// with XLA (jmt_tpu/ops/quant.py:159-166, lax.conv_general_dilated on s8
// operands with preferred_element_type=int32) and its quantize as XLA
// elementwise ops (:114-123). PyTorch has no int8 convolution on CUDA, so
// the port needs these two.
//
// K5 computes, for an output position m = (n, to, ho, wo) and channel c,
//   acc = sum over taps (kt, kh, kw) and ci of x[n, ti, hi, wi, ci] * w[c, k]
//   out = float(acc) * (s_x * s_w[c])        (f32, the product first)
// cast to f32 or bf16 (round to nearest), with ti = to * st - pt + kt * dt
// (h, w alike) and zero outside the map. x is the s8 activation in
// channels-last rows (N, T, H, W, C); w the s8 weight as (Co, Kp) rows,
// k = ((kt * KH + kh) * KW + kw) * C + ci, zero-padded to Kp, a multiple
// of 32. s_x is read from the device (dynamic: K6 wrote it) or passed by
// value (static). Optionally the raw s32 sums go to `acc` too.
//
// What bounds it on an H100: operations for the trunk's 3x3x3 and 1x1
// convs at bucket 8 (2 M N K s8 operations against 1,979 TOP/s dense,
// bytes against 3.35 TB/s); the stems (C = 3, 45) by their gather.
//
// The design is the simple one (a first port; wgmma and TMA for s8 are
// later work): 128 x 64 output tiles, 256 threads as 4 x 2 warps of
// 32 x 32, each k-step of 32 a mma.sync.m16n8k32 s8 product per 16 x 8
// fragment, A and B staged through a two-stage cp.async ring in shared
// memory rows of 48 bytes (32 of data: the fragment loads of the eight
// row groups then fall on distinct banks). A thread loads one half-row
// of 16 bytes of A a stage: its row's (n, ti0, hi0, wi0) are decoded
// once, and its k's tap advances incrementally. The granularity G of the
// gather is the largest of 16, 4 and 1 bytes that divides C (a segment
// then never straddles a tap): cp.async of 16 or 4 bytes with zero fill
// outside the map, or byte loads packed into one 16-byte store.
//
// K6: pass one takes max |x| over the tensor into a device word by
// atomicMax on the bits of |x| (a max is order-free, so the result is
// deterministic; non-negative floats order as their bits, and a NaN's lie
// above inf's, so a NaN in x makes s NaN, as torch.amax and jnp.max do),
// pass two writes
//   q = clip(rint(x / s), -127, 127),  s = max(amax / 127, 1e-12)
// in channels-last rows, with `/` an IEEE division and rint half-to-even,
// as jnp.round; the first thread stores s. With a static scale pass one
// is skipped. x is f32 or bf16 with any strides (n, c, t, h, w): pass one
// reads a dense x in memory order; pass two reads a channels-last x in
// order, transposes a contiguous (n, c, t, h, w) one by 32 x 32 tiles in
// shared memory, and gathers any other element by element. Bound by
// bytes: 3 a bf16 element, 5 in dynamic mode, which reads x twice.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kRow = 48;  // bytes per shared-memory row (32 + 16 pad)
constexpr int kStages = 2;

struct Conv {
  const int8_t* xq;
  const int8_t* wq;
  const float* sw;
  const float* sx_ptr;  // dynamic scale on the device, or null
  float sx_val;         // static scale
  void* out;
  int32_t* acc;  // the raw sums as well, or null
  int n, t, h, w, c;
  int to, ho, wo, co;
  int kt, kh, kw;
  int st, sh, sw_, dt, dh, dw, pt, ph, pw;
  int k, kp, m, out_bf16;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A half-row of this thread for the k-step starting at k0: 16 bytes
// of row r from k0 + 16 * half, gathered G bytes at a time.
template <int G>
__device__ __forceinline__ void load_a(const Conv& p, int8_t* dst, int k0,
                                       long long rbase, int t0, int h0,
                                       int w0) {
  int k = k0;
  if (k >= p.k) {  // past the contraction: zeros (K padding)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
  int tap = k / p.c, ci = k - tap * p.c;
  int kw_ = tap % p.kw, rest = tap / p.kw;
  int kh_ = rest % p.kh, kt_ = rest / p.kh;
  if constexpr (G == 1) {
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < p.k) {
        const int ti = t0 + kt_ * p.dt, hi = h0 + kh_ * p.dh,
                  wi = w0 + kw_ * p.dw;
        if ((unsigned)ti < (unsigned)p.t && (unsigned)hi < (unsigned)p.h &&
            (unsigned)wi < (unsigned)p.w) {
          const uint32_t b = (uint8_t)p.xq[rbase +
                                         (((long long)ti * p.h + hi) * p.w +
                                          wi) * p.c + ci];
          words[j >> 2] |= b << (8 * (j & 3));
        }
      }
      if (++ci == p.c) {
        ci = 0;
        if (++kw_ == p.kw) {
          kw_ = 0;
          if (++kh_ == p.kh) {
            kh_ = 0;
            ++kt_;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; j += G) {
      const int ti = t0 + kt_ * p.dt, hi = h0 + kh_ * p.dh,
                wi = w0 + kw_ * p.dw;
      const bool in = k + j < p.k && (unsigned)ti < (unsigned)p.t &&
                      (unsigned)hi < (unsigned)p.h &&
                      (unsigned)wi < (unsigned)p.w;
      const int8_t* src =
          in ? p.xq + rbase + (((long long)ti * p.h + hi) * p.w + wi) * p.c +
                   ci
             : p.xq;
      if constexpr (G == 16) {
        cp_async16(dst + j, src, in);
      } else {
        cp_async4(dst + j, src, in);
      }
      ci += G;
      if (ci == p.c) {
        ci = 0;
        if (++kw_ == p.kw) {
          kw_ = 0;
          if (++kh_ == p.kh) {
            kh_ = 0;
            ++kt_;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Conv p) {
  __shared__ __align__(16) int8_t sA[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sB[kStages][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // this thread's A row (tid / 2) and half (tid % 2), decoded once
  const int ar = tid >> 1, ahalf = tid & 1;
  long long rbase = 0;
  int t0 = INT_MIN / 4, h0 = 0, w0 = 0;  // t0 out of range: a zero row
  {
    int m = m0 + ar;
    if (m < p.m) {
      const int wo = m % p.wo;
      m /= p.wo;
      const int ho = m % p.ho;
      m /= p.ho;
      const int to = m % p.to;
      const int n = m / p.to;
      rbase = (long long)n * p.t * p.h * p.w * p.c;
      t0 = to * p.st - p.pt;
      h0 = ho * p.sh - p.ph;
      w0 = wo * p.sw_ - p.pw;
    }
  }
  auto load_stage = [&](int stage, int k0) {
    load_a<G>(p, &sA[stage][ar * kRow + ahalf * 16], k0 + ahalf * 16, rbase,
              t0, h0, w0);
    if (tid < kBN * 2) {
      const int r = tid >> 1, half = tid & 1, co = n0 + r;
      const bool in = co < p.co;
      const int8_t* src =
          in ? p.wq + (long long)co * p.kp + k0 + half * 16 : p.wq;
      cp_async16(&sB[stage][r * kRow + half * 16], src, in);
    }
    cp_commit();
  };

  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x 32
  const int g = lane >> 2, tg = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = p.kp / kBK;
  load_stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_stage((kc + 1) & 1, (kc + 1) * kBK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int8_t* a = sA[kc & 1];
    const int8_t* b = sB[kc & 1];
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(a + r * kRow + tg * 4);
      af[i][1] =
          *reinterpret_cast<const uint32_t*>(a + (r + 8) * kRow + tg * 4);
      af[i][2] =
          *reinterpret_cast<const uint32_t*>(a + r * kRow + 16 + tg * 4);
      af[i][3] = *reinterpret_cast<const uint32_t*>(a + (r + 8) * kRow + 16 +
                                                    tg * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wn * 32 + j * 8 + g;
      bfr[j][0] = *reinterpret_cast<const uint32_t*>(b + r * kRow + tg * 4);
      bfr[j][1] =
          *reinterpret_cast<const uint32_t*>(b + r * kRow + 16 + tg * 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    __syncthreads();  // the next step's load overwrites this stage
  }

  const float sx = p.sx_ptr != nullptr ? *p.sx_ptr : p.sx_val;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + j * 8 + tg * 2 + (e & 1);
        if (row >= p.m || col >= p.co) continue;
        const long long o = (long long)row * p.co + col;
        const int a = acc[i][j][e];
        if (p.acc != nullptr) p.acc[o] = a;
        const float y = __fmul_rn(__int2float_rn(a), __fmul_rn(sx, p.sw[col]));
        if (p.out_bf16) {
          reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
        } else {
          reinterpret_cast<float*>(p.out)[o] = y;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- K6
struct Act {
  const void* x;
  int8_t* q;
  float* scale_out;     // dynamic: where s goes
  unsigned* amax;       // dynamic: max |x| as float bits
  float scale_val;      // static scale
  int n, c, t, h, w;
  long long sn, sc, st, sh, sw;  // x's strides, elements
  int bf16, total;
  int dense;     // x fills its memory: pass one reads it in memory order
  int dense_cl;  // x in channels-last rows: element i at offset i
  int dense_nc;  // x contiguous (n, c, t, h, w): pass two transposes tiles
};

__device__ __forceinline__ float act_at(const Act& a, long long off) {
  return a.bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(a.x)[off])
                : reinterpret_cast<const float*>(a.x)[off];
}

// x at the channels-last index i = (((n * T + t) * H + h) * W + w) * C + c
__device__ __forceinline__ float act_load(const Act& a, int i) {
  const int c = i % a.c;
  i /= a.c;
  const int w = i % a.w;
  i /= a.w;
  const int h = i % a.h;
  i /= a.h;
  const int t = i % a.t;
  const int n = i / a.t;
  return act_at(a, n * a.sn + c * a.sc + t * a.st + h * a.sh + w * a.sw);
}

// max over the bits of |x| (fmaxf would drop a NaN)
__global__ void __launch_bounds__(256) absmax_kernel(const Act a) {
  unsigned m = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.total;
       i += gridDim.x * blockDim.x) {
    m = max(m, __float_as_uint(
                   fabsf(a.dense ? act_at(a, i) : act_load(a, i))));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, s));
  if ((threadIdx.x & 31) == 0) atomicMax(a.amax, m);
}

// s: the static scale, or max(amax / 127, 1e-12), NaN kept as
// torch.clamp_min keeps it, which the first thread of the grid stores
__device__ __forceinline__ float act_scale(const Act& a) {
  if (a.amax == nullptr) return a.scale_val;
  const float d = __fdiv_rn(__uint_as_float(*a.amax), 127.0f);
  const float s = isnan(d) ? d : fmaxf(d, 1e-12f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0)
    *a.scale_out = s;
  return s;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

__global__ void __launch_bounds__(256) quantize_kernel(const Act a) {
  const float s = act_scale(a);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.total;
       i += gridDim.x * blockDim.x) {
    a.q[i] = quantize(a.dense_cl ? act_at(a, i) : act_load(a, i), s);
  }
}

// x contiguous (n, c, sp), sp = (t, h, w): a 32 x 32 (c, sp) tile read
// along sp and written along c, through shared memory
__global__ void __launch_bounds__(256) quantize_nc_kernel(const Act a) {
  __shared__ float tile[32][33];
  const float s = act_scale(a);
  const int sp_n = a.t * a.h * a.w;
  const int sp0 = blockIdx.x * 32, c0 = blockIdx.y * 32, n = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int c = c0 + j, sp = sp0 + tx;
    if (c < a.c && sp < sp_n)
      tile[j][tx] = act_at(a, ((long long)n * a.c + c) * sp_n + sp);
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int sp = sp0 + j, c = c0 + tx;
    if (c < a.c && sp < sp_n)
      a.q[((long long)n * sp_n + sp) * a.c + c] = quantize(tile[tx][j], s);
  }
}

int grid_for(int total, int cap) {
  const int blocks = (total + 255) / 256;
  return blocks < cap ? blocks : cap;
}

}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// geom (25 ints): n, t, h, w, c, to, ho, wo, co, kt, kh, kw, st, sh, sw,
// dt, dh, dw, pt, ph, pw, kp, out_bf16, granularity (16, 4 or 1), unused.
// x (n, t, h, w, c) s8 rows, 16-byte aligned; w (co, kp) s8 rows; sw (co,)
// f32; sx on the device (dynamic) or null and sx_val; out (n, to, ho, wo,
// co) rows in f32 or bf16; acc the same rows in s32, or null.
int jmt_int8_conv(const void* x, const void* w, const void* sw,
                  const void* sx, float sx_val, void* out, void* acc,
                  const int* geom, void* stream) {
  Conv p = {};
  p.xq = (const int8_t*)x;
  p.wq = (const int8_t*)w;
  p.sw = (const float*)sw;
  p.sx_ptr = (const float*)sx;
  p.sx_val = sx_val;
  p.out = out;
  p.acc = (int32_t*)acc;
  p.n = geom[0], p.t = geom[1], p.h = geom[2], p.w = geom[3], p.c = geom[4];
  p.to = geom[5], p.ho = geom[6], p.wo = geom[7], p.co = geom[8];
  p.kt = geom[9], p.kh = geom[10], p.kw = geom[11];
  p.st = geom[12], p.sh = geom[13], p.sw_ = geom[14];
  p.dt = geom[15], p.dh = geom[16], p.dw = geom[17];
  p.pt = geom[18], p.ph = geom[19], p.pw = geom[20];
  p.kp = geom[21];
  p.out_bf16 = geom[22];
  const int gran = geom[23];
  p.k = p.kt * p.kh * p.kw * p.c;
  const long long m = (long long)p.n * p.to * p.ho * p.wo;
  const bool ok =
      p.n > 0 && p.c > 0 && p.co > 0 && p.kt > 0 && p.kh > 0 && p.kw > 0 &&
      p.to > 0 && p.ho > 0 && p.wo > 0 && p.kp % kBK == 0 && p.kp >= p.k &&
      p.c % gran == 0 && (gran == 16 || gran == 4 || gran == 1) &&
      (gran == 1 || ((uintptr_t)x % 16 == 0)) && (uintptr_t)w % 16 == 0 &&
      m * p.co < INT_MAX && (long long)p.n * p.t * p.h * p.w * p.c < INT_MAX;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  dim3 grid((p.m + kBM - 1) / kBM, (p.co + kBN - 1) / kBN);
  cudaStream_t st = (cudaStream_t)stream;
  if (gran == 16) {
    int8_conv_kernel<16><<<grid, kThreads, 0, st>>>(p);
  } else if (gran == 4) {
    int8_conv_kernel<4><<<grid, kThreads, 0, st>>>(p);
  } else {
    int8_conv_kernel<1><<<grid, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// dims (10 long longs): n, c, t, h, w, then x's strides in that order.
// q (n, t, h, w, c) s8 rows. dynamic: amax (one u32 of scratch) and
// scale_out (one f32) on the device; static: scale_val, both null.
// contiguous: x is (n, c, t, h, w) contiguous; channels_last: x is in
// channels-last rows. Either way pass one reads x in memory order.
int jmt_quantize_act(const void* x, void* q, void* scale_out, void* amax,
                     float scale_val, const long long* dims, int bf16,
                     int contiguous, int channels_last, void* stream) {
  Act a = {};
  a.x = x;
  a.q = (int8_t*)q;
  a.scale_out = (float*)scale_out;
  a.amax = (unsigned*)amax;
  a.scale_val = scale_val;
  a.n = (int)dims[0], a.c = (int)dims[1], a.t = (int)dims[2];
  a.h = (int)dims[3], a.w = (int)dims[4];
  a.sn = dims[5], a.sc = dims[6], a.st = dims[7], a.sh = dims[8];
  a.sw = dims[9];
  a.bf16 = bf16;
  a.dense = contiguous || channels_last;
  a.dense_cl = channels_last;
  a.dense_nc = contiguous && !channels_last && a.n <= 65535;
  const long long total = dims[0] * dims[1] * dims[2] * dims[3] * dims[4];
  const bool ok = total > 0 && total < INT_MAX &&
                  (amax == nullptr) == (scale_out == nullptr) &&
                  (amax != nullptr || scale_val > 0.0f);
  if (!ok) return (int)cudaErrorInvalidValue;
  a.total = (int)total;
  cudaStream_t st = (cudaStream_t)stream;
  if (amax != nullptr) {
    cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    absmax_kernel<<<grid_for(a.total, 132 * 8), 256, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.dense_nc) {
    const int sp_n = a.t * a.h * a.w;
    dim3 grid((sp_n + 31) / 32, (a.c + 31) / 32, a.n);
    quantize_nc_kernel<<<grid, dim3(32, 8), 0, st>>>(a);
  } else {
    quantize_kernel<<<grid_for(a.total, 132 * 16), 256, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
