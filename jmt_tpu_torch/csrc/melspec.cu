// Fused log-mel front end: (N, L) f32 audio -> (N, 64, T) f32 normalized
// log-mel, T = 1 + L / 441.
//
// Replaces the TPU kernel jmt_tpu/ops/pallas/melspec.py (log_mel_pallas,
// body _kernel). That kernel ran the 1024-point real DFT as two dense GEMMs
// against cos/sin matrices (the TPU has no FFT unit) and framed the audio
// outside the kernel (Mosaic needs 128-aligned loads; the hop is 441).
//
// What bounds it on an H100: at N = 128 it must read 23.3 MB of audio and
// write 3.4 MB (0.0080 ms at 3.35 TB/s) and do ~0.37 GFLOP of FFT and mel
// sums in fp32 (0.0055 ms at 67 TFLOP/s). The FFT's adds are not FMAs, and
// every butterfly, twiddle, transpose and mel tap is an instruction on
// registers or shared memory: what bounds this design is instruction issue
// and shared-memory traffic per frame pair, on the 16 warps (two CTAs of
// 128 registers a thread) an SM holds, not bytes of device memory.
//
// Design: one launch, one device operation per call.
// * Thread-block clusters of kCluster CTAs, one wav at a time per cluster:
//   CTA r owns frames [r F, r F + F), F = ceil(T / kCluster), 13 at the
//   served length, so N = 16 wavs already make 128 CTAs. The clusters stay
//   resident (the grid is as many clusters as fit, found once per device)
//   and walk the wavs; each CTA copies the constants (window, twiddles,
//   compact filterbank) into shared memory once, not once a wav.
// * Each CTA stages its audio window of a wav once, (F - 1) * 441 + 1024
//   samples, in shared memory with 16-byte cp.async, double-buffered: the
//   next wav's window lands while the current one is computed. The window's
//   global start need not be 16-byte aligned (a row is 182,396 B, 12 mod
//   16), so the copy starts at the first 16-byte boundary and the ragged
//   ends (at most 3 samples each) are scalar loads; nothing outside [0, L)
//   of the row is read. The window holds the padded signal: a CTA whose
//   window crosses an end of the wav stages the reflected samples (i < 0
//   -> -i, i >= L -> 2(L-1) - i) there by scalar loads, so framing from
//   shared memory is the same plain strided read for every frame.
// * One warp per frame pair, two real frames in one complex 1024-point FFT
//   (frame a real, frame b imaginary), entirely in registers with only
//   __syncwarp: lane n1 holds x[n1 + 32 n2] (32 points), a radix-32 DIF over
//   n2 in registers, the twiddle W1024^(n1 k2) from a (32 x 32) table, one
//   transpose through a warp-private 32 x 33 slab, then a radix-32 DIF over
//   n1: lane k2 ends holding X[k2 + 32 k1]. The two spectra are separated
//   with X_a[k] = (Z[k] + conj Z[N-k]) / 2, X_b[k] = (Z[k] - conj Z[N-k]) /
//   2i, Z[N-k] coming from lane (32 - k2) by shuffle.
// * The mel sum uses all 32 lanes: lanes 0-15 frame a, 16-31 frame b, each
//   lane one band of each of four slots of 16 (bands sorted by width, 996
//   nonzeros of 513 x 64). A slot's 16 bands run in step for its widest
//   band's count, from a slot-major table zero past each band's count, so
//   the warp does not diverge and lanes g and 16 + g share a weight read;
//   frame b's power sits 16 banks from frame a's.
// * The dB values stay in the CTA's (64 x F) tile. Each CTA reduces its max
//   and sends it to every rank of its cluster with st.async into
//   distributed shared memory, counted by the receiver's mbarrier; each CTA
//   then writes its tile once, floored at the wav's max - 80 dB and
//   normalized. No memset, no atomics, no second pass, no cluster-wide
//   memory fence a wav; the max is order-independent, so the output is
//   deterministic.
// * Everything is full fp32 (no TF32, no tensor cores): reduced-precision
//   f32 costs about 1e-2 dB, far outside the 5e-5 tolerance.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNFFT = 1024;
constexpr int kNFreq = kNFFT / 2 + 1;   // 513 one-sided bins
constexpr int kHop = 441;
constexpr int kNMels = 64;
constexpr int kCluster = 8;             // CTAs per wav (portable maximum)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFramesPerCta = 40;    // T <= 320
constexpr int kSlab = 32 * 33;          // one warp's transpose / power slab
constexpr int kPowerB = 528;            // frame b's power: 16 banks over
constexpr int kMelSlots = 4;            // bands a lane sums, one a slot
constexpr int kMaxFb = 1536;            // slot-major filterbank capacity
// hann (1024), twiddles (2 x 1024), filterbank table, (4, 64) meta
constexpr int kConsts = 3 * kNFFT + kMaxFb + 4 * kNMels;
constexpr float kAmin = 1e-10f;
constexpr float kTopDb = 80.0f;
constexpr float kSpecMean = -14.8f;
constexpr float kSpecStd = 19.895f;

// W32^j = exp(-2 pi i j / 32), j < 16
__constant__ float kCos32[16] = {
    1.000000000e+00f, 9.807852507e-01f, 9.238795042e-01f, 8.314695954e-01f,
    7.071067691e-01f, 5.555702448e-01f, 3.826834261e-01f, 1.950903237e-01f,
    0.0f, -1.950903237e-01f, -3.826834261e-01f, -5.555702448e-01f,
    -7.071067691e-01f, -8.314695954e-01f, -9.238795042e-01f,
    -9.807852507e-01f};
__constant__ float kSin32[16] = {  // -sin
    0.0f, -1.950903237e-01f, -3.826834261e-01f, -5.555702448e-01f,
    -7.071067691e-01f, -8.314695954e-01f, -9.238795042e-01f,
    -9.807852507e-01f, -1.000000000e+00f, -9.807852507e-01f,
    -9.238795042e-01f, -8.314695954e-01f, -7.071067691e-01f,
    -5.555702448e-01f, -3.826834261e-01f, -1.950903237e-01f};

__host__ __device__ constexpr int brev5(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) |
         ((i & 16) >> 4);
}

// Floats of one staged window of fpc frames: (fpc - 1) * hop + 1024
// samples and up to 3 of 16-byte phase, in whole 16-byte chunks.
__host__ __device__ constexpr int window_floats(int fpc) {
  return ((fpc - 1) * kHop + kNFFT + 3 + 3) / 4 * 4;
}

// One radix-2 DIF stage over blocks of S points of the 32 in registers.
template <int S>
__device__ __forceinline__ void dif_stage(float (&re)[32], float (&im)[32]) {
  constexpr int h = S / 2;
#pragma unroll
  for (int b = 0; b < 32; b += S) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const int i0 = b + j, i1 = b + j + h, w = j * (32 / S);
      const float ar = re[i0], ai = im[i0], cr = re[i1], ci = im[i1];
      re[i0] = ar + cr;
      im[i0] = ai + ci;
      const float dr = ar - cr, di = ai - ci;
      if (w == 0) {
        re[i1] = dr;
        im[i1] = di;
      } else if (w == 8) {  // times -i
        re[i1] = di;
        im[i1] = -dr;
      } else {
        re[i1] = dr * kCos32[w] - di * kSin32[w];
        im[i1] = dr * kSin32[w] + di * kCos32[w];
      }
    }
  }
}

// 32-point radix-2 DIF in registers: natural order in, re[i] = X[brev5(i)]
// out. Every index is a compile-time constant (the stages are template
// instances, so every loop has a constant trip count and unrolls), so the
// arrays stay in registers; the twiddles 1 and -i are applied exactly.
__device__ __forceinline__ void dif32(float (&re)[32], float (&im)[32]) {
  dif_stage<32>(re, im);
  dif_stage<16>(re, im);
  dif_stage<8>(re, im);
  dif_stage<4>(re, im);
  dif_stage<2>(re, im);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of this CTA's *p in the CTA of rank.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// A wait that has not ended after about 10 s at the H100's clock traps, so
// that a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Stage the padded window [lo, hi) of one wav at win[phase + p - lo],
// phase = (element address of sample lo) mod 4, so that 16-byte global
// chunks land on 16-byte shared addresses. The row's samples [max(lo, 0),
// min(hi, length)) come by cp.async, the at most 3 before the first chunk
// and after the last by scalar loads; reflect padding (p < 0 -> -p, p >=
// length -> 2(length-1) - p, no edge repeat) fills the rest by scalar loads,
// so only a window that crosses an end of the wav reflects, and only here.
__device__ __forceinline__ void stage_window(float* win, const float* row,
                                             int lo, int hi, int length,
                                             int tid) {
  const int el = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  float* w0 = win + ((el + lo) & 3);  // w0[p - lo] holds padded sample p
  const int a0 = max(lo, 0), a1 = min(hi, length);
  const int head = min((4 - ((el + a0) & 3)) & 3, a1 - a0);
  const int n_vec = (a1 - a0 - head) >> 2;
  const int tail = a0 + head + 4 * n_vec;
  for (int c = tid; c < n_vec; c += kThreads)
    cp_async16(w0 + (a0 + head + 4 * c - lo), row + a0 + head + 4 * c);
  if (tid < head) w0[a0 + tid - lo] = row[a0 + tid];
  if (tid < a1 - tail) w0[tail + tid - lo] = row[tail + tid];
  for (int p = lo + tid; p < 0; p += kThreads) w0[p - lo] = row[-p];
  for (int p = length + tid; p < hi; p += kThreads)
    w0[p - lo] = row[2 * (length - 1) - p];
}

// Grid (kCluster, G), clusters of kCluster along x, G <= N clusters that
// stay resident: cluster y takes wavs y, y + G, ... and prefetches the next
// wav's window while it computes the current one. hann: (1024,) padded
// window; tw: (32, 32) float2 W1024^(k2 n1) at [k2][n1]; fb_w: the
// filterbank table (nfb floats, a multiple of 4): for each slot j, a (len_j,
// 16) block whose column g holds the weights of slot 16 j + g's band, zero
// past its count; fb_meta: (4, 64): each slot's band, first bin and bin
// count, then len_j and the block offsets (lane g of a frame sums slots
// g, 16 + g, 32 + g, 48 + g). Dynamic shared memory:
// kWarps slabs, the constants (copied whole, once, from their 16-byte
// aligned tensors), the (64, fpc) dB tile, two windows of cap floats.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 2)
    log_mel_cluster(const float* __restrict__ audio, float* __restrict__ out,
                    const float* __restrict__ hann,
                    const float2* __restrict__ tw,
                    const float* __restrict__ fb_w,
                    const int* __restrict__ fb_meta, int nfb, int n,
                    int length, int n_frames, int fpc, int cap) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  // the ranks' maxes of a wav, by iteration parity, each delivered by
  // st.async and counted by the parity's mbarrier (32 bytes a phase)
  __shared__ float rank_max[2][kCluster];
  __shared__ __align__(8) uint64_t max_bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* slab = smem + warp * kSlab;
  float* s_hann = smem + kWarps * kSlab;
  float2* s_tw = reinterpret_cast<float2*>(s_hann + kNFFT);
  float* s_fbw = s_hann + 3 * kNFFT;
  int* s_meta = reinterpret_cast<int*>(s_fbw + kMaxFb);
  float* tile = reinterpret_cast<float*>(s_meta + 4 * kNMels);
  float* wins = tile + kNMels * fpc;

  const int t0 = rank * fpc;
  const int nf = max(0, min(n_frames - t0, fpc));
  // the CTA's padded window [lo, hi) of sample indices, the same for
  // every wav
  const int lo = t0 * kHop - kNFFT / 2;
  const int hi = (t0 + nf - 1) * kHop + kNFFT / 2;

  int wav = blockIdx.y;
  if (nf > 0) {
    for (int c = tid; c < kNFFT / 4; c += kThreads)
      cp_async16(s_hann + 4 * c, hann + 4 * c);
    for (int c = tid; c < kNFFT / 2; c += kThreads)
      cp_async16(s_tw + 2 * c, tw + 2 * c);
    for (int c = tid; c < kNMels; c += kThreads)
      cp_async16(s_meta + 4 * c, fb_meta + 4 * c);
    for (int c = tid; c < nfb / 4; c += kThreads)
      cp_async16(s_fbw + 4 * c, fb_w + 4 * c);
    stage_window(wins, audio + (size_t)wav * length, lo, hi, length, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&max_bar[p]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every rank's barriers exist before any st.async

  for (int it = 0; wav < n; wav += gridDim.y, ++it) {
    const float* row = audio + (size_t)wav * length;
    float* win = wins + (it & 1) * cap;
    const int next = wav + gridDim.y;
    if (nf > 0 && next < n)  // the other window was last read before the
                             // previous iteration's barriers
      stage_window(wins + ((it + 1) & 1) * cap,
                   audio + (size_t)next * length, lo, hi, length, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this wav's
    __syncthreads();

    const float* w0 =
        win + (((reinterpret_cast<uintptr_t>(row) >> 2) + lo) & 3);
    float local_max = -CUDART_INF_F;
    const int n_pairs = (nf + 1) / 2;
    for (int p = warp; p < n_pairs; p += kWarps) {
      const int fa = 2 * p;
      const bool has_b = fa + 1 < nf;
      const float* fa_x = w0 + fa * kHop + lane;  // frame a, n = lane
      const float* fb_x = has_b ? fa_x + kHop : fa_x;
      float re[32], im[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float w = s_hann[lane + 32 * r];
        re[r] = fa_x[32 * r] * w;
        im[r] = has_b ? fb_x[32 * r] * w : 0.0f;
      }
      dif32(re, im);  // re[i] = Y[n1 = lane][k2 = brev5(i)]
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k2 = brev5(i);
        if (k2 == 0) continue;
        const float2 w = s_tw[k2 * 32 + lane];
        const float r = re[i], m = im[i];
        re[i] = r * w.x - m * w.y;
        im[i] = r * w.y + m * w.x;
      }
      // transpose: lane k2 takes Y[n1][k2] for every n1, re then im
#pragma unroll
      for (int i = 0; i < 32; ++i) slab[brev5(i) * 33 + lane] = re[i];
      __syncwarp();
#pragma unroll
      for (int n1 = 0; n1 < 32; ++n1) re[n1] = slab[lane * 33 + n1];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) slab[brev5(i) * 33 + lane] = im[i];
      __syncwarp();
#pragma unroll
      for (int n1 = 0; n1 < 32; ++n1) im[n1] = slab[lane * 33 + n1];
      __syncwarp();
      dif32(re, im);  // re[i] = Z[lane + 32 brev5(i)]
      // split the two real spectra, |X|^2 into the slab: [0, 513) frame a,
      // [528, 1041) frame b. Z[N - k] lives in lane (32 - lane) & 31, at
      // k1' = 31 - k1 (lane 0: its own (32 - k1) & 31).
      const int partner = (32 - lane) & 31;
#pragma unroll
      for (int k1 = 0; k1 <= 16; ++k1) {
        const float zr = re[brev5(k1)], zi = im[brev5(k1)];
        float nr = __shfl_sync(0xffffffffu, re[brev5(31 - k1)], partner);
        float ni = __shfl_sync(0xffffffffu, im[brev5(31 - k1)], partner);
        if (lane == 0) {
          nr = re[brev5((32 - k1) & 31)];
          ni = im[brev5((32 - k1) & 31)];
        }
        const int k = lane + 32 * k1;
        if (k < kNFreq) {
          const float ar = 0.5f * (zr + nr), ai = 0.5f * (zi - ni);
          const float br = 0.5f * (zi + ni), bi = -0.5f * (zr - nr);
          slab[k] = ar * ar + ai * ai;
          slab[kPowerB + k] = br * br + bi * bi;
        }
      }
      __syncwarp();
      // sparse mel sum + dB: lane = (frame, g), one band of each slot j.
      // The warp runs len_j steps in step (weights past a band's count are
      // 0, its bin index stays on its last bin); lanes g and 16 + g read
      // one weight, and frame b's power sits 16 banks from frame a's.
      const int t = fa + (lane >> 4);
      if (t < nf) {
        const float* pw = slab + (lane >> 4) * kPowerB;
        const int g = lane & 15;
#pragma unroll
        for (int j = 0; j < kMelSlots; ++j) {
          const int slot = 16 * j + g;
          const int m = s_meta[slot], first = s_meta[kNMels + slot];
          const int last = s_meta[2 * kNMels + slot] - 1;
          const int len = s_meta[3 * kNMels + j];
          const float* wj = s_fbw + s_meta[3 * kNMels + kMelSlots + j] + g;
          float acc = 0.0f;
#pragma unroll 4
          for (int i = 0; i < len; ++i)
            acc = fmaf(wj[16 * i], pw[first + min(i, last)], acc);
          const float db = 10.0f * log10f(fmaxf(acc, kAmin));
          tile[m * fpc + t] = db;
          local_max = fmaxf(local_max, db);
        }
      }
      __syncwarp();  // the slab is rewritten by the warp's next pair
    }

    // CTA max, sent to every rank of the cluster by st.async into
    // rank_max[it & 1][rank]; each rank waits for the eight on its own
    // mbarrier. A rank sends iteration it + 2's max into the same slot only
    // after every rank has sent it + 1's, which each sends after reading
    // it's: no cluster-wide barrier is needed, and no memory fence.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      local_max = fmaxf(local_max, __shfl_xor_sync(0xffffffffu, local_max, o));
    if (lane == 0) red[warp] = local_max;
    __syncthreads();
    const int par = it & 1;
    if (warp == 0) {
      float m = red[0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_addr(&max_bar[par])),
            "r"(kCluster * 4)
            : "memory");
      if (lane < kCluster)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
            "%1, [%2];\n" ::"r"(cluster_addr(&rank_max[par][rank], lane)),
            "r"(__float_as_uint(m)), "r"(cluster_addr(&max_bar[par], lane))
            : "memory");
    }
    mbar_wait_cluster(&max_bar[par], (it >> 1) & 1);
    float fl = rank_max[par][0];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) fl = fmaxf(fl, rank_max[par][r]);
    fl -= kTopDb;
    float* o = out + (size_t)wav * kNMels * n_frames + t0;
    for (int e = tid; e < kNMels * nf; e += kThreads) {
      const int m = e / nf, j = e - m * nf;
      const float db = fmaxf(tile[m * fpc + j], fl);
      o[(size_t)m * n_frames + j] = (db - kSpecMean) / kSpecStd;
    }
  }
  // A rank leaves once it holds all eight maxes of its last wav: every
  // st.async to it has landed, and none comes later.
}

}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int jmt_mel_cluster() { return kCluster; }
int jmt_mel_max_frames_per_cta() { return kMaxFramesPerCta; }
int jmt_mel_slots() { return kMelSlots; }

// audio (n, length) f32; out (n, 64, n_frames) f32. One launch; returns
// cudaGetLastError() after it.
int jmt_log_mel(const float* audio, float* out, const float* hann,
                const float* tw, const float* fb_w, const int* fb_meta, int nfb,
                int n, int length, int n_frames, void* stream) {
  const int fpc = (n_frames + kCluster - 1) / kCluster;
  if (n < 1 || n > 65535 || length <= kNFFT / 2 || fpc > kMaxFramesPerCta ||
      nfb > kMaxFb || nfb % 4)
    return (int)cudaErrorInvalidValue;
  const int cap = window_floats(fpc);
  const size_t smem = sizeof(float) *
      (kWarps * kSlab + kConsts + kNMels * fpc + 2 * cap);
  // per device, once: the dynamic shared memory limit raised to the most
  // any call takes; then, per shared-memory size, how many clusters stay
  // resident (the grid's height)
  static bool raised[64];
  static size_t smem_of[64];
  static int clusters_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    const size_t most = sizeof(float) *
        (kWarps * kSlab + kConsts + kNMels * kMaxFramesPerCta +
         2 * window_floats(kMaxFramesPerCta));
    e = cudaFuncSetAttribute(log_mel_cluster,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)most);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  if (smem_of[dev] != smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, log_mel_cluster, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    smem_of[dev] = smem;
    clusters_of[dev] = clusters;
  }
  log_mel_cluster<<<dim3(kCluster, min(n, clusters_of[dev])), kThreads,
                    smem, (cudaStream_t)stream>>>(
      audio, out, hann, reinterpret_cast<const float2*>(tw), fb_w, fb_meta,
      nfb, n, length, n_frames, fpc, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
