// K4's bf16 kernel for Hopper (pool1x1.cu): out = maxpool3x3x3(x) . k,
// the pool stride 1, SAME, padded with -inf; f32 accumulation, cast to
// bf16. x (N, T, H, W, C) channels-last rows of any sign, k (C, Co).
//
// What bounds it on an H100: bytes. Each input byte has to come from HBM
// about once and each output byte go out once; the product is 2-10x under
// that (5 to 15 flops a byte).
//
// The design. A work item is a pair of output planes (t0, t0 + 1) of one
// clip, a band of 4 rows of H and 14 columns of W (64 rows of A a plane),
// and a column tile of Co. A block is three warpgroups,
// persistent (one per SM, items blockIdx.x, + gridDim.x, ...),
// warp-specialised:
// - producer (thread 0 of warpgroup 0): for each 64-channel chunk of C, one
//   5-D TMA box of x, planes t0-1..t0+2, rows h0-1..h0+4, columns
//   w0-1..w0+14 (the halo, 128-byte swizzle: a position's 16-byte chunk j
//   lies at j ^ (position & 7)), and TMA boxes of the chunk's 64 rows of k
//   (64 x 64, 128-byte swizzle, N-major), into a ring of 2-4 stages on
//   mbarriers. Four planes serve two outputs, so the halo moves 2x the
//   planes, not 3x; neighbouring items re-read it from L2, not HBM. TMA
//   fills past the map with zeros, never -inf, so the pool masks positions
//   past the map by index; channels past C stay zero, as do k's rows past
//   C, so the last chunk's products add nothing;
// - two consumer warpgroups, output plane t0 + cw each. Each pools its
//   plane straight from the halo, separably: a thread owns a column and a
//   chunk, takes the max over the three planes (T), then over a window of
//   three of its six rows (H), both in registers, every load's address a
//   constant off the lane's own, then over its neighbours' (W, by warp
//   shuffles within a segment of 16 lanes, on the four output rows only).
//   It writes the pooled rows into
//   a 128-byte-swizzled K-major A tile of 64 rows (two, alternating) and
//   runs wgmma m64nNk16 on it against the stage's k, N the column tile's
//   width (Co itself for Co in 8, 16, 32, 64, 128, 192, 256; else the next
//   of those), while the previous chunk's products are still in flight;
// - the epilogue stages 16 x 16 bf16 per warp in a patch and writes
//   16-byte vectors of the output rows, while the producer already fills
//   the ring for the block's next item.
// The warpgroups never wait on each other: each pools only its own rows
// and frees a stage (one arrival per warp) once its products of it are
// done.
#pragma once

#include "igemm_sm90.cuh"

namespace {
namespace sm90 {

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace sm90

namespace k4 {

using namespace sm90;

constexpr int kThreads = 384;
constexpr int kSmemBytes = 232448;  // the most a block may have
constexpr int kATile = 128 * 128;   // 2 x 64 rows x 64 bf16
constexpr int kMaxStages = 4;
constexpr int kRingBytes =
    (kSmemBytes - 1024 - 2 * kATile - 2 * kMaxStages * 8) / 1024 * 1024;
constexpr int kSegW = 16;           // halo columns: a segment of lanes
constexpr int kWb = kSegW - 2;      // output columns of a W band
constexpr int kHb = 64 / kSegW;     // output rows of an H band
constexpr int kNb = kHb + 2;        // halo rows
constexpr int kPlanes = 4;          // a halo box: planes t0 - 1 .. t0 + 2
constexpr int kHaloBytes = kPlanes * kNb * kSegW * 128;
// bring-up switches (tools/k4_phases.py takes a phase out through them)
constexpr bool kPool = true;
constexpr bool kMma = true;

struct Geom {
  int n, t, h, w, c, co;
  int nwb, nhb, ntp;  // bands of W and H, pairs of output planes
  int nw, col_tiles;  // column tile width (the wgmma's N), tiles
  int nk;             // 64-channel chunks of C
  int stage_bytes, nstages, nboxes;
  long long items;    // bands x plane pairs x column tiles
};

struct Launch4 {
  CUtensorMap xmap;  // x as (C, W, H, T, N), box (64, 16, 6, 4, 1)
  CUtensorMap bmap;  // k as (C, Co), box 64 x 64
  Geom g;
  bf16* out;
};

// A work item: planes t0 and t0 + 1 of clip n, rows h0.. and columns w0..
// of a band, columns n0.. of the output.
struct Item {
  int n, t0, h0, w0, n0;
};

__device__ __forceinline__ Item item_at(const Geom& g, long long item) {
  Item it;
  const int col = (int)(item % g.col_tiles);
  long long s = item / g.col_tiles;
  const int wi = (int)(s % g.nwb);
  s /= g.nwb;
  const int hi = (int)(s % g.nhb);
  s /= g.nhb;
  it.t0 = 2 * (int)(s % g.ntp);
  it.n = (int)(s / g.ntp);
  it.h0 = hi * kHb;
  it.w0 = wi * kWb;
  it.n0 = col * g.nw;
  return it;
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  v.x = __shfl_sync(0xffffffffu, v.x, src);
  v.y = __shfl_sync(0xffffffffu, v.y, src);
  v.z = __shfl_sync(0xffffffffu, v.z, src);
  v.w = __shfl_sync(0xffffffffu, v.w, src);
  return v;
}

// Thread 0 of warpgroup 0: per item and chunk, wait until the stage is
// free, then the halo box (planes t0 - 1 .. t0 + 2) and k's boxes,
// completing on the stage's full barrier.
__device__ __forceinline__ void produce(const Launch4& P, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty) {
  const Geom& g = P.g;
  uint32_t it = 0;
  for (long long item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item at = item_at(g, item);
    for (int kc = 0; kc < g.nk; ++kc, ++it) {
      const int s = it % g.nstages;
      const uint32_t round = it / g.nstages;
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
      unsigned char* st = ring + s * g.stage_bytes;
      mbar_expect_tx(&full[s], kHaloBytes + g.nboxes * kChunkBytes);
      tma_load_5d(smem_addr(st), &P.xmap, &full[s], kc * 64, at.w0 - 1,
                  at.h0 - 1, at.t0 - 1, at.n);
      for (int j = 0; j < g.nboxes; ++j)
        tma_load_2d(smem_addr(st + kHaloBytes + j * kChunkBytes), &P.bmap,
                    &full[s], at.n0 + 64 * j, kc * 64);
    }
  }
}

// Consumer warpgroup cw's pool of one chunk: output plane t0 + cw from box
// planes cw .. cw + 2 of the halo at `halo` into its 64-row A tile at `a`,
// row hr * 16 + c for output row h0 + hr, column w0 + c (c < 14; rows 14
// and 15 of each 16 are left as they are and dropped by the epilogue).
// Lane l of a 16-lane segment is halo column w0 - 1 + l, the segment's
// chunk j = 2 warp + segment. Positions are 16 apart in a row and 96 in a
// plane, so a lane's swizzle is l & 7 throughout and every address is the
// lane's base plus a constant: the six rows' 18 loads issue together.
__device__ __forceinline__ void pool_rows(const Geom& g, const Item& at,
                                          int cw, const unsigned char* halo,
                                          unsigned char* a) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int l = lane & 15, j = 2 * (tid >> 5) + (lane >> 4);
  const int w = at.w0 - 1 + l, t = at.t0 + cw;
  const bool wok = w >= 0 && w < g.w;
  bool tok[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) tok[p] = t - 1 + p >= 0 && t - 1 + p < g.t;
  const unsigned char* col =
      halo + (cw * kNb * kSegW + l) * 128 + ((j ^ (l & 7)) << 4);
  const uint32_t neg = 0xFF80FF80u;  // two bf16 -inf
  const uint4 ninf = make_uint4(neg, neg, neg, neg);
  uint4 tm[kNb];
#pragma unroll
  for (int b = 0; b < kNb; ++b) {  // T: the three planes
    const int h = at.h0 - 1 + b;
    tm[b] = ninf;
    if (wok && h >= 0 && h < g.h) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
        if (tok[p])
          tm[b] = vmax<bf16>(tm[b], *reinterpret_cast<const uint4*>(
                                        col + (p * kNb + b) * kSegW * 128));
    }
  }
  uint4 hm[kHb];
#pragma unroll
  for (int hr = 0; hr < kHb; ++hr)  // H: the window of three rows
    hm[hr] = vmax<bf16>(vmax<bf16>(tm[hr], tm[hr + 1]), tm[hr + 2]);
  uint4 v[kHb];
#pragma unroll
  for (int hr = 0; hr < kHb; ++hr) {  // W: the neighbours' columns
    const uint4 lf = shfl4(hm[hr], lane - 1), rt = shfl4(hm[hr], lane + 1);
    v[hr] = vmax<bf16>(vmax<bf16>(lf, hm[hr]), rt);
  }
  if (l < 1 || l > kWb) return;
  const bool col_in_map = w < g.w;  // output column w0 + l - 1 = w
  unsigned char* row = a + (l - 1) * 128 + ((j ^ ((l - 1) & 7)) << 4);
#pragma unroll
  for (int hr = 0; hr < kHb; ++hr) {
    const bool in_map = col_in_map && at.h0 + hr < g.h;
    *reinterpret_cast<uint4*>(row + hr * kSegW * 128) =
        in_map ? v[hr] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A warp's 16 rows of the product (output row h0 + warp), 16 columns at a
// time through its patch (row lane / 4 and + 8, columns 8 i + 2 (lane % 4)
// + 0, 1 of the wgmma fragment), out as 16-byte vectors: lane / 2 the row,
// lane % 2 the eight columns.
template <int NW>
__device__ __forceinline__ void epilogue(const Launch4& P, const Item& at,
                                         int t, const float* acc,
                                         bf16* patch) {
  const Geom& g = P.g;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int c = lane >> 1, h = at.h0 + warp, w = at.w0 + c;  // row 16 warp + c
  const bool row_ok = c < kWb && h < g.h && w < g.w;
  const size_t row = (((size_t)at.n * g.t + t) * g.h + h) * g.w + w;
#pragma unroll
  for (int i2 = 0; i2 < NW / 8; i2 += 2) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i2 + hh;
      if (i < NW / 8) {
        bf16* e = patch + (lane >> 2) * 24 + 8 * hh + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(e) =
            __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(e + 8 * 24) =
            __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
    __syncwarp();
    const int grp = i2 + (lane & 1), col = at.n0 + 8 * grp;
    if (row_ok && grp < NW / 8 && col < g.co)
      *reinterpret_cast<uint4*>(P.out + row * g.co + col) =
          *reinterpret_cast<const uint4*>(patch + (lane >> 1) * 24 +
                                          8 * (lane & 1));
    __syncwarp();
  }
}

// Consumer warpgroup cw: output plane t0 + cw of every item, its 64-row A
// tiles at rows 64 cw of the two shared tiles. Pools chunk kc into A tile
// kc & 1 while chunk kc - 1's products run; the group that read that tile
// (kc - 2) is done by then (wait_group 1 after each commit).
template <int NW>
__device__ __forceinline__ void consume(const Launch4& P, unsigned char* atile,
                                        unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int cw) {
  const Geom& g = P.g;
  // the epilogue's patch: in this warpgroup's rows of A tile 1, which no
  // wgmma reads by then (wait_group 0) and the next item's pool writes only
  // after the barrier of its chunk 0
  bf16* patch = reinterpret_cast<bf16*>(atile + kATile + cw * 64 * 128) +
                ((threadIdx.x >> 5) & 3) * kPatch;
  const bool leader = (threadIdx.x & 31) == 0;
  const uint32_t a_base = smem_addr(atile) + cw * 64 * 128;
  const uint32_t r_base = smem_addr(ring);
  uint32_t it = 0;
  for (long long item = blockIdx.x; item < g.items; item += gridDim.x) {
    const Item at = item_at(g, item);
    const bool active = at.t0 + cw < g.t;  // T odd: the last pair is one
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    int prev = 0;
    for (int kc = 0; kc < g.nk; ++kc, ++it) {
      const int s = it % g.nstages;
      mbar_wait(&full[s], (it / g.nstages) & 1);
      if (active) {
        const int ab = (kc & 1) * kATile;
        if (kPool) {
          pool_rows(g, at, cw, ring + s * g.stage_bytes,
                    atile + ab + cw * 64 * 128);
        }
        fence_proxy_async();  // generic stores, read by wgmma
        named_sync(2 + cw, 128);
        if (kMma) {
          const uint32_t st = r_base + s * g.stage_bytes + kHaloBytes;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma<NW>(acc, gmma_desc(a_base + ab + 32 * kk, 16, 1024),
                      gmma_desc(st + 2048 * kk, kChunkBytes, 1024), 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        }
      }
      if (kc > 0 && leader) mbar_arrive(&empty[prev]);
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (leader) mbar_arrive(&empty[prev]);
    if (active) epilogue<NW>(P, at, at.t0 + cw, acc, patch);
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads, 1)
pool1x1_sm90(const __grid_constant__ Launch4 P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* atile =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = atile + 2 * kATile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // 128 x 56 + 256 x 224 registers: the 384 x 168 the block holds at launch
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) produce(P, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    consume<NW>(P, atile, ring, full, empty, wg - 1);
  }
}

// Bands of 14 columns of W and 4 rows of H (64 rows of A a plane), pairs
// of planes, column tiles of at most 256; as many stages as the ring holds
// (2 to 4).
Geom geometry(int n, int t, int h, int w, int c, int co) {
  Geom g;
  g.n = n;
  g.t = t;
  g.h = h;
  g.w = w;
  g.c = c;
  g.co = co;
  g.nwb = (w + kWb - 1) / kWb;
  g.nhb = (h + kHb - 1) / kHb;
  g.ntp = (t + 1) / 2;
  g.col_tiles = (co + 255) / 256;
  const int per = (co + g.col_tiles - 1) / g.col_tiles;
  const int widths[] = {8, 16, 32, 64, 128, 192, 256};
  g.nw = 256;
  for (int x : widths)
    if (x >= per) {
      g.nw = x;
      break;
    }
  g.nboxes = (g.nw + 63) / 64;
  g.nk = (c + 63) / 64;
  g.stage_bytes = kHaloBytes + g.nboxes * kChunkBytes;
  g.nstages = kRingBytes / g.stage_bytes;
  if (g.nstages > kMaxStages) g.nstages = kMaxStages;
  g.items = (long long)n * g.ntp * g.nhb * g.nwb * g.col_tiles;
  return g;
}

// x as a 5-D map (C, W, H, T, N), boxes of 64 channels and the halo of a
// strip, 128-byte swizzle, zeros outside the map.
int encode_x(CUtensorMap* map, const void* x, const Geom& g) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int e = tensor_map_encoder(&encode);
  if (e != 0) return e;
  const cuuint64_t row = (cuuint64_t)g.c * sizeof(bf16);
  cuuint64_t dims[5] = {(cuuint64_t)g.c, (cuuint64_t)g.w, (cuuint64_t)g.h,
                        (cuuint64_t)g.t, (cuuint64_t)g.n};
  cuuint64_t strides[4] = {row, row * g.w, row * g.w * g.h,
                           row * g.w * g.h * g.t};
  cuuint32_t box[5] = {64, kSegW, kNb, kPlanes, 1};
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NW>
int launch_nw(const Launch4& P, cudaStream_t stream) {
  // per device, once: the raised shared memory limit (the attribute holds
  // for the current device only) and the SM count, one persistent block
  // per SM
  static bool attr_set[64];
  static int sms_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(pool1x1_sm90<NW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  const int sms = sms_of[dev];
  const long long blocks = P.g.items < sms ? P.g.items : sms;
  pool1x1_sm90<NW><<<(int)blocks, kThreads, kSmemBytes, stream>>>(P);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* k, void* out, int n, int t, int h,
           int w, int c, int co, cudaStream_t stream) {
  Launch4 P;
  memset(&P, 0, sizeof(P));
  P.g = geometry(n, t, h, w, c, co);
  P.out = static_cast<bf16*>(out);
  int e = encode_x(&P.xmap, x, P.g);
  if (e == 0) e = encode_b(&P.bmap, k, c, co);
  if (e != 0) return e;
  switch (P.g.nw) {
    case 8: return launch_nw<8>(P, stream);
    case 16: return launch_nw<16>(P, stream);
    case 32: return launch_nw<32>(P, stream);
    case 64: return launch_nw<64>(P, stream);
    case 128: return launch_nw<128>(P, stream);
    case 192: return launch_nw<192>(P, stream);
    default: return launch_nw<256>(P, stream);
  }
}

}  // namespace k4
}  // namespace
