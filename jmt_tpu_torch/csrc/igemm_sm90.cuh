// The Hopper implicit GEMM of the inception module's bf16 launches (K3,
// inception.cu). Rows of A are (n, t, h, w) positions of a channels-last
// map, gathered while a tile is written into shared memory (1x1 rows,
// 3x3x3 taps, pool_in's pooled rows), against a dense (K, ncols) bf16
// weight matrix B, with f32 accumulation on the tensor cores. The f32
// launches stay on implicit_gemm.cuh. K4's bf16 kernel (pool1x1_sm90.cuh)
// reuses its barriers, TMA, descriptors and wgmma.
//
// What bounds it on an H100: the tensor cores at full rate (K3 is about
// 4.8 TFLOP a bucket-8 forward), unless the gathers of A and the barrier
// round trip of each 64-deep stage are not hidden; measured, they were the
// limit at every step of this design (PERF.md).
//
// A block is three warpgroups, warp-specialised:
// - warpgroup 0, the producer (setmaxnreg down to 104 registers), fills a
//   ring of stages in shared memory: B by TMA (cp.async.bulk.tensor.2d,
//   64 x 64 boxes, 128-byte swizzle, zero fill past K and ncols, completion
//   on the stage's full mbarrier with expect_tx), A by its 128 threads:
//   16-byte cp.async with zero fill (src-size 0: the SAME padding, a K past
//   the problem's depth) for 1x1 rows and 3x3x3 taps; pool_in's window max
//   taken in registers and stored into the same 128-byte-swizzled layout;
//   each thread arrives on the same mbarrier when its part has landed;
// - warpgroups 1 and 2, the consumers (setmaxnreg up to 200), run
//   wgmma.mma_async m64nNk16 bf16 -> f32 on shared-memory descriptors (A
//   K-major, B N-major, both 128-byte swizzle), keep one wgmma group in
//   flight, and free a stage on its empty mbarrier (one arrival per warp)
//   when the group that read it is done.
//
// A stage is 64 deep in K (one 128-byte swizzle row of A), so a K tile
// crosses taps when a branch has 16, 24 or 48 channels; every channel count
// is a multiple of 8, so a 16-byte vector never does. The ring holds 3
// stages of the widest tile (72 KB) and up to 8 of narrower ones.
//
// Tiling, per problem: up to 256 columns, both consumers take the same
// columns over 64 rows each (128 x N); above, they share 64 rows and take
// a column half each (64 x 2N), so one block covers up to 512 columns and
// pool_in's pre-pool window is gathered once per row (Mixed_3b N = 176,
// 4b 304, 5b 448). Mixed_5c's N = 624 takes two column tiles of 384.
// N is 64, 128, 192 or 256 per consumer; TMA zero-fills the columns past
// ncols and the epilogue drops them.
//
// Epilogue, while the producer already fills the ring for the block's next
// tile: bias, the round-before-relu rule of Seg::round_first and relu in
// registers; each warp stages 16 x 16 bf16 at a time in a patch of its own
// (outside the ring, which the producer is filling) and writes 16-byte
// rows into the channel-concat layout; for
// avg_tail the f32 sums of each (n, t) over a warp's 16 rows are reduced
// across its lanes and stored into the slot of that (n, t) and 16-row
// block (avg_slots: each (block, column) has one owning warp, so no slot
// has two writers).
//
// Persistent: one block per SM walks the launch's tile list (blockIdx.x,
// + gridDim.x, ...) over up to three problems in problem order; the ring
// and its barrier phases run on from tile to tile, and change geometry
// (after a drain) only where the problem changes. The second launch puts
// b1b's tiles (K = 27 o1, the longest) first, so every block starts on
// them and the short b2b and b3 tiles fill in behind.
#pragma once

#include <string.h>

#include "implicit_gemm.cuh"
#include "sm90_common.cuh"

namespace {
namespace sm90 {

constexpr int kBK = 64;                 // K of a stage: 128 bytes of bf16
constexpr int kThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kStageMax = 72 * 1024;    // 8 KB A + 64 KB B, or 16 + 32
constexpr int kPipeBytes = 3 * kStageMax;
constexpr int kMaxStages = 8;
constexpr int kChunkBytes = kBK * 128;  // one 64-column box of B
constexpr int kPatch = 16 * 24;  // a warp's epilogue patch: 16 x 16 bf16,
                                 // rows 48 bytes apart (no bank conflicts)
constexpr int kSmemBytes = kPipeBytes + 1024 + 2 * kMaxStages * 8 + 128 * 16 +
                           8 * kPatch * 2;

// Per problem: consumer width nw (64..256), wide (both consumers on 64
// rows, nw columns each) or tall (128 rows, the same nw columns), tiles.
struct Tiling {
  int nw, wide, row_tiles, col_tiles, first_tile;
};

struct Launch90 {
  CUtensorMap tmap[kMaxProb];  // B of each problem: (K, ncols) bf16
  Launch L;
  Tiling tl[kMaxProb];
  int ntiles;
};

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<192>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The (problem, tile) of tile index `tile`: the tiles of problem 0 first,
// then 1, then 2; within a problem row tiles by column tiles.
struct TileAt {
  int prob, m0, n0, col_tile, rows_tile, width;
};

__device__ __forceinline__ TileAt tile_at(const Launch90& P, int tile) {
  int pi = 0;
  while (pi + 1 < P.L.nprob && tile >= P.tl[pi + 1].first_tile) ++pi;
  const Tiling& t = P.tl[pi];
  const int local = tile - t.first_tile;
  TileAt a;
  a.prob = pi;
  a.col_tile = local % t.col_tiles;
  a.rows_tile = t.wide ? 64 : 128;
  a.width = t.wide ? 2 * t.nw : t.nw;
  a.m0 = (local / t.col_tiles) * a.rows_tile;
  a.n0 = a.col_tile * a.width;
  return a;
}

// Per row of the tile, once: its index (-1 past the rows) and a mask of the
// gather positions that lie in the map, bit dt * 9 + dh * 3 + dw. For the
// 3x3x3 taps (offsets dt - 1, dh - 1, dw - 1) bit 13 is the row itself,
// which 1x1 rows test too; for pool_in's window the positions are t0 + dt,
// 2h + dh, 2w + dw of the pre-pool map from pre, its first position's
// pre-pool row.
struct RowMask {
  int row, mask, pre, pad;
};

__device__ __forceinline__ RowMask row_mask(const Launch& L, bool pool_in,
                                            int row) {
  RowMask m = {-1, 0, 0, 0};
  if (row >= L.rows) return m;
  const int w = row % L.w, h = (row / L.w) % L.h, t = (row / (L.h * L.w)) % L.t;
  m.row = row;
  if (pool_in) {
    const int hp = 2 * L.h, wp = 2 * L.w;
    const int t0 = t - (L.pool_kt - 1) / 2;
    m.pre = ((row / (L.h * L.w) - t + t0) * hp + 2 * h) * wp + 2 * w;
    for (int dt = 0; dt < L.pool_kt; ++dt)
      for (int dh = 0; dh < L.pool_k; ++dh)
        for (int dw = 0; dw < L.pool_k; ++dw)
          if (t0 + dt >= 0 && t0 + dt < L.t && 2 * h + dh < hp &&
              2 * w + dw < wp)
            m.mask |= 1 << (dt * 9 + dh * 3 + dw);
  } else {
    for (int dt = 0; dt < 3; ++dt)
      for (int dh = 0; dh < 3; ++dh)
        for (int dw = 0; dw < 3; ++dw)
          if (t + dt - 1 >= 0 && t + dt - 1 < L.t && h + dh - 1 >= 0 &&
              h + dh - 1 < L.h && w + dw - 1 >= 0 && w + dw - 1 < L.w)
            m.mask |= 1 << (dt * 9 + dh * 3 + dw);
  }
  return m;
}

// One role's view of the ring. Each problem has its own stage size (A's
// rows x 128 bytes + B's boxes), so its own number of stages; when a block
// moves on to the next problem the producer first waits until every stage
// it filled is free again, and both roles restart at stage 0. The phase
// each stage's barrier is waited on next is kept per stage (parity), so it
// carries over any change of geometry.
struct Ring {
  int prob, stage, nstages, stage_bytes;
  uint32_t parity;   // bit s: parity of the next phase to wait for on s
  uint32_t pending;  // producer: stages filled and not yet seen free
};

__device__ __forceinline__ void ring_enter(Ring& r, const Launch90& P,
                                           const TileAt& at) {
  r.prob = at.prob;
  r.stage = 0;
  r.stage_bytes = at.rows_tile * 128 + at.width / 64 * kChunkBytes;
  r.nstages = kPipeBytes / r.stage_bytes;
  r.nstages = r.nstages < kMaxStages ? r.nstages : kMaxStages;
}

// Warpgroup 0: B by TMA (thread 0), A by the 128 threads. Thread tid
// gathers chunk c = tid % 8 of rows tid / 8 + 16 i (the same K offset for
// all of them, and a warp's 16-byte loads over four neighbouring rows),
// stored at chunk c ^ (row % 8) of each 128-byte row: the 128-byte
// swizzle. A thread arrives on the stage's full barrier when its
// cp.asyncs have landed (cp.async.mbarrier.arrive.noinc), or after its
// shared-memory stores and a proxy fence. Modes: kGemm1x1 (with pool_in
// the window's max) and kConv3x3x3; inception.cu runs b3's pool as a
// pass of its own.
__device__ __forceinline__ void produce(const Launch90& P, const TileAt& at,
                                        unsigned char* pipe, uint64_t* full,
                                        uint64_t* empty, RowMask* rows,
                                        Ring& ring, int nk) {
  const Launch& L = P.L;
  const Problem& p = L.p[at.prob];
  const int tid = threadIdx.x;
  const bool pool_in = L.pool_k > 0 && p.mode == kGemm1x1;
  if (at.prob != ring.prob) {  // drain, then this problem's geometry
    for (int s = 0; s < kMaxStages; ++s)
      if ((ring.pending >> s) & 1) {
        mbar_wait(&empty[s], (ring.parity >> s) & 1);
        ring.parity ^= 1u << s;
      }
    ring.pending = 0;
    ring_enter(ring, P, at);
  }
  const int a_bytes = at.rows_tile * 128;
  named_sync(1, 128);  // the previous tile's gathers are done with rows
  rows[tid] = tid < at.rows_tile ? row_mask(L, pool_in, at.m0 + tid)
                                 : RowMask{-1, 0, 0, 0};
  named_sync(1, 128);
  const int nchunks = at.width / 64;
  const bf16* a = static_cast<const bf16*>(p.a) + p.aoff;
  const int loads = at.rows_tile * 8 / 128;
  const int c = tid & 7, r0 = tid >> 3;
  const int hw = L.h * L.w, wp = 2 * L.w, hwp = 4 * hw;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = ring.stage;
    ring.stage = s + 1 == ring.nstages ? 0 : s + 1;
    if ((ring.pending >> s) & 1) {  // wait until the consumers freed it
      mbar_wait(&empty[s], (ring.parity >> s) & 1);
      ring.parity ^= 1u << s;
    }
    ring.pending |= 1u << s;
    unsigned char* st = pipe + s * ring.stage_bytes;
    if (tid == 0) {
      mbar_expect_tx(&full[s], nchunks * kChunkBytes);
      for (int j = 0; j < nchunks; ++j)
        tma_load_2d(smem_addr(st + a_bytes + j * kChunkBytes),
                    &P.tmap[at.prob], &full[s], at.n0 + 64 * j, kt * kBK);
    }
    const int k = kt * kBK + 8 * c;
    const bool kin = k < p.k;
    // kConv3x3x3: tap k / cin at row offset nb, channel ch
    int tap = 13, ch = k, nb = 0;
    if (p.mode == kConv3x3x3) {
      tap = k / p.cin;
      ch = k - tap * p.cin;
      nb = ((tap / 9 - 1) * L.h + (tap / 3) % 3 - 1) * L.w + tap % 3 - 1;
    }
    for (int i = 0; i < loads; ++i) {
      const int r = r0 + 16 * i;
      const uint32_t dst = smem_addr(st + r * 128 + ((c ^ (r & 7)) << 4));
      const RowMask m = rows[r];
      if (pool_in) {  // the pre-pool window's max, zero padding
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (kin && m.row >= 0) {
          for (int dt = 0; dt < L.pool_kt; ++dt)
            for (int dh = 0; dh < L.pool_k; ++dh)
              for (int dw = 0; dw < L.pool_k; ++dw)
                if ((m.mask >> (dt * 9 + dh * 3 + dw)) & 1)
                  x = vmax<bf16>(
                      x, ldg16(a + (size_t)(m.pre + dt * hwp + dh * wp + dw) *
                                       p.lda + k));
          if (at.col_tile == 0)  // b3 reads the pooled rows back
            *reinterpret_cast<uint4*>(static_cast<bf16*>(p.pool_dst) +
                                      (size_t)m.row * p.cin + k) = x;
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                     "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
                     : "memory");
      } else {  // 1x1 rows and 3x3x3 taps: cp.async, zero fill
        const bool ok = kin && ((m.mask >> tap) & 1);
        cp_async16(dst, ok ? a + (size_t)(m.row + nb) * p.lda + ch : a, ok);
      }
    }
    if (pool_in) {
      fence_proxy_async();  // generic-proxy stores, read by wgmma
      mbar_arrive(&full[s]);
    } else {
      cp_async_arrive(&full[s]);
    }
  }
}

// Consumer warpgroup cw (0 or 1): 64 rows x NW columns of the tile.
template <int NW>
__device__ __forceinline__ void consume(const Launch90& P, const TileAt& at,
                                        unsigned char* pipe, uint64_t* full,
                                        uint64_t* empty, Ring& ring, int nk,
                                        int cw, bf16* patch) {
  const bool wide = at.width > NW;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
  if (at.prob != ring.prob) ring_enter(ring, P, at);
  const uint32_t a_off = wide ? 0 : cw * 64 * 128;
  const uint32_t b_off =
      at.rows_tile * 128 + (wide ? cw * (NW / 64) * kChunkBytes : 0);
  const uint32_t base = smem_addr(pipe);
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = 0;  // the stage of the previous k tile
  for (int kt = 0; kt < nk; ++kt) {
    const int s = ring.stage;
    ring.stage = s + 1 == ring.nstages ? 0 : s + 1;
    mbar_wait(&full[s], (ring.parity >> s) & 1);
    ring.parity ^= 1u << s;
    fence_proxy_async();  // the cp.async writes, read by wgmma
    const uint32_t st = base + s * ring.stage_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma<NW>(acc, gmma_desc(st + a_off + 32 * kk, 16, 1024),
                gmma_desc(st + b_off + 2048 * kk, kChunkBytes, 1024), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the group of the previous k tile is done: one arrival per warp
    if (kt > 0 && leader) mbar_arrive(&empty[prev]);
    prev = s;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (leader) mbar_arrive(&empty[prev]);

  // epilogue, while the producer fills the ring for the next tile:
  // relu(acc + bias), rounded first where the segment says. Thread
  // (warp, lane) holds rows warp * 16 + lane / 4 (+ 8), columns
  // 8 i + 2 (lane % 4) (+ 1). Columns bound for a tensor go 16 at a time
  // through the warp's patch and out as 16-byte rows; avg_tail's columns
  // are summed over each (n, t) of the warp's 16 rows across its lanes
  // and stored into the slot of that (n, t) and the warp's row block.
  const Problem& p = P.L.p[at.prob];
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rows = P.L.rows, hw = P.L.h * P.L.w;
  const int rw = at.m0 + (wide ? 0 : cw * 64) + warp * 16;
  const int ra = rw + (lane >> 2), rb = ra + 8;
  const int g_first = rw / hw;
  const int g_last = (rw + 15 < rows ? rw + 15 : rows - 1) / hw;
  const int cbase = at.n0 + (wide ? cw * NW : 0);
#pragma unroll
  for (int i2 = 0; i2 < NW / 8; i2 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i2 + h;
      const int col = cbase + 8 * i + 2 * (lane & 3);
      if (col >= p.ncols) continue;  // the warp's 8 columns share a segment
      int sg = 0;
      while (sg + 1 < p.nseg && col >= p.seg[sg].end) ++sg;
      const Seg& seg = p.seg[sg];
      const float b0 = p.bias[col], b1 = p.bias[col + 1];
      float v[4] = {acc[4 * i] + b0, acc[4 * i + 1] + b1,
                    acc[4 * i + 2] + b0, acc[4 * i + 3] + b1};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (seg.round_first) v[q] = to_f(from_f<bf16>(v[q]));
        v[q] = fmaxf(v[q], 0.0f);
      }
      if (seg.sums == nullptr) {
        bf16* e = patch + (lane >> 2) * 24 + 8 * h + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(e) =
            __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(e + 8 * 24) =
            __floats2bfloat162_rn(v[2], v[3]);
        continue;
      }
      for (int gi = g_first; gi <= g_last; ++gi) {
        const bool in_a = ra < rows && ra / hw == gi;
        const bool in_b = rb < rows && rb / hw == gi;
        float s0 = (in_a ? v[0] : 0.0f) + (in_b ? v[2] : 0.0f);
        float s1 = (in_a ? v[1] : 0.0f) + (in_b ? v[3] : 0.0f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (lane < 4) {
          const int slot = rw / 16 - gi * hw / 16;
          float* d = seg.sums + ((size_t)gi * P.L.slots + slot) * seg.ld +
                     seg.off + col - seg.begin;
          d[0] = s0;
          d[1] = s1;
        }
      }
    }
    __syncwarp();
    {  // lane: row lane / 2 of the patch, its 8 columns (lane % 2)
      const int row = rw + (lane >> 1);
      const int col = cbase + 8 * (i2 + (lane & 1));
      if (row < rows && col < p.ncols) {
        int sg = 0;
        while (sg + 1 < p.nseg && col >= p.seg[sg].end) ++sg;
        const Seg& seg = p.seg[sg];
        if (seg.sums == nullptr)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(seg.dst) +
                                    (size_t)row * seg.ld + seg.off + col -
                                    seg.begin) =
              *reinterpret_cast<const uint4*>(patch + (lane >> 1) * 24 +
                                              8 * (lane & 1));
      }
    }
    __syncwarp();
  }
}

// A persistent block: tiles blockIdx.x, + gridDim.x, ... in list order.
// The ring and its barriers' phases carry over from tile to tile, so the
// producer runs ahead into the next tile while the consumers finish the
// last one.
__global__ void __launch_bounds__(kThreads, 1)
igemm_sm90(const __grid_constant__ Launch90 P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* pipe =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe + kPipeBytes);
  uint64_t* empty = full + kMaxStages;
  RowMask* rows = reinterpret_cast<RowMask*>(empty + kMaxStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 129);  // 128 producer threads + expect_tx
      mbar_init(&empty[s], 8);   // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // 128 x 104 + 256 x 200 registers: the 384 x 168 the block holds at
  // launch (more would leave setmaxnreg.inc waiting). The producer's
  // gathers spilled at 56.
  const int wg = threadIdx.x / 128;
  Ring ring = {-1, 0, 0, 0, 0u, 0u};
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    for (int tile = blockIdx.x; tile < P.ntiles; tile += gridDim.x) {
      const TileAt at = tile_at(P, tile);
      const int nk = (P.L.p[at.prob].k + kBK - 1) / kBK;
      produce(P, at, pipe, full, empty, rows, ring, nk);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    bf16* patch = reinterpret_cast<bf16*>(rows + 128) +
                  ((threadIdx.x >> 5) - 4) * kPatch;
    for (int tile = blockIdx.x; tile < P.ntiles; tile += gridDim.x) {
      const TileAt at = tile_at(P, tile);
      const int nk = (P.L.p[at.prob].k + kBK - 1) / kBK;
      switch (P.tl[at.prob].nw) {
        case 64:
          consume<64>(P, at, pipe, full, empty, ring, nk, wg - 1, patch);
          break;
        case 128:
          consume<128>(P, at, pipe, full, empty, ring, nk, wg - 1, patch);
          break;
        case 192:
          consume<192>(P, at, pipe, full, empty, ring, nk, wg - 1, patch);
          break;
        default:
          consume<256>(P, at, pipe, full, empty, ring, nk, wg - 1, patch);
      }
    }
  }
}

// Up to 256 columns: tall (128 rows, the consumers share the columns);
// above, wide (64 rows, a column half each) over ceil(ncols / 512) column
// tiles. nw rounds to a multiple of 64, the width of a TMA box.
Tiling tiling(int ncols, int rows, int first) {
  Tiling t;
  t.wide = ncols > 256;
  t.col_tiles = t.wide ? (ncols + 511) / 512 : 1;
  const int per = t.wide ? (ncols + 2 * t.col_tiles - 1) / (2 * t.col_tiles)
                         : ncols;
  t.nw = (per + 63) / 64 * 64;
  const int rt = t.wide ? 64 : 128;
  t.row_tiles = (rows + rt - 1) / rt;
  t.first_tile = first;
  return t;
}

// B's tensor map: (K, ncols) bf16 row-major, 64 x 64 boxes, 128-byte
// swizzle, zero fill outside.
int encode_b(CUtensorMap* map, const void* w, int k, int ncols) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int e = tensor_map_encoder(&encode);
  if (e != 0) return e;
  cuuint64_t dims[2] = {(cuuint64_t)ncols, (cuuint64_t)k};
  cuuint64_t strides[1] = {(cuuint64_t)ncols * sizeof(bf16)};
  cuuint32_t box[2] = {64, (cuuint32_t)kBK};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One launch over L's problems (bf16). Tensor maps are encoded for each
// launch: the weights are refolded every forward.
int launch(const Launch& L, cudaStream_t stream) {
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
    e = cudaFuncSetAttribute(
        igemm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  const int sms = sms_of[dev];
  Launch90 P;
  memset(&P, 0, sizeof(P));
  P.L = L;
  int first = 0;
  for (int i = 0; i < L.nprob; ++i) {
    const Problem& p = L.p[i];
    P.tl[i] = tiling(p.ncols, L.rows, first);
    first += P.tl[i].row_tiles * P.tl[i].col_tiles;
    const int r = encode_b(&P.tmap[i], p.w, p.k, p.ncols);
    if (r != 0) return r;
  }
  P.ntiles = first;
  igemm_sm90<<<first < sms ? first : sms, kThreads, kSmemBytes, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace
