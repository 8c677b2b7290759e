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
// channels-last rows `pitch` bytes apart (K6 writes pitch = cpt, the
// channels rounded up, the pad zero); w the prepared s8 weight as (Co, Kp)
// rows, k = ((kt * KH + kh) * KW + kw) * cpt + ci, zero for ci >= C and
// past the taps. s_x is read from the device (dynamic: K6 wrote it) or
// passed by value (static). Optionally the raw s32 sums go to `acc` too.
// The sums are exact in s32 (|acc| <= 127^2 K, K a few thousand), so any
// tiling, split or order of the additions gives the same bits.
//
// What bounds it on an H100: the s8 tensor cores (1,979 TOP/s dense) for
// the trunk's 3x3x3, (1, 3, 3) and 1x1 convs at bucket 8, the output bytes
// (3.35 TB/s) for the stems; and, unless the gathers of A are hidden, the
// L2-to-SM traffic of A, which an implicit GEMM reads once per tap.
//
// The first design (mma.sync m16n8k32 on 128 x 64 tiles, a
// two-stage cp.async ring, one block a tile, gathers of 16, 4 or 1 bytes
// by what divides C) reached about 10% of the s8 peak. This design is K3's
// Hopper skeleton (igemm_sm90.cuh) in s8:
// - a persistent block per SM walks the launch's work units (tiles, or
//   tiles x K splits); three warpgroups, warp-specialised;
// - warpgroup 0, the producer (setmaxnreg 104): B by TMA (the prepared
//   weight's tensor map: boxes of 128 K bytes x 32 rows, 128-byte swizzle,
//   zero fill past Co and Kp), A gathered by its 128 threads with 16-byte
//   cp.async (.ca: the taps of neighbouring rows meet again in L1) into
//   the same swizzle; the K per tap is C rounded up to 16, so 16 bytes
//   never straddle a tap. The bytes past C in a row are cut by cp.async's
//   source size (zero fill), so the pad of x is never read and a pitch
//   larger than C costs nothing but the zero columns of w; each thread
//   arrives on the stage's full mbarrier when its copies land;
// - warpgroups 1 and 2, the consumers (setmaxnreg 200), run
//   wgmma.mma_async m64nNk32 s32.s8.s8 on shared-memory descriptors (A and
//   B both K-major, as s8 requires; 128-byte swizzle), keep one group in
//   flight and free a stage on its empty mbarrier;
// - a stage is 128 s8 deep in K. Tiling by a shape rule (`tiling`): Co <=
//   256, 128 rows x nw (nw = Co rounded up to 32; the consumers take 64
//   rows each), or 256 rows (two 64-row blocks a consumer on the same B
//   stage) where nw <= 128 and the 256-row tiles still outnumber the SMs,
//   so that a narrow B is fetched once for twice the rows; above 256
//   columns, 64 rows x 2 nw over ceil(Co / 512) column tiles (the
//   consumers take a column half each), so an A row gathered once feeds up
//   to 512 columns. Columns past Co are TMA's zero fill and the epilogue
//   drops them. Where the tiles cannot fill the card (late layers at
//   bucket 1, the TCN, ResNet-18's strided 1x1s): with a short K,
//   narrower column tiles; with a long one, split-K. Each split adds its
//   s32 sums into a zeroed workspace with atomics (integer: order-free, so
//   still bitwise), and a second kernel dequantizes;
// - epilogue in registers: the dequantize above, its scales s_x * s_w[c]
//   staged in shared memory while the ring fills; bf16 rows leave 16
//   bytes a lane after an exchange within each quad of lanes (else column
//   pairs); the producer meanwhile fills the ring for the next unit.
// - the stems (Cin <= 4, a kernel longer than 1 along its last axis): K6
//   writes their input with the last axis's taps unfolded into channels
//   (x'[w', j C + c] = x[w' - lo + j d, c]), and the weight's last kernel
//   axis goes into its channels the same way, so K5 runs a conv with a
//   kernel of 1 there and C' = k C channels (15 for I3D's folded stem, 21
//   for R(2+1)D's): the same integer products, with a K per tap of 16 or
//   32 where C = 3 padded to 16 would multiply the products by 5.
//
// K6: pass one (dynamic) takes max |x| over the tensor into a device word:
// 16-byte loads where x fills its memory, a max in registers, across the
// warp and through shared memory, one atomicMax a block, on the bits of
// |x| (non-negative floats order as their bits and a NaN's lie above
// inf's, so a NaN in x makes s NaN, as torch.amax and jnp.max do; a max is
// order-free, so s is deterministic). Pass two writes
//   q = clip(rint(x / s), -127, 127),  s = max(amax / 127, 1e-12)
// with `/` an IEEE division (__fdiv_rn, never a reciprocal product) and
// rint half-to-even, as jnp.round; the first thread stores s. With a
// static scale pass one is skipped. q goes to channels-last rows of pitch
// cp (K5's K per tap; the pad channels written as zeros), 16 bytes a
// thread: a channels-last x with C = cp by 32-byte (bf16) or 64-byte (f32)
// loads; a contiguous (n, c, t, h, w) x through 64 x 64 (c, spatial) tiles
// in shared memory, read 16 bytes at a time along the spatial rows where
// they are aligned; a stem's unfold (above) by one (n, t, h) line a block,
// each element quantized once into shared memory and the unfolded rows
// written from there; anything else element by element. Pass two walks
// the tensor backwards, so that what pass one read last, still in L2, is
// read first. Bound by bytes: 3 a bf16 element static, 5 dynamic (x
// twice); a stem's unfolded rows write k C' / C bytes an element.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

// ---------------------------------------------------------------- K5
namespace k5 {
using namespace sm90;

constexpr int kBK = 128;              // K of a stage: one swizzle row of s8
constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kStageMax = 72 * 1024;  // 8 KB A + 64 KB B, or 16 + 32
constexpr int kPipeBytes = 3 * kStageMax;
constexpr int kMaxStages = 8;
constexpr int kSmemBytes =
    kPipeBytes + 1024 + 2 * kMaxStages * 8 + 256 * 16 + 2 * 256 * 4;

struct Conv {
  const int8_t* x;
  const float* sw;
  const float* sx_ptr;  // dynamic scale on the device, or null
  float sx_val;         // static scale
  void* out;
  int32_t* acc;  // the raw sums (return_acc or the split-K workspace), or null
  int n, t, h, w, c, pitch;
  int to, ho, wo, co;
  int kt, kh, kw;
  int st, sh, sw_, dt, dh, dw, pt, ph, pw;
  int cpt, k, m, out_bf16, want_acc;
};

// Per launch: the consumers' width nw (32..256, a multiple of 32), tall
// (rows = 128 or 256 rows x nw) or wide (64 rows x 2 nw), the tile grid,
// the K stages and their split.
struct Tiling {
  int nw, wide, rows, row_tiles, col_tiles, nk, splits, chunk;
};

struct Launch {
  CUtensorMap bmap;  // B: (co, kp) s8 rows
  Conv p;
  Tiling tl;
  int units;
};

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15},"
      " %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
      "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
      "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
      "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95},"
      " %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
      "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
      "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
      "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
      "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
      "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
      "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<224>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111},"
      " %112, %113, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
      "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
      "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
      "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
      "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
      "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
      "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
      "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
      "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
      "+r"(d[111])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},"
      " %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
      "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
      "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
      "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]),
      "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
      "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
      "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]),
      "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
      "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]),
      "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
      "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
      "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
      "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// cp.async of 16 bytes through L1, `bytes` of them from src and the rest
// zero (0: all zero, src not read)
__device__ __forceinline__ void cp_async_ca16(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// One unit of work: rows m0.., columns n0.., K stages [ks0, ks1).
struct Unit {
  int m0, n0, ks0, ks1;
};

__device__ __forceinline__ Unit unit_at(const Launch& P, int u) {
  const Tiling& tl = P.tl;
  const int split = u % tl.splits, tile = u / tl.splits;
  Unit a;
  a.m0 = (tile / tl.col_tiles) * tl.rows;
  a.n0 = (tile % tl.col_tiles) * (tl.wide ? 2 * tl.nw : tl.nw);
  a.ks0 = split * tl.chunk;
  a.ks1 = min(tl.nk, a.ks0 + tl.chunk);
  return a;
}

// The ring: stage i % nstages of step i; its barriers complete once per
// round (i / nstages), so the parity to wait for follows from i.
struct Ring {
  int it, nstages, stage_bytes;
};

// A row of the tile: its first input row n * T * H * W and the corner
// (t0, h0, w0) of its window; t0 far out of range past the rows.
__device__ __forceinline__ int4 row_at(const Conv& p, int m) {
  if (m >= p.m) return make_int4(0, -(1 << 28), 0, 0);
  const int wo = m % p.wo;
  m /= p.wo;
  const int ho = m % p.ho;
  m /= p.ho;
  const int to = m % p.to;
  const int n = m / p.to;
  return make_int4(n * p.t * p.h * p.w, to * p.st - p.pt, ho * p.sh - p.ph,
                   wo * p.sw_ - p.pw);
}

// the offsets (t, h, w) and channel of contraction index k
__device__ __forceinline__ void tap_of(const Conv& p, int k, int& ot, int& oh,
                                       int& ow, int& ci) {
  const int tap = k / p.cpt;
  ci = k - tap * p.cpt;
  const int r = tap / p.kw;
  ow = (tap - r * p.kw) * p.dw;
  oh = (r % p.kh) * p.dh;
  ot = (r / p.kh) * p.dt;
}

__device__ __forceinline__ const int8_t* gather_src(const Conv& p, int4 r,
                                                    int ot, int oh, int ow,
                                                    int ci, bool& in) {
  const int ti = r.y + ot, hi = r.z + oh, wi = r.w + ow;
  in = (unsigned)ti < (unsigned)p.t && (unsigned)hi < (unsigned)p.h &&
       (unsigned)wi < (unsigned)p.w;
  return p.x + ((long long)r.x + ((long long)ti * p.h + hi) * p.w + wi) *
                   p.pitch + ci;
}

// Warpgroup 0 on one unit: B by TMA (thread 0), A by the 128 threads.
// Thread tid gathers 16-byte chunk c = tid % 8 of rows tid / 8 + 16 i (the
// same k for all of them), stored at chunk c ^ (row % 8) of each 128-byte
// row: the 128-byte swizzle.
__device__ __forceinline__ void produce(const Launch& P, const Unit& un,
                                        unsigned char* pipe, uint64_t* full,
                                        uint64_t* empty, int4* rows,
                                        Ring& ring) {
  const Conv& p = P.p;
  const int tid = threadIdx.x;
  const int rows_tile = P.tl.rows;
  const int width = P.tl.wide ? 2 * P.tl.nw : P.tl.nw;
  named_sync(1, 128);  // the previous unit's gathers are done with rows
  for (int r = tid; r < rows_tile; r += 128) rows[r] = row_at(p, un.m0 + r);
  named_sync(1, 128);
  const int c = tid & 7, r0 = tid >> 3, loads = rows_tile / 16;
  for (int ks = un.ks0; ks < un.ks1; ++ks, ++ring.it) {
    const int s = ring.it % ring.nstages, round = ring.it / ring.nstages;
    if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
    unsigned char* st = pipe + s * ring.stage_bytes;
    if (tid == 0) {  // B: width / 32 boxes of 32 rows
      mbar_expect_tx(&full[s], width * 128);
      for (int j = 0; j < width / 32; ++j)
        tma_load_2d(smem_addr(st + (rows_tile + 32 * j) * 128), &P.bmap,
                    &full[s], ks * kBK, un.n0 + 32 * j);
    }
    const int k = ks * kBK + 16 * c;
    int ot = 0, oh = 0, ow = 0, ci = 0, bytes = 0;
    if (k < p.k) {
      tap_of(p, k, ot, oh, ow, ci);
      bytes = min(16, p.c - ci);
    }
    for (int i = 0; i < loads; ++i) {
      const int r = r0 + 16 * i;
      const uint32_t dst = smem_addr(st + r * 128 + ((c ^ (r & 7)) << 4));
      bool in;
      const int8_t* src = gather_src(p, rows[r], ot, oh, ow, ci, in);
      in = in && bytes > 0;
      cp_async_ca16(dst, in ? src : p.x, in ? bytes : 0);
    }
    cp_async_arrive(&full[s]);
  }
}

// float(acc) * scale, scale = s_x * s_w[c] in f32, the product first
__device__ __forceinline__ float dequant(int a, float scale) {
  return __fmul_rn(__int2float_rn(a), scale);
}

// out (and the sums) at (row, col), (row, col + 1), with their scales
__device__ __forceinline__ void store_pair(const Conv& p, int row, int col,
                                           int a0, int a1, float s0,
                                           float s1) {
  if (row >= p.m || col >= p.co) return;
  const long long o = (long long)row * p.co + col;
  const bool pair = col + 1 < p.co && (p.co & 1) == 0;
  if (p.want_acc) {
    if (pair) {
      *reinterpret_cast<int2*>(p.acc + o) = make_int2(a0, a1);
    } else {
      p.acc[o] = a0;
      if (col + 1 < p.co) p.acc[o + 1] = a1;
    }
  }
  const float y0 = dequant(a0, s0);
  const float y1 = dequant(a1, s1);
  if (p.out_bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
    } else {
      out[0] = __float2bfloat16_rn(y0);
      if (col + 1 < p.co) out[1] = __float2bfloat16_rn(y1);
    }
  } else {
    float* out = static_cast<float*>(p.out) + o;
    if (pair) {
      *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
    } else {
      out[0] = y0;
      if (col + 1 < p.co) out[1] = y1;
    }
  }
}

// The epilogue of 64 rows (from ra's row block) x NW columns of one
// consumer's sums. Thread (warp, lane) holds rows warp * 16 + lane / 4
// (+ 8), columns 8 i + 2 (lane % 4) (+ 1).
template <int NW>
__device__ __forceinline__ void epilogue(const Conv& p, const int* acc,
                                         int ra, int cols, bool split,
                                         const float* scales) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int cbase = cols + 2 * q;
  if (split) {  // add into the workspace; a second kernel ends
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int col = cbase + 8 * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + (e >> 1) * 8, cc = col + (e & 1);
        if (row < p.m && cc < p.co)
          atomicAdd(p.acc + (long long)row * p.co + cc, acc[4 * i + e]);
      }
    }
    return;
  }
  // bf16 rows 16 bytes at a time: over columns 8 i .. 8 i + 15 the four
  // lanes of a quad hold rows ra and ra + 8 by column pairs; an exchange
  // among them leaves lane q with row ra + 8 (q % 2), columns 8 (i + q / 2)
  // .. + 7, so a warp stores 16 rows x 32 bytes, whole sectors
  const bool rows16 = p.out_bf16 && !p.want_acc && p.co % 8 == 0;
#pragma unroll
  for (int i = 0; i < NW / 8; i += 2) {
    const float2 s0 =
        *reinterpret_cast<const float2*>(scales + 8 * i + 2 * q);
    const float2 s1 =
        *reinterpret_cast<const float2*>(scales + 8 * i + 8 + 2 * q);
    if (rows16 && cols + 8 * i + 16 <= p.co) {
      uint32_t w[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 sc = h ? s1 : s0;
        const int* a = acc + 4 * (i + h);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              dequant(a[2 * r], sc.x), dequant(a[2 * r + 1], sc.y));
          w[2 * h + r] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
      uint32_t o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // send w[(q + r) % 4], receive from q - r
        const int d = (q + r) & 3, src = (q - r) & 3;
        const uint32_t v =
            d == 0 ? w[0] : d == 1 ? w[1] : d == 2 ? w[2] : w[3];
        const uint32_t got = __shfl_sync(0xffffffffu, v, (lane & ~3) | src);
        o[0] = src == 0 ? got : o[0];
        o[1] = src == 1 ? got : o[1];
        o[2] = src == 2 ? got : o[2];
        o[3] = src == 3 ? got : o[3];
      }
      const int row = ra + 8 * (q & 1);
      if (row < p.m)
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                                  (long long)row * p.co + cols +
                                  8 * (i + (q >> 1))) =
            make_uint4(o[0], o[1], o[2], o[3]);
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = cbase + 8 * (i + h);
      const float2 sc = h ? s1 : s0;
      store_pair(p, ra, col, acc[4 * (i + h)], acc[4 * (i + h) + 1], sc.x,
                 sc.y);
      store_pair(p, ra + 8, col, acc[4 * (i + h) + 2],
                 acc[4 * (i + h) + 3], sc.x, sc.y);
    }
  }
}

// Consumer warpgroup cw (0 or 1) on one unit: MB blocks of 64 rows x NW
// columns, each block's wgmma on the same B. Its columns' scales
// s_x * s_w[c] go to `scales` (shared memory) while the ring fills, so
// that the epilogue reads no global memory but the sums' destinations.
template <int NW, int MB>
__device__ __forceinline__ void consume(const Launch& P, const Unit& un,
                                        unsigned char* pipe, uint64_t* full,
                                        uint64_t* empty, Ring& ring, int cw,
                                        float* scales) {
  const bool wide = P.tl.wide;
  const int rows_tile = P.tl.rows;
  const Conv& p = P.p;
  const int cols = un.n0 + (wide ? cw * NW : 0);
  named_sync(2 + cw, 128);  // the previous epilogue is done with scales
  if (P.tl.splits == 1) {
    const float sx = p.sx_ptr != nullptr ? *p.sx_ptr : p.sx_val;
    for (int j = threadIdx.x & 127; j < NW; j += 128)
      scales[j] = cols + j < p.co ? __fmul_rn(sx, p.sw[cols + j]) : 0.0f;
  }
  int acc[MB * NW / 2];
#pragma unroll
  for (int i = 0; i < MB * NW / 2; ++i) acc[i] = 0;
  // the consumer's first row block in the tile
  const int block0 = wide ? 0 : cw * MB;
  const uint32_t b_off = rows_tile * 128 + (wide ? cw * NW * 128 : 0);
  const uint32_t base = smem_addr(pipe);
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = 0;
  for (int ks = un.ks0; ks < un.ks1; ++ks, ++ring.it) {
    const int s = ring.it % ring.nstages;
    mbar_wait(&full[s], (ring.it / ring.nstages) & 1);
    fence_proxy_async();  // the cp.async writes, read by wgmma
    const uint32_t st = base + s * ring.stage_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
      for (int b = 0; b < MB; ++b)
        wgmma_s8<NW>(acc + b * NW / 2,
                     gmma_desc(st + (block0 + b) * 64 * 128 + 32 * kk, 16,
                               1024),
                     gmma_desc(st + b_off + 32 * kk, 16, 1024), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the group of the previous stage is done: one arrival per warp
    if (ks > un.ks0 && leader) mbar_arrive(&empty[prev]);
    prev = s;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (leader) mbar_arrive(&empty[prev]);
  const bool split = P.tl.splits > 1;
  if (!split) named_sync(2 + cw, 128);  // scales are written
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < MB; ++b)
    epilogue<NW>(p, acc + b * NW / 2,
                 un.m0 + (block0 + b) * 64 + warp * 16 + (lane >> 2), cols,
                 split, scales);
}

template <int MB>
__device__ __forceinline__ void consume_nw(const Launch& P, const Unit& un,
                                           unsigned char* pipe,
                                           uint64_t* full, uint64_t* empty,
                                           Ring& ring, int cw,
                                           float* scales) {
  switch (P.tl.nw) {
    case 32: consume<32, MB>(P, un, pipe, full, empty, ring, cw, scales);
      break;
    case 64: consume<64, MB>(P, un, pipe, full, empty, ring, cw, scales);
      break;
    case 96: consume<96, MB>(P, un, pipe, full, empty, ring, cw, scales);
      break;
    case 128: consume<128, MB>(P, un, pipe, full, empty, ring, cw, scales);
      break;
    case 160: if (MB == 1) consume<160, 1>(P, un, pipe, full, empty, ring,
                                           cw, scales);
      break;
    case 192: if (MB == 1) consume<192, 1>(P, un, pipe, full, empty, ring,
                                           cw, scales);
      break;
    case 224: if (MB == 1) consume<224, 1>(P, un, pipe, full, empty, ring,
                                           cw, scales);
      break;
    default: if (MB == 1) consume<256, 1>(P, un, pipe, full, empty, ring,
                                          cw, scales);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_sm90(const __grid_constant__ Launch P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* pipe =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe + kPipeBytes);
  uint64_t* empty = full + kMaxStages;
  int4* rows = reinterpret_cast<int4*>(empty + kMaxStages);
  float* scales = reinterpret_cast<float*>(rows + 256);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 129);  // 128 producer threads + expect_tx
      mbar_init(&empty[s], 8);   // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Ring ring;
  ring.it = 0;
  ring.stage_bytes =
      (P.tl.rows + (P.tl.wide ? 2 : 1) * P.tl.nw) * 128;
  ring.nstages = min(kMaxStages, kPipeBytes / ring.stage_bytes);
  // 128 x 104 + 256 x 200 registers: within the 384 x 168 the block holds
  // at launch, as K3's
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n");
    for (int u = blockIdx.x; u < P.units; u += gridDim.x)
      produce(P, unit_at(P, u), pipe, full, empty, rows, ring);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    float* sc = scales + (wg - 1) * 256;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
      const Unit un = unit_at(P, u);
      if (P.tl.rows == 256) {
        consume_nw<2>(P, un, pipe, full, empty, ring, wg - 1, sc);
      } else {
        consume_nw<1>(P, un, pipe, full, empty, ring, wg - 1, sc);
      }
    }
  }
}

// The split-K epilogue: the summed workspace to out (and acc, if it is not
// the workspace itself).
__global__ void __launch_bounds__(256) int8_conv_dequant(const Conv p,
                                                         const int32_t* ws) {
  const float sx = p.sx_ptr != nullptr ? *p.sx_ptr : p.sx_val;
  const long long total = (long long)p.m * p.co;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const int a = ws[i];
    const float y = dequant(a, __fmul_rn(sx, p.sw[i % p.co]));
    if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(y);
    } else {
      static_cast<float*>(p.out)[i] = y;
    }
    if (p.want_acc && p.acc != ws) p.acc[i] = a;
  }
}

int ceil32(int v) { return (v + 31) / 32 * 32; }

// The shape rule. Up to 256 columns, tall: 128 rows x nw, nw = Co rounded
// up to 32; above, wide: 64 rows x 2 nw over ceil(Co / 512) column tiles.
// Where that gives fewer tiles than SMs: with K shorter than 4 stages,
// tall tiles over narrower column tiles (nw halved while it stays >= 64
// and the tiles stay fewer than the SMs), so that more SMs share a small
// problem; with a longer K, fewer than half as many tiles as SMs split K.
Tiling tiling(int co, int m, int k, int sms) {
  Tiling t;
  t.wide = co > 256;
  t.col_tiles = t.wide ? (co + 511) / 512 : 1;
  t.nw = ceil32(t.wide ? (co + 2 * t.col_tiles - 1) / (2 * t.col_tiles) : co);
  t.rows = t.wide ? 64 : 128;
  t.row_tiles = (m + t.rows - 1) / t.rows;
  t.nk = (k + kBK - 1) / kBK;
  if (!t.wide && t.nw <= 128 && (m + 255) / 256 >= sms) {
    t.rows = 256;  // each B stage feeds twice the rows
    t.row_tiles = (m + 255) / 256;
  }
  if (t.row_tiles * t.col_tiles < sms && t.nk < 4) {
    const int rows = (m + 127) / 128;
    int ct = (co + 255) / 256;
    while (rows * ct < sms && ceil32((co + 2 * ct - 1) / (2 * ct)) >= 64)
      ct *= 2;
    t.wide = 0;
    t.rows = 128;
    t.row_tiles = rows;
    t.col_tiles = ct;
    t.nw = ceil32((co + ct - 1) / ct);
  }
  const int tiles = t.row_tiles * t.col_tiles;
  int splits = 1;
  if (2 * tiles <= sms && t.nk >= 4) {
    splits = (sms + tiles - 1) / tiles;
    if (splits > t.nk / 2) splits = t.nk / 2;
  }
  t.chunk = (t.nk + splits - 1) / splits;
  t.splits = (t.nk + t.chunk - 1) / t.chunk;  // no empty split
  return t;
}

// B's tensor map: (co, kp) s8 rows, boxes of 128 K bytes x 32 rows (any
// tile width is a multiple of 32), 128-byte swizzle, zero fill outside.
int encode_b(CUtensorMap* map, const void* w, int co, int kp) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const int e = tensor_map_encoder(&encode);
  if (e != 0) return e;
  cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)co};
  cuuint64_t strides[1] = {(cuuint64_t)kp};
  cuuint32_t box[2] = {(cuuint32_t)kBK, 32};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// per device, once: the raised shared-memory limit (the attribute holds for
// the current device only) and the SM count
int device_sms(int* sms) {
  static bool attr_set[64];
  static int sms_of[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(int8_conv_sm90,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  *sms = sms_of[dev];
  return 0;
}

// geom (25 ints): n, t, h, w, c, pitch, to, ho, wo, co, kt, kh, kw, st,
// sh, sw, dt, dh, dw, pt, ph, pw, cpt, kp, out_bf16.
int read_geom(Conv& p, int& kp, const int* g) {
  p.n = g[0], p.t = g[1], p.h = g[2], p.w = g[3], p.c = g[4], p.pitch = g[5];
  p.to = g[6], p.ho = g[7], p.wo = g[8], p.co = g[9];
  p.kt = g[10], p.kh = g[11], p.kw = g[12];
  p.st = g[13], p.sh = g[14], p.sw_ = g[15];
  p.dt = g[16], p.dh = g[17], p.dw = g[18];
  p.pt = g[19], p.ph = g[20], p.pw = g[21];
  p.cpt = g[22];
  kp = g[23];
  p.out_bf16 = g[24];
  p.k = p.kt * p.kh * p.kw * p.cpt;
  const long long m = (long long)p.n * p.to * p.ho * p.wo;
  const bool ok =
      p.n > 0 && p.c > 0 && p.co > 0 && p.kt > 0 && p.kh > 0 && p.kw > 0 &&
      p.to > 0 && p.ho > 0 && p.wo > 0 && p.cpt >= p.c && p.cpt % 16 == 0 &&
      p.pitch >= p.c && p.pitch % 16 == 0 && kp >= p.k && kp % 16 == 0 &&
      m < INT_MAX && (long long)p.n * p.t * p.h * p.w < INT_MAX;
  if (!ok) return (int)cudaErrorInvalidValue;
  p.m = (int)m;
  return 0;
}

}  // namespace k5

// ---------------------------------------------------------------- K6
namespace k6 {

struct Act {
  const void* x;
  int8_t* q;
  float* scale_out;  // dynamic: where s goes
  unsigned* amax;    // dynamic: max |x| as float bits
  float scale_val;   // static scale
  int n, c, t, h, w, cp;          // cp: q's row pitch (zero channels past c)
  long long sn, sc, st, sh, sw;   // x's strides, elements
  // the stems' unfold (K5's note): q's row w' holds channels j * c + ci =
  // x[ci] at w' us - ulo + j ud, j < uk, for w' < wq; uk = us = 1, wq = w:
  // none
  int uk, ud, us, ulo, wq;
  int bf16;
  long long total;  // elements of x
  long long rows;   // n * t * h * wq: q's rows
  int sp;           // t * h * w
};

__device__ __forceinline__ float at(const Act& a, long long off) {
  return a.bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(a.x)[off])
                : reinterpret_cast<const float*>(a.x)[off];
}

// eight elements from off, 16-byte aligned (one load of bf16, two of f32)
__device__ __forceinline__ void at8(const Act& a, long long off, float* v) {
  if (a.bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(a.x) + off);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(b[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(a.x) + off);
    const float4 f0 = f[0], f1 = f[1];
    v[0] = f0.x, v[1] = f0.y, v[2] = f0.z, v[3] = f0.w;
    v[4] = f1.x, v[5] = f1.y, v[6] = f1.z, v[7] = f1.w;
  }
}

// the memory offset of row r = ((n * T + t) * H + h) * W + w
__device__ __forceinline__ long long row_off(const Act& a, long long r) {
  const int w = (int)(r % a.w);
  r /= a.w;
  const int h = (int)(r % a.h);
  r /= a.h;
  const int t = (int)(r % a.t);
  const long long n = r / a.t;
  return n * a.sn + t * a.st + h * a.sh + w * a.sw;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(fabsf(v));
}

// max over the bits of |x| (fmaxf would drop a NaN): in registers, across
// the warp, through shared memory, one atomicMax a block. dense: x fills
// its memory (any order of dims), read flat, 16 bytes at a time when vec.
__global__ void __launch_bounds__(256) absmax_kernel(const Act a, int dense,
                                                     int vec) {
  __shared__ unsigned part[8];
  unsigned m = 0u;
  const long long stride = (long long)gridDim.x * 256;
  const long long first = blockIdx.x * 256LL + threadIdx.x;
  if (dense) {
    long long tail = 0;
    if (vec) {
      const long long n8 = a.total / 8;
      for (long long i = first; i < n8; i += stride) {
        float v[8];
        at8(a, 8 * i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) m = max(m, abs_bits(v[j]));
      }
      tail = n8 * 8;
    }
    for (long long i = tail + first; i < a.total; i += stride)
      m = max(m, abs_bits(at(a, i)));
  } else {  // element by element, channels-last order
    for (long long i = first; i < a.total; i += stride) {
      const int c = (int)(i % a.c);
      m = max(m, abs_bits(at(a, row_off(a, i / a.c) + c * a.sc)));
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, s));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < 8 ? part[threadIdx.x] : 0u;
#pragma unroll
    for (int s = 4; s > 0; s >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (threadIdx.x == 0) atomicMax(a.amax, m);
  }
}

// s: the static scale, or max(amax / 127, 1e-12), NaN kept as
// torch.clamp_min keeps it, which the first thread of the grid stores
__device__ __forceinline__ float act_scale(const Act& a) {
  if (a.amax == nullptr) return a.scale_val;
  const float d = __fdiv_rn(__uint_as_float(*a.amax), 127.0f);
  const float s = isnan(d) ? d : fmaxf(d, 1e-12f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    *a.scale_out = s;
  return s;
}

__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
}

// x in channels-last rows with c = cp: 16 elements to one 16-byte store,
// chunks from the last
__global__ void __launch_bounds__(256) quantize_cl_kernel(const Act a) {
  const float s = act_scale(a);
  const long long chunks = a.total / 16;
  for (long long j = blockIdx.x * 256LL + threadIdx.x; j < chunks;
       j += (long long)gridDim.x * 256) {
    const long long i = chunks - 1 - j;
    float v[16];
    at8(a, 16 * i, v);
    at8(a, 16 * i + 8, v + 8);
    uint32_t wd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wd[k] = quantize(v[4 * k], s) | quantize(v[4 * k + 1], s) << 8 |
              quantize(v[4 * k + 2], s) << 16 |
              quantize(v[4 * k + 3], s) << 24;
    *reinterpret_cast<uint4*>(a.q + 16 * i) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// x contiguous (n, c, sp): a 64 x 64 (c, sp) tile read along sp
// (8 elements a thread, 16-byte loads when vec), quantized, transposed in
// shared memory and stored as 16 channels (16 bytes) of a row a thread;
// tiles from the last
template <bool VEC>
__global__ void __launch_bounds__(256) quantize_nc_kernel(const Act a) {
  __shared__ __align__(16) uint8_t tile[64][80];
  const float s = act_scale(a);
  const int sp0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int c0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const long long n = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int cl = (tid >> 3) + 32 * pass, c = c0 + cl;
    const int spl = (tid & 7) * 8, sp = sp0 + spl;
    float v[8];
    if (c < a.c) {
      const long long off = (n * a.c + c) * a.sp + sp;
      if (VEC && sp + 8 <= a.sp) {
        at8(a, off, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = sp + j < a.sp ? at(a, off + j) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tile[spl + j][cl] = (uint8_t)quantize(v[j], s);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[spl + j][cl] = 0;
    }
  }
  __syncthreads();
  const int spl = tid >> 2, c = c0 + 16 * (tid & 3), sp = sp0 + spl;
  if (sp < a.sp && c < a.cp)
    *reinterpret_cast<uint4*>(a.q + (n * a.sp + sp) * a.cp + c) =
        *reinterpret_cast<const uint4*>(&tile[spl][16 * (tid & 3)]);
}

// Anything else: one 16-byte chunk of q (16 channels of a row) a thread,
// each element through x's strides (and a stem's unfold where it is too
// wide for unfold_kernel); chunks from the last
__global__ void __launch_bounds__(256) quantize_rows_kernel(const Act a) {
  const float s = act_scale(a);
  const int per_row = a.cp / 16, cq = a.uk * a.c;
  const long long chunks = a.rows * per_row;
  for (long long j = blockIdx.x * 256LL + threadIdx.x; j < chunks;
       j += (long long)gridDim.x * 256) {
    const long long i = chunks - 1 - j;
    long long r = i / per_row;
    const int c0 = (int)(i % per_row) * 16;
    const int wq = (int)(r % a.wq);
    r /= a.wq;
    const int h = (int)(r % a.h);
    r /= a.h;
    const int t = (int)(r % a.t);
    const long long base = (r / a.t) * a.sn + t * a.st + h * a.sh;
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
    for (int k = 0; k < 16 && c0 + k < cq; ++k) {
      const int ch = c0 + k, tap = ch / a.c, ci = ch - tap * a.c;
      const int w = wq * a.us - a.ulo + tap * a.ud;
      if ((unsigned)w >= (unsigned)a.w) continue;
      wd[k >> 2] |=
          quantize(at(a, base + (long long)ci * a.sc + (long long)w * a.sw),
                   s)
          << (8 * (k & 3));
    }
    *reinterpret_cast<uint4*>(a.q + 16 * i) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// The stems' unfold: one (n, t, h) line of x a block, its C x W
// elements quantized once into shared memory (read along w), then q's wq
// rows of that line written 16 bytes a thread; lines from the last
__global__ void __launch_bounds__(128) unfold_kernel(const Act a) {
  extern __shared__ uint8_t line[];  // [c][w]
  const float s = act_scale(a);
  const long long lines = a.rows / a.wq;
  const int per_row = a.cp / 16, cq = a.uk * a.c, tid = threadIdx.x;
  for (long long l = blockIdx.x; l < lines; l += gridDim.x) {
    const long long li = lines - 1 - l;
    const int h = (int)(li % a.h), t = (int)((li / a.h) % a.t);
    const long long n = li / ((long long)a.h * a.t);
    const long long base = n * a.sn + t * a.st + h * a.sh;
    __syncthreads();  // the previous line is written
    for (int i = tid; i < a.c * a.w; i += 128) {
      const int c = i / a.w, w = i - c * a.w;
      line[i] = (uint8_t)quantize(at(a, base + c * a.sc + w * a.sw), s);
    }
    __syncthreads();
    for (int i = tid; i < a.wq * per_row; i += 128) {
      const int wq = i / per_row, c0 = (i - wq * per_row) * 16;
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int ch = c0 + k, tap = ch / a.c, ci = ch - tap * a.c;
        const int w = wq * a.us - a.ulo + tap * a.ud;
        if (ch < cq && (unsigned)w < (unsigned)a.w)
          wd[k >> 2] |= (uint32_t)line[ci * a.w + w] << (8 * (k & 3));
      }
      *reinterpret_cast<uint4*>(a.q + (li * a.wq + wq) * a.cp + c0) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

int grid_for(long long items, int cap) {
  const long long blocks = (items + 255) / 256;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace k6
}  // namespace

extern "C" {

const char* jmt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// B's tensor map of a prepared weight w (co, kp) s8 rows, 16-byte aligned,
// into map_out (128 bytes); 0 or a cudaError_t.
int jmt_int8_weight_map(const void* w, int co, int kp, void* map_out) {
  if (co <= 0 || kp <= 0 || kp % 16 != 0 || (uintptr_t)w % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int e = k5::encode_b(&map, w, co, kp);
  if (e == 0) memcpy(map_out, &map, sizeof(map));
  return e;
}

// The K splits that jmt_int8_conv takes for geom on the current device:
// above 1 it needs a workspace of m x co s32 (or return_acc's sums).
int jmt_int8_conv_splits(const int* geom, int* splits) {
  k5::Conv p = {};
  int kp = 0, sms = 0;
  int e = k5::read_geom(p, kp, geom);
  if (e == 0) e = k5::device_sms(&sms);
  if (e != 0) return e;
  *splits = k5::tiling(p.co, p.m, p.k, sms).splits;
  return 0;
}

// x: s8 channels-last rows (n, t, h, w) of `pitch` bytes, 16-byte aligned;
// w: the prepared (co, kp) s8 rows; bmap: its tensor map (128 bytes on the
// host) or null (encoded here); sw (co,) f32; sx on the device (dynamic)
// or null and sx_val; out (n, to, ho, wo, co) rows in f32 or bf16; acc the
// same rows in s32, or null; ws: m x co s32 when split (jmt_int8_conv_
// splits > 1) and acc is null, else null.
int jmt_int8_conv(const void* x, const void* w, const void* bmap,
                  const void* sw, const void* sx, float sx_val, void* out,
                  void* acc, void* ws, const int* geom, void* stream) {
  k5::Launch P;
  memset(&P, 0, sizeof(P));
  k5::Conv& p = P.p;
  int kp = 0, sms = 0;
  int e = k5::read_geom(p, kp, geom);
  if (e == 0 && ((uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0))
    e = (int)cudaErrorInvalidValue;
  if (e == 0) e = k5::device_sms(&sms);
  if (e != 0) return e;
  p.x = (const int8_t*)x;
  p.sw = (const float*)sw;
  p.sx_ptr = (const float*)sx;
  p.sx_val = sx_val;
  p.out = out;
  p.want_acc = acc != nullptr;
  P.tl = k5::tiling(p.co, p.m, p.k, sms);
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* sums = (int32_t*)(acc != nullptr ? acc : ws);
  if (P.tl.splits > 1) {
    if (sums == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t me = cudaMemsetAsync(sums, 0,
                                     (size_t)p.m * p.co * sizeof(int32_t), st);
    if (me != cudaSuccess) return (int)me;
  }
  p.acc = sums;
  if (bmap != nullptr) {
    memcpy(&P.bmap, bmap, sizeof(P.bmap));
  } else {
    e = k5::encode_b(&P.bmap, w, p.co, kp);
    if (e != 0) return e;
  }
  P.units = P.tl.row_tiles * P.tl.col_tiles * P.tl.splits;
  k5::int8_conv_sm90<<<P.units < sms ? P.units : sms, k5::kThreads,
                       k5::kSmemBytes, st>>>(P);
  cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess || P.tl.splits == 1) return (int)le;
  k5::int8_conv_dequant<<<k6::grid_for((long long)p.m * p.co, sms * 8), 256,
                          0, st>>>(p, sums);
  return (int)cudaGetLastError();
}

// dims (15 long longs): n, c, t, h, w, then x's strides in that order,
// then the unfold's uk, ud, us, ulo and q's width wq (1, 1, 1, 0, w:
// none).
// q (n, t, h, wq, cp) s8 rows, cp >= uk * c (the channels past it written
// as zeros), 16-byte aligned. dynamic: amax (one u32 of scratch) and
// scale_out (one f32) on the device; static: scale_val, both null.
// contiguous: x is (n, c, t, h, w) contiguous; channels_last: x is in
// channels-last rows.
int jmt_quantize_act(const void* x, void* q, void* scale_out, void* amax,
                     float scale_val, const long long* dims, int bf16,
                     int contiguous, int channels_last, int cp,
                     void* stream) {
  k6::Act a = {};
  a.x = x;
  a.q = (int8_t*)q;
  a.scale_out = (float*)scale_out;
  a.amax = (unsigned*)amax;
  a.scale_val = scale_val;
  a.n = (int)dims[0], a.c = (int)dims[1], a.t = (int)dims[2];
  a.h = (int)dims[3], a.w = (int)dims[4];
  a.sn = dims[5], a.sc = dims[6], a.st = dims[7], a.sh = dims[8];
  a.sw = dims[9];
  a.uk = (int)dims[10], a.ud = (int)dims[11], a.us = (int)dims[12];
  a.ulo = (int)dims[13], a.wq = (int)dims[14];
  a.cp = cp;
  a.bf16 = bf16;
  a.total = dims[0] * dims[1] * dims[2] * dims[3] * dims[4];
  a.rows = dims[0] * dims[2] * dims[3] * dims[14];
  a.sp = (int)(dims[2] * dims[3] * dims[4]);
  const bool unfold = a.uk != 1 || a.us != 1 || a.wq != a.w || a.ulo != 0;
  const bool ok = a.total > 0 && a.uk >= 1 && a.ud >= 1 && a.us >= 1 &&
                  a.wq >= 1 && cp >= a.uk * a.c && cp % 16 == 0 &&
                  (uintptr_t)q % 16 == 0 &&
                  dims[2] * dims[3] * dims[4] < INT_MAX &&
                  (amax == nullptr) == (scale_out == nullptr) &&
                  (amax != nullptr || scale_val > 0.0f);
  if (!ok) return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)x % 16 == 0;
  const int elem = bf16 ? 2 : 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (amax != nullptr) {
    cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    const bool dense = contiguous || channels_last;
    k6::absmax_kernel<<<k6::grid_for(a.total / 8, 132 * 8), 256, 0, st>>>(
        a, dense, dense && aligned);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (!unfold && channels_last && a.c == cp && aligned) {
    k6::quantize_cl_kernel<<<k6::grid_for(a.total / 16, 132 * 16), 256, 0,
                             st>>>(a);
  } else if (unfold && (long long)a.c * a.w <= 32768) {
    const long long lines = a.rows / a.wq;
    k6::unfold_kernel<<<(int)(lines < 132 * 32 ? lines : 132 * 32), 128,
                        a.c * a.w, st>>>(a);
  } else if (!unfold && contiguous && a.n <= 65535) {
    dim3 grid((a.sp + 63) / 64, (cp + 63) / 64, a.n);
    if (aligned && ((long long)a.sp * elem) % 16 == 0) {
      k6::quantize_nc_kernel<true><<<grid, 256, 0, st>>>(a);
    } else {
      k6::quantize_nc_kernel<false><<<grid, 256, 0, st>>>(a);
    }
  } else {
    k6::quantize_rows_kernel<<<k6::grid_for(a.rows * cp / 16, 132 * 16),
                               256, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
