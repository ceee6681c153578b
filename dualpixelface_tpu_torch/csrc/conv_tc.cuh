// The tensor-core tile of the port's dense 3x3x3 convs (K5, T1): a bf16
// implicit GEMM on Hopper's warpgroup MMA (wgmma m64nNk16, bf16 in, f32
// accumulate), with its A tile gathered by cp.async. K1 and K2, whose
// contractions are the same [voxels x 27 C] x [27 C x Co] product over a
// gathered A, can take the B ring, the descriptors and the MMA as they are
// (K1, K2 and T4 do; their TMA ring is tma.cuh's).
//
// The product: out[m][n] = sum_k A[m][k] B[n][k], m a voxel of x
// [B, D, H, W, C] (NDHWC, C % 8 == 0), k = tap * C + c over the 27 taps
// (kd, kh, kw) of a pad-1 stride-1 window and the C input channels, and B
// the packed weight [N][Kp] (K contiguous, zero past 27 C and in padded
// rows; Kp a multiple of BK), which the wrapper builds.
//
// A block of one warpgroup (128 threads) owns BM = 128 consecutive voxels
// (blocks run in voxel order, so the blocks in flight share their halo
// planes in L2) and all N output channels; each thread keeps 2 x N/2 f32
// accumulators (two m64 row tiles). The reduction walks K in tiles of BK = 64
// bf16 (128 bytes) through a ring of STAGES shared-memory stages, each an A
// tile [BM][64] and a B tile [N][64], both in the canonical 128-byte
// swizzle (16-byte granule j of row r at r * 128 + ((j ^ (r % 8)) * 16),
// 1024-byte aligned) that the wgmma descriptors name. An A granule is 8
// channels of one voxel at one tap: each computes its own tap and its own
// zero padding (a halo voxel, a voxel past M or a k past 27 C is a zero-fill
// cp.async of 0 source bytes). x is read through L1 (cp.async.ca), where the
// three kw taps of a (kd, kh) row find most of each other's lines.
//
// The output goes through shared memory: the block's BM x Co outputs are
// one contiguous span of `out`, written in 16-byte stores whatever Co.
//
// f32 (the f32 routes of K5 and T1; those of K1, K2 and T4 take the TF32
// MMA and the split):
// the same tile on f32 elements as split-TF32 (3xTF32) products. A 16-byte
// granule is 4 channels (C % 4 == 0), a 128-byte swizzle row BK32 = 32 f32
// K-elements, and a wgmma k8 TF32 slice 32 bytes of a row, so the gather,
// the swizzle and the descriptors carry over byte for byte. Each f32
// operand a is split into two TF32 halves, both bit-masked (hi = a with its
// low 13 bits cleared, lo = the same of a - hi, which is exact), and the
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi in the f32 accumulator:
// each TF32 product is exact in f32, so `ops/kernels/split_f32.py` predicts
// every product term bit for bit. The weight comes split by the wrapper, as
// two planes [N][Kp] (hi, lo); A arrives raw by cp.async and is split in
// registers, feeding wgmma's register A operand (TF32 wgmma has no
// transpose flags: both operands K-major). A stage is 16 KB of A and 2 x N
// x 128 bytes of B; two stages (78 KB at N = 88, 49 KB at 32, 65 KB at
// 64) let two or three blocks share an SM, and the next stage's loads are
// issued before this one's MMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpf {
namespace tc {

constexpr int BM = 128;       // voxels per block: two m64 wgmma row tiles
constexpr int BK = 64;        // bf16 reduction rows per stage: one 128-byte swizzle row
// cp.async ring depth. Three, not four: at N <= 64 a third block then fits
// on an SM, and more blocks hide more of the gather's latency than a
// deeper ring does (a block is one warpgroup that loads and multiplies in
// turn).
constexpr int STAGES = 3;
constexpr int NTHREADS = 128; // one warpgroup
constexpr int A_BYTES = BM * BK * 2;

__host__ __device__ constexpr int stage_bytes(int n) { return A_BYTES + n * BK * 2; }
// dynamic shared memory of a block: the ring, plus room to align it to 1024
__host__ __device__ constexpr int smem_bytes(int n) { return STAGES * stage_bytes(n) + 1024; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_cg(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte granule j (0..7) of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swizzle(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 1 (unused in this mode), 1024 bytes
// between 8-row groups, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A (64 x 16, descriptor a) * B (16 x N, descriptor b). Each operand
// is K-major (A [64][K], B [N][K]; flag 0) or MN-major (A [K][64], B [K][N],
// M or N contiguous; TA or TB = 1: the instruction's transpose flags, which
// 16-bit types take). An MN-major operand in the 128-byte swizzle is rows
// of 64 M or N values, one 128-byte row per k: `desc` names it too (1024
// bytes between 8-k-row groups), and its k slice kk starts kk * 16 rows
// (2048 bytes) in.
template <int N, int TA = 0, int TB = 0> struct Wgmma;
template <int TA, int TB> struct Wgmma<32, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %20, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
  }
};
template <int TA, int TB> struct Wgmma<40, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[20], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, %24, %23;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
  }
};
template <int TA, int TB> struct Wgmma<64, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
  }
};
template <int TA, int TB> struct Wgmma<88, TA, TB> {
  static __device__ __forceinline__ void mma(float (&d)[44], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
        "}, %44, %45, p, 1, 1, %48, %47;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
  }
};

// d += A (64 x 8, TF32 in registers: a[q] holds row lane / 4 + 8 (q & 1),
// column lane % 4 + 4 (q >> 1) of the warp's 16 rows) * B (8 x N, TF32,
// K-major, descriptor b), f32 accumulation.
template <int N> struct Wgmma32;
template <> struct Wgmma32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma32<40> {
  static __device__ __forceinline__ void mma(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <> struct Wgmma32<88> {
  static __device__ __forceinline__ void mma(float (&d)[44], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
        "}, {%44, %45, %46, %47}, %48, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The two bit-masked TF32 halves of an f32 value: hi keeps its top 11
// significant bits, lo those of a - hi (exact); a_lo b_lo is left out.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

// The A fragment of Wgmma32 from a K-major f32 tile in the 128-byte swizzle
// (rows row0 + [0, 16), columns k0 + [0, 8)), split into hi and lo.
__device__ __forceinline__ void a_fragment_3xtf32(const uint8_t* tile, int row0, int k0, uint32_t (&hi)[4],
                                                  uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + (lane >> 2) + 8 * (q & 1);
    const int k = k0 + (lane & 3) + 4 * (q >> 1);
    split_tf32(*reinterpret_cast<const float*>(tile + swizzle(r, k >> 2) + (k & 3) * 4), hi[q], lo[q]);
  }
}

// acc += A B in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
// first; bhi and blo the shared-memory addresses of B's hi and lo k slices.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[N / 2], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bhi, uint32_t blo) {
  const uint64_t dh = desc(bhi), dl = desc(blo);
  Wgmma32<N>::mma(acc, al, dh);
  Wgmma32<N>::mma(acc, ah, dl);
  Wgmma32<N>::mma(acc, ah, dh);
}

// The A-tile rows (voxels) a thread gathers: rows r0 + 16 i, i < 8, all at
// granule column j = tid % 8 of each k tile. For each, its flat voxel index
// and a bit per tap (kd * 9 + kh * 3 + kw) whose shifted voxel lies inside
// the volume (0 for a row past M).
struct ConvRows {
  int vm[8];
  uint32_t taps[8];
};

__device__ __forceinline__ void conv_rows(ConvRows& rows, int m0, int r0, int M, int D, int H, int W) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + r0 + 16 * i;
    int t = m;
    const int w = t % W; t /= W;
    const int h = t % H; t /= H;
    const int d = t % D;
    // bit k of each: the window offset k - 1 along that axis stays inside
    const uint32_t dm = 2u | (d > 0 ? 1u : 0u) | (d + 1 < D ? 4u : 0u);
    const uint32_t hm = 2u | (h > 0 ? 1u : 0u) | (h + 1 < H ? 4u : 0u);
    const uint32_t wm = 2u | (w > 0 ? 1u : 0u) | (w + 1 < W ? 4u : 0u);
    uint32_t bits = 0;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap)
      if (((dm >> (tap / 9)) & (hm >> ((tap / 3) % 3)) & (wm >> (tap % 3)) & 1u) != 0) bits |= 1u << tap;
    rows.vm[i] = m;
    rows.taps[i] = m < M ? bits : 0u;
  }
}

// Start the cp.async copies of this thread's 8 A granules of k tile kt (one
// 128-byte row of K a tile: 8 granules of 16 / sizeof(T) channels) into
// the stage's A buffer sa.
template <typename T>
__device__ __forceinline__ void load_a_granules(uint32_t sa, const T* __restrict__ x, const ConvRows& rows, int kt,
                                                int H, int W, int C, int tid) {
  constexpr int EPG = 16 / sizeof(T);  // channels per granule
  const int j = tid & 7, r0 = tid >> 3;
  const int cg = C / EPG;              // granules per tap
  const int g = kt * 8 + j;            // this thread's granule along K
  const int q = g / cg;
  const int tap = q < 27 ? q : 27;     // 27: past 27 C, zeros
  const int c0 = (g - q * cg) * EPG;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int shift = ((kd - 1) * H + (kh - 1)) * W + (kw - 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool ok = tap < 27 && ((rows.taps[i] >> tap) & 1u);
    const T* src = ok ? x + (size_t)(rows.vm[i] + shift) * C + c0 : x;
    cp_async_ca(sa + swizzle(r0 + 16 * i, j), src, ok ? 16 : 0);
  }
}

// Start the cp.async copies of k tile kt into stage buffers sa (A) and sb
// (B): this thread's 8 A granules and its share of the N x 8 B granules.
template <int N>
__device__ __forceinline__ void load_stage(uint32_t sa, uint32_t sb, const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ wpk, const ConvRows& rows, int kt,
                                           int Kp, int H, int W, int C, int tid) {
  load_a_granules(sa, x, rows, kt, H, W, C, tid);
  for (int q = tid; q < N * 8; q += NTHREADS) {
    const int n = q >> 3, jj = q & 7;
    cp_async_cg(sb + swizzle(n, jj), wpk + (size_t)n * Kp + kt * BK + jj * 8);
  }
}

// The block's f32 accumulators of out[m0 + r][n], r < BM, n < N: acc[h][.]
// holds rows 64 h + 16 warp + lane / 4 (+ 8) in the wgmma m64nN layout.
// The ring is left empty on return.
template <int N>
__device__ __forceinline__ void conv_mainloop(float (&acc)[2][N / 2], uint8_t* ring,
                                              const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ wpk, int m0, int M, int D, int H,
                                              int W, int C) {
  constexpr int STAGE = stage_bytes(N);
  const int tid = threadIdx.x;
  const int Kp = (27 * C + BK - 1) / BK * BK;
  const int KT = Kp / BK;
  const uint32_t base = smem_addr(ring);

  ConvRows rows;
  conv_rows(rows, m0, tid >> 3, M, D, H, W);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[h][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage<N>(base + s * STAGE, base + s * STAGE + A_BYTES, x, wpk, rows, s, Kp, H, W, C, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();              // everyone's have; every wgmma of tile kt - 1 is done
    const uint32_t sa = base + (kt % STAGES) * STAGE;
    const uint32_t sb = sa + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // k slice kk is 32 bytes into each swizzled 128-byte row
      const uint64_t db = desc(sb + kk * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) Wgmma<N>::mma(acc[h], desc(sa + h * 64 * 128 + kk * 32), db);
    }
    wgmma_commit();
    // refill the stage tile kt - 1 used while the tensor cores work on kt
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const uint32_t na = base + (nk % STAGES) * STAGE;
      load_stage<N>(na, na + A_BYTES, x, wpk, rows, nk, Kp, H, W, C, tid);
    }
    cp_async_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------- f32: 3xTF32
constexpr int BK32 = 32;    // f32 reduction columns per stage: one 128-byte swizzle row
constexpr int STAGES32 = 2;

__host__ __device__ constexpr int stage_bytes_3xtf32(int n) { return A_BYTES + 2 * n * 128; }
__host__ __device__ constexpr int smem_bytes_3xtf32(int n) { return STAGES32 * stage_bytes_3xtf32(n) + 1024; }

// The f32 mainloop: acc as conv_mainloop's, from x (C % 4 == 0) and the
// split weight wpk [2][N][Kp] (hi, lo; Kp = 27 C rounded up to BK32).
template <int N>
__device__ __forceinline__ void conv_mainloop_3xtf32(float (&acc)[2][N / 2], uint8_t* ring,
                                                     const float* __restrict__ x, const float* __restrict__ wpk,
                                                     int m0, int M, int D, int H, int W, int C) {
  constexpr int STAGE = stage_bytes_3xtf32(N);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int Kp = (27 * C + BK32 - 1) / BK32 * BK32;
  const int KT = Kp / BK32;
  const uint32_t base = smem_addr(ring);

  ConvRows rows;
  conv_rows(rows, m0, tid >> 3, M, D, H, W);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[h][e] = 0.0f;

  // stage s: A [BM][32] at s * STAGE, then the B planes [N][32] hi and lo
  auto load = [&](int s, int kt) {
    const uint32_t sa = base + s * STAGE;
    load_a_granules(sa, x, rows, kt, H, W, C, tid);
    for (int q = tid; q < 2 * N * 8; q += NTHREADS) {
      const int p = q / (N * 8), e = q - p * (N * 8), n = e >> 3, jj = e & 7;
      cp_async_cg(sa + A_BYTES + p * N * 128 + swizzle(n, jj), wpk + ((size_t)p * N + n) * Kp + kt * BK32 + jj * 4);
    }
  };
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<0>();           // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();              // everyone's have; every wgmma of tile kt - 1 is done
    if (kt + 1 < KT) load((kt + 1) & 1, kt + 1);  // into the stage tile kt - 1 used
    cp_async_commit();
    const uint8_t* ta = ring + (kt & 1) * STAGE;
    const uint32_t sb = base + (kt & 1) * STAGE + A_BYTES;
    uint32_t ah[2][BK32 / 8][4], al[2][BK32 / 8][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < BK32 / 8; ++kk) a_fragment_3xtf32(ta, 64 * h + 16 * warp, 8 * kk, ah[h][kk], al[h][kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK32 / 8; ++kk)  // k slice kk is 32 bytes into each swizzled 128-byte row
#pragma unroll
      for (int h = 0; h < 2; ++h) mma_3xtf32<N>(acc[h], ah[h][kk], al[h][kk], sb + kk * 32, sb + N * 128 + kk * 32);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Write the block's outputs: epi(acc, n) gives out[m][n] for n < Co; they
// are staged as one [rows][Co] span in the (empty) ring and copied out in
// 16-byte stores (the span starts at m0 * Co * sizeof(OutT) bytes, a
// multiple of 16).
template <int N, class OutT, class Epi>
__device__ __forceinline__ void store_outputs(const float (&acc)[2][N / 2], uint8_t* ring, OutT* __restrict__ out,
                                              int m0, int M, int Co, const Epi& epi) {
  constexpr int EPV = 16 / sizeof(OutT);  // outputs per 16-byte store
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  OutT* tile = reinterpret_cast<OutT*>(ring);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int r = 64 * h + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
      const int n = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (n < Co) tile[r * Co + n] = epi(acc[h][e], n);
    }
  __syncthreads();
  const int rows = min(BM, M - m0);
  const int count = rows * Co;
  OutT* dst = out + (size_t)m0 * Co;
  const int vecs = count / EPV;
  for (int v = tid; v < vecs; v += NTHREADS)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(tile)[v];
  for (int e = vecs * EPV + tid; e < count; e += NTHREADS) dst[e] = tile[e];
}

// The kernel: one block per BM voxels, in voxel order.
template <int N, class Epi>
__global__ void __launch_bounds__(NTHREADS)
conv3d_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wpk,
                 __nv_bfloat16* __restrict__ out, Epi epi, int M, int D, int H, int W, int C, int Co) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.x * BM;
  float acc[2][N / 2];
  conv_mainloop<N>(acc, ring, x, wpk, m0, M, D, H, W, C);
  store_outputs<N>(acc, ring, out, m0, M, Co, epi);
}

// Launch conv3d_tc_kernel on s; returns the launch error.
template <int N, class Epi>
int launch_conv3d_tc(const void* x, const void* wpk, void* out, const Epi& epi, int B, int D, int H, int W,
                     int C, int Co, cudaStream_t s) {
  const long long M = (long long)B * D * H * W;
  auto kernel = conv3d_tc_kernel<N, Epi>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(N));
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<(unsigned)((M + BM - 1) / BM), NTHREADS, smem_bytes(N), s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<__nv_bfloat16*>(out), epi, (int)M, D, H, W, C, Co);
  return (int)cudaGetLastError();
}

// The f32 kernel: one block per BM voxels, in voxel order; two blocks an
// SM, three at N = 32 (168 registers a thread: T1's Co 32 sites, whose
// gather, not the products, sets the pace, so more warps hide more of its
// latency; at N = 64 168 registers spill).
template <int N, class Epi>
__global__ void __launch_bounds__(NTHREADS, N == 32 ? 3 : 2)
conv3d_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ wpk, float* __restrict__ out, Epi epi,
                     int M, int D, int H, int W, int C, int Co) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.x * BM;
  float acc[2][N / 2];
  conv_mainloop_3xtf32<N>(acc, ring, x, wpk, m0, M, D, H, W, C);
  store_outputs<N>(acc, ring, out, m0, M, Co, epi);
}

// Launch conv3d_3xtf32_kernel on s; returns the launch error.
template <int N, class Epi>
int launch_conv3d_3xtf32(const void* x, const void* wpk, void* out, const Epi& epi, int B, int D, int H, int W,
                         int C, int Co, cudaStream_t s) {
  const long long M = (long long)B * D * H * W;
  auto kernel = conv3d_3xtf32_kernel<N, Epi>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes_3xtf32(N));
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<(unsigned)((M + BM - 1) / BM), NTHREADS, smem_bytes_3xtf32(N), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wpk), static_cast<float*>(out), epi, (int)M, D, H, W,
      C, Co);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace dpf
