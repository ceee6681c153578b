// K1: deformable 3x3x3 convolution, stride 1, pad 1, NDHWC, f32 or bf16.
//
// Replaces the TPU kernel `deform_conv3d_fused` -> `_fused_call` (`_kernel`
// v5; dualpixelface_tpu/ops/kernels/deform_fused.py:598, call at :557).
// Semantics (the JAX package's `_deform_conv3d_packed`): for output voxel
// (d, h, w) and tap (kd, kh, kw), the sampling position is
//   (d - 1 + kd + dD, h - 1 + kh + dH, w - 1 + kw + dW)
// with the offsets read as f32; with `aperture` set, the H and W positions
// are clamped to [out - 3, out + 4 - 1/1024] (the windowed semantics of the
// TPU kernel), D never. Each position is sampled trilinearly, a corner
// outside the volume contributing zero; the 8 corners are summed in f32 in
// corner order q = 4 cz + 2 cy + cx and the sample rounded to the input
// dtype. The samples (27 taps x Cin) are contracted against the weight
// [27*Cin, Cout] with f32 accumulation; the output is rounded to the input
// dtype and the bias added in that dtype.
//
// Bound on the H100, at the serving pair of calls (x [4, 4, 192, 144, Cin],
// Cin 35 then 64): operations, the f32 gather work on the CUDA cores (15
// operations per voxel, tap and input channel: 17.7 GFLOP, 0.265 ms at 67
// TFLOP/s), above the contractions (151.4 GFLOP bf16, 0.153 ms at 989
// TFLOP/s) and the bytes that must move (about 344 MB in bf16, 0.103 ms at
// 3.35 TB/s). The TPU kernel expressed the gather as one-hot matmuls over a
// +-3 window because its vector unit has no cheap gather; here the gather
// is a plain load, so no window limits it and one kernel serves both
// semantics. Two routes, by dtype:
//
// bf16 (serving, and the train path's forward): `deform_fwd_tc_kernel`, the
// contraction on the tensor cores. A block of two warpgroups owns BM = 128
// consecutive voxels x all 64 output channels and walks the 27 taps; each
// warpgroup owns one m64 row tile and keeps its m64n64 f32 accumulator in
// registers (32 a thread) for the whole walk. x comes padded to CP = 40 or
// 64 channels (a voxel-corner row is 80 or 128 aligned bytes) and the
// weight as each tap's rows [27, KP, 64], zero past Cin, KP = 48 or 64 (the
// wgmma K step is 16; the A tile's channels CP..KP-1 are zeroed once at
// block start and never written again). The block's offsets are one
// contiguous span of 128 x 81 bf16 = 20,736 bytes, loaded once into shared
// memory in 16-byte loads (a 2-D tensor map cannot name it: its row stride,
// 162 bytes, is no multiple of 16). Per tap:
//   * the corners, per warp and with no block barrier: each warp owns 16 of
//     its warpgroup's 64 rows, and lane l computes voxel l / 2's position,
//     clamp and floor and the 4 corners of its z plane l % 2: indices
//     clamped into the volume and weights zeroed for a corner outside it
//     (the plain version's clamp and mask, so every load is in bounds and
//     needs no predicate). They go to the warp's 1 KB of shared memory
//     between two `__syncwarp`s: the 40-odd operations of a voxel's corners
//     are spread over 2 lanes, not repeated in each of its CP / 8 lanes;
//   * the gather: CP / 8 lanes per voxel, 8 channels a lane. A lane reads its
//     voxel's 8 indices and weights (4 broadcast 16-byte reads), issues its
//     8 corners' 16-byte loads of x together, sums them in f32 in corner
//     order, rounds to bf16 and writes one 16-byte store into the warp's
//     rows of the A tile [128 voxels][64 channels] (K-major, 128-byte
//     swizzle);
//   * the weight: the tap's rows [KP][64], n contiguous, arrive by TMA
//     (tma.cuh; a 2-D map over [27 KP, 64], box {64, KP}) into a ring of
//     three slots with one full mbarrier each, issued one tap ahead; wgmma
//     reads them MN-major through the transpose-B flag;
//   * one barrier (the A hand-off, after `fence.proxy.async`), then each
//     warpgroup issues its KP / 16 `wgmma` m64n64k16 and leaves the group in
//     flight: the A tile is double-buffered, so the gather of tap t + 1 runs
//     while the tensor cores work on tap t (`wgmma_wait<1>` before a buffer
//     is rewritten). The barrier also orders the ring: when it passes, every
//     wgmma of tap t - 2 is done, so the slot of tap t + 1 is free (no empty
//     barriers are needed).
// The epilogue rounds the accumulators to bf16, adds the bias in bf16,
// stages the tile in shared memory (swizzled) and stores the block's
// contiguous 128 x 64 x 2 = 16 KB span in 16-byte stores; rows past M are
// not stored. Shared memory: 2 x 16 KB of A, 3 x 6 or 8 KB of weight ring,
// 20.25 KB of offsets, 2 KB of per-voxel coordinates and 8 KB of per-warp
// corners, 83,224 or 89,368 bytes with the alignment pad, so two blocks
// fit on an SM. What holds it (`tools.bench_k1_split`), in about equal
// parts: the loads of x (most of their cost the traffic beyond L1) and
// issuing the gather's instructions (per voxel, tap and channel 8 FMA and 8
// bf16 -> f32 conversions); the contraction hides under the gather.
//
// f32 (every committed run config trains in f32; the f32 Predictor):
// `deform_fwd_3xtf32_kernel`, the bf16 route's per-warp corner phase and
// gather with the contraction in split-TF32 (3xTF32: each f32 operand split
// into two bit-masked TF32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi added
// into the f32 accumulator, the small terms first; conv_tc.cuh), which
// keeps IEEE f32's accuracy where one TF32 pass would not
// (`ops/kernels/split_f32.py`). The sample is not rounded and the bias is
// added in f32. At the trainer's batch 4 ([4, 4, 192, 144, Cin], Cin 35 and
// 64) the contractions are 151.4 GFLOP, 454 as TF32 (0.917 ms at 495
// TFLOP/s), beside the gathers' 17.7 GFLOP on the CUDA cores (0.265 ms) and
// about 0.7 GB of f32 x, offsets and output (0.21 ms at 3.35 TB/s): the
// tensor cores bound it. x comes padded to CP = 40 or 64 f32 channels (160-
// or 256-byte rows). The design:
//   * the block: 16 warps (four warpgroups, each one m64 row tile of the
//     m64n64 f32 accumulator, 32 registers a thread for the 27 taps) over a
//     tile of 16 H rows x 16 W columns of one (batch, depth) plane, a row a
//     warp. A square tile samples a smaller neighbourhood of x than as many
//     voxels in a line, and one block an SM leaves L1 more room than two
//     blocks of 8 warps (each of these timed faster on the card);
//   * the weight: TF32 `wgmma` has no transpose flags, so B is K-major: per
//     tap a plane [64 output channels][CP], split by the wrapper into hi and
//     lo planes [2, 27, 64, CP] (`pack_deform_fwd_3xtf32`), zero past Cin.
//     A tap's plane is two K panels [64][32] in the 128-byte swizzle (a
//     swizzle row holds 32 f32; at CP = 40 the second panel's box reads 8
//     columns and TMA fills the other 24 with zeros, which no k slice
//     reads): 32 KB a tap for hi and lo, by TMA into a ring of two slots;
//   * the corners: the bf16 route's per-warp phase, the offsets read as f32
//     from global memory (each lane loads its voxel's three of the next tap
//     while the gather runs: no block-wide span of offsets in shared
//     memory: the ring and the A rows would leave L1 a quarter less);
//   * the gather: 4 channels a lane, CP / 4 lanes per voxel (the warp's 16
//     voxels x CP / 4 chunks make 5 or 8 items a lane, every lane busy); a
//     lane issues its 8 corners' 16-byte loads of x before it uses the
//     first, and sums the sample in corner order as a product then a sum,
//     each rounded (no FMA contraction), as the plain version does: the
//     samples equal its `cols` bit for bit. One 16-byte store of the raw
//     sample into the warp's own rows [16][CP + 4] of shared memory;
//   * the A operand, option 1 of the two: each warp reads its own 16 rows
//     back as wgmma's register A fragments and splits them there, so wgmma
//     never reads A from shared memory and no block barrier hands A over
//     (a warp's 16 rows of its warpgroup's m64 tile are the rows it
//     gathered; `__syncwarp` orders its stores before its reads). The layout
//     is free of the swizzle: the row stride CP + 4 floats puts a fragment
//     read's 8 rows x 4 columns on 32 distinct banks, and a quarter-warp's
//     16-byte stores on 32 banks at CP = 64. Option 2, the split planes
//     stored K-major for wgmma to read, would double the A rows in shared
//     memory (another 68 KB at CP = 64), which L1 pays for;
//   * the contraction: per tap CP / 8 k slices of three `wgmma` m64n64k8
//     TF32, in rounds of 4 (CP = 64) or 5 (CP = 40) k slices whose split
//     fragments are in registers at once, each round waited for before the
//     next reuses them; the accumulator (32 f32 a thread) stays in
//     registers for the 27 taps. A warpgroup's gather does not overlap its
//     own MMAs: the other three warpgroups fill in;
//   * the ring, with no block barrier either: after its tap's last round
//     each warp adds one to its slot's count in shared memory, and the
//     sixteenth warp to do so (every wgmma that read the slot is then done)
//     issues the TMA loads of tap + 2 into it. So one warpgroup may finish
//     tap t + 1 while another still works on tap t (a third slot gained
//     nothing);
//   * the epilogue adds the bias in f32 and stores each warp's voxels from
//     the accumulator's registers (float2 stores that write whole 32-byte
//     sectors); voxels outside the plane are not stored.
// Shared memory: a 64 KB ring, 16 x (CP + 4) f32 a warp (44 or 68 KB), 16
// KB of per-warp corners: 128,024 or 152,600 bytes with the alignment pad,
// one block an SM at up to 128 registers a thread. The gather's 16-byte
// loads move about 40 GB through L1 at the trainer's shape (twice the bf16
// route's bytes), about 1.2 ms at L1's 128 bytes a clock an SM.
//
// Other widths (the TPU kernel takes any Cin and Co): both routes' wide
// forms, the CP = 64 kernels instantiated with WIDE (`dpf_deform_conv3d_wide`).
// x comes padded to 64 nch channels and the block walks 27 nch steps (tap,
// 64-channel chunk) through the same ring and A rows, forming a tap's
// corners at its first chunk: Cin past 64 is more K steps into the same f32
// accumulator, so the output is rounded once. Co is padded with zero weight
// columns to whole N tiles of 64, each a block of its own on the grid's y
// (each gathers its voxels again: the simplest right design; keeping the
// gathered A tile for every N tile would need the A tiles of all chunks in
// shared memory or more accumulator registers than a block of 2 warpgroups
// has). The committed widths (Cin 35 and 64, Co 64) keep the tuned forms.
#include "conv_tc.cuh"
#include "tma.cuh"

namespace {

using namespace dpf;

constexpr float EPS = 1.0f / 1024.0f;
constexpr float AP = 3.0f;
constexpr int CO = 64;  // the tuned forms' output channels (the committed ANM's), the wide forms' N tile

// ------------------------------------------------------- bf16: tensor cores
constexpr int TBM = 128;             // voxels per block: two m64 row tiles
constexpr int NT = 256;              // two warpgroups
constexpr int A_TILE = TBM * 128;    // A bf16 [128 voxels][64 channels]: 128-byte rows
constexpr int STAGES = 3;            // the weight ring
constexpr int OFF_BYTES = TBM * 81 * 2;

// Shared memory of the tensor-core block for KP weight rows per tap
// (offsets from a 1024-aligned base).
template <int KP> struct FwdSmem {
  static constexpr int a = 0;                         // two A tiles
  static constexpr int w_slot = KP * CO * 2;          // a tap's weight rows [KP][64]
  static constexpr int w = a + 2 * A_TILE;            // the weight ring
  static constexpr int off = w + STAGES * w_slot;     // the block's offsets [128][81]
  static constexpr int vox = off + OFF_BYTES;         // per voxel: d, h, w, its batch's first voxel
  static constexpr int corners = vox + TBM * 16;      // per warp, the tap's corners of its 16 voxels
  static constexpr int bars = corners + TBM * 64;     // full[STAGES]
  static constexpr int bytes = bars + STAGES * 8 + 1024;
};

// The wgmma K rows of CP channels: CP rounded up to the K step of 16.
__host__ __device__ constexpr int k_rows(int cp) { return (cp + 15) / 16 * 16; }

constexpr int CPL = 8;        // channels a gather lane takes: one 16-byte load a corner
constexpr int WV = TBM / 8;   // voxels a warp gathers: 16 of its warpgroup's 64 rows

// s[i] += w * v[i] over the 8 channels of a 16-byte chunk, in f32.
__device__ __forceinline__ void add_corner(float (&s)[CPL], float w, const uint4& v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    s[2 * i] += w * f.x;
    s[2 * i + 1] += w * f.y;
  }
}

// One axis of a trilinear sample at position p on [0, n - 1]: the floor
// and ceil corners' coordinates clamped into the axis (i0, i1) and their
// weights, zero for a corner outside it (the plain version's clamp and
// mask).
__device__ __forceinline__ void axis(float p, float nmax, int& i0, int& i1, float& w0, float& w1) {
  const float f0 = floorf(p), fr = p - f0;
  w0 = f0 >= 0.0f && f0 <= nmax ? 1.0f - fr : 0.0f;
  w1 = f0 + 1.0f >= 0.0f && f0 + 1.0f <= nmax ? fr : 0.0f;
  i0 = (int)fminf(fmaxf(f0, 0.0f), nmax);
  i1 = (int)fminf(fmaxf(f0 + 1.0f, 0.0f), nmax);
}

// The per-warp corner phase of one tap: lane l takes voxel cv = l / 2 of
// the warp's 16 (coordinates v, offsets o of this tap) and the 4 corners of
// its z plane cz = l % 2, and writes them to the warp's corners wc: per
// voxel 8 indices, then 8 weights, in corner order. Indices are clamped
// into the volume (every load is in bounds) and weights zero for a corner
// outside it or a voxel that is not there (v.x < 0).
__device__ __forceinline__ void tap_corners(int4* wc, int cv, int cz, int4 v, int tap, float o0, float o1, float o2,
                                            int D, int H, int W, int aperture) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const float pd = (float)(v.x - 1 + kd) + o0;
  float ph = (float)(v.y - 1 + kh) + o1;
  float pw = (float)(v.z - 1 + kw) + o2;
  if (aperture) {
    ph = fminf(fmaxf(ph, (float)v.y - AP), (float)v.y + AP + 1.0f - EPS);
    pw = fminf(fmaxf(pw, (float)v.z - AP), (float)v.z + AP + 1.0f - EPS);
  }
  int z0, z1, y0, y1, x0, x1;
  float wz0, wz1, wy0, wy1, wx0, wx1;
  axis(pd, (float)(D - 1), z0, z1, wz0, wz1);
  axis(ph, (float)(H - 1), y0, y1, wy0, wy1);
  axis(pw, (float)(W - 1), x0, x1, wx0, wx1);
  const float wz = v.x < 0 ? 0.0f : (cz ? wz1 : wz0);
  const int zb = v.w + (cz ? z1 : z0) * H * W;
  __syncwarp();  // the warp's reads of the last tap's corners are done
  wc[cv * 4 + cz] = make_int4(zb + y0 * W + x0, zb + y0 * W + x1, zb + y1 * W + x0, zb + y1 * W + x1);
  wc[cv * 4 + 2 + cz] = make_int4(__float_as_int((wz * wy0) * wx0), __float_as_int((wz * wy0) * wx1),
                                  __float_as_int((wz * wy1) * wx0), __float_as_int((wz * wy1) * wx1));
  __syncwarp();
}

// CP: x's padded channels (40 or 64). xp [M, CP], offset [M, 81], wmap over
// wpk [27 KP, 64] (zero rows past C), bias [64] or null, out [M, 64]; bf16.
// WIDE (CP = 64 only): x comes as nch chunks of 64 channels (xp [M, 64 nch])
// and the block walks 27 nch steps (tap, chunk), the chunk's samples the A
// tile and the weight rows [27 nch 64, cop] the ring's, the corners formed at
// a tap's first chunk: more K steps into the same accumulator, so the output
// is still rounded once. Co is cop / 64 N tiles on the grid's y (each block
// gathers its voxels again: right, not fast), bias [cop] or null, out
// [M, cop]; the wrapper pads the weight's and the bias's columns with zeros
// up to cop and slices the output.
template <int CP, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
deform_fwd_tc_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ offset, const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int D, int H, int W, int aperture, int nch_arg,
                     int cop_arg) {
  static_assert(!WIDE || CP == 64, "the wide form takes x in 64-channel chunks");
  constexpr int KP = k_rows(CP);
  const int nch = WIDE ? nch_arg : 1;              // x's chunks of CP channels
  const int cop = WIDE ? cop_arg : CO;             // the output's padded channels
  const int n0 = WIDE ? CO * (int)blockIdx.y : 0;  // the block's N tile
  const int ldx = nch * CP;                        // x's row
  const int steps = 27 * nch;
  using S = FwdSmem<KP>;
  constexpr int GS = CP / CPL;  // lanes per voxel
  constexpr int GPW = 32 / GS;  // voxels a warp gathers at once
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = tc::smem_addr(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  const __nv_bfloat16* offs = reinterpret_cast<const __nv_bfloat16*>(sm + S::off);
  int4* vox = reinterpret_cast<int4*>(sm + S::vox);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int m0 = blockIdx.x * TBM;
  const int rows = min(TBM, M - m0);
  const int HW = H * W;
  // this warp's corners of the tap: per voxel 8 indices, then 8 weights
  int4* wcorner = reinterpret_cast<int4*>(sm + S::corners + warp * WV * 64);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) tma::mbar_init(&full[s], 1);
    tma::fence_mbar_init();
  }
  {
    // the block's offsets: rows x 81 bf16 from byte 162 m0, a multiple of 16
    const int nbytes = rows * 81 * 2;
    const uint4* src = reinterpret_cast<const uint4*>(offset + (size_t)m0 * 81);
    for (int e = tid; e < nbytes / 16; e += NT) reinterpret_cast<uint4*>(sm + S::off)[e] = __ldg(src + e);
    for (int e = nbytes / 16 * 8 + tid; e < nbytes / 2; e += NT)
      reinterpret_cast<__nv_bfloat16*>(sm + S::off)[e] = offset[(size_t)m0 * 81 + e];
  }
  if (tid < TBM) {
    // d, h, w of the voxel and the flat index of its batch's first voxel;
    // d = -1 past M
    const int m = m0 + tid;
    int4 v = make_int4(-1, 0, 0, 0);
    if (m < M) {
      int t = m;
      const int w = t % W; t /= W;
      const int h = t % H; t /= H;
      const int d = t % D;
      v = make_int4(d, h, w, (t - d) * HW);
    }
    vox[tid] = v;
  }
  if (CP < KP)  // the A tiles' channels CP..KP-1 (one granule) stay zero
    for (int r = tid; r < 2 * TBM; r += NT)
      *reinterpret_cast<uint4*>(sm + S::a + tc::swizzle(r, CP / 8)) = make_uint4(0u, 0u, 0u, 0u);
  tc::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      tma::mbar_expect_tx(&full[t], S::w_slot);
      tma::load_2d(sm + S::w + t * S::w_slot, &wmap, &full[t], n0, t * KP);
    }
  }

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  const int r0 = WV * warp;  // the warp's first row: 16 of its warpgroup's 64
  const int grp = lane / GS, c = CPL * (lane - grp * GS);
  const bool lane_on = grp < GPW;
  // the warp's corner phase: lane l takes voxel r0 + l / 2, the z plane l % 2
  const int cv = lane >> 1, cz = lane & 1;
  const int4 cvx = vox[r0 + cv];

  for (int step = 0; step < steps; ++step) {
    const int tap = WIDE ? step / nch : step;
    const int cb = WIDE ? (step - tap * nch) * CP : 0;  // the step's first channel
    uint8_t* at = sm + S::a + (step & 1) * A_TILE;
    if (cb == 0) {
      const __nv_bfloat16* op = offs + (r0 + cv) * 81 + tap * 3;
      tap_corners(wcorner, cv, cz, cvx, tap, __bfloat162float(op[0]), __bfloat162float(op[1]),
                  __bfloat162float(op[2]), D, H, W, aperture);
    }
    // the gather: this warp's 16 rows of the A tile, which only its
    // warpgroup's wgmma of step - 2 read (done: wgmma_wait<1> at step - 1)
#pragma unroll
    for (int v0 = 0; v0 < WV; v0 += GPW) {
      const int v = v0 + grp;
      if (!lane_on || v >= WV) continue;
      const int4 ia = wcorner[v * 4], ib = wcorner[v * 4 + 1];
      const int4 wa = wcorner[v * 4 + 2], wb = wcorner[v * 4 + 3];
      const int id[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
      const int wbits[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      uint4 xr[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) xr[q] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * ldx + cb + c));
      // the sample in f32 in corner order, rounded to bf16: one 16-byte store
      float s[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) s[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) add_corner(s, __int_as_float(wbits[q]), xr[q]);
      uint4 packed;
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < CPL / 2; ++i) pk[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
      *reinterpret_cast<uint4*>(at + tc::swizzle(r0 + v, c >> 3)) = packed;
    }
    tc::fence_proxy_async();  // the A tile, written by the generic proxy, is read by wgmma
    __syncthreads();          // the A hand-off; every wgmma of step - 2 is done
    if (tid == 0 && step >= 1 && step + 1 < steps) {  // the next step's rows, into the slot step - 2 used
      const int s = (step + 1) % STAGES;
      tma::mbar_expect_tx(&full[s], S::w_slot);
      tma::load_2d(sm + S::w + s * S::w_slot, &wmap, &full[s], n0, (step + 1) * KP);
    }
    const int s = step % STAGES;
    tma::mbar_wait(&full[s], (step / STAGES) & 1);
    const uint32_t sa = base + S::a + (step & 1) * A_TILE + wg * 64 * 128;
    const uint32_t sb = base + S::w + s * S::w_slot;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) tc::Wgmma<64, 0, 1>::mma(acc, tc::desc(sa + kk * 32), tc::desc(sb + kk * 2048));
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
  }
  tc::wgmma_wait<0>();

  // out = bf16(bf16(acc) + bias), staged (swizzled) in the first A tile: a
  // warpgroup writes its own rows, which only its own wgmma read
  uint8_t* st = sm + S::a;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int r = 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * ((e >> 1) & 1);
    const int n = 8 * (e >> 2) + 2 * (lane & 3);
    float v0 = __bfloat162float(__float2bfloat16_rn(acc[e]));
    float v1 = __bfloat162float(__float2bfloat16_rn(acc[e + 1]));
    if (bias != nullptr) {
      v0 += __bfloat162float(bias[n0 + n]);
      v1 += __bfloat162float(bias[n0 + n + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(st + tc::swizzle(r, n >> 3) + (n & 7) * 2) = __floats2bfloat162_rn(v0, v1);
  }
  __syncthreads();
  if constexpr (WIDE) {
    // the block's rows, 128 bytes each at column n0 of the out rows
    for (int g = tid; g < rows * 8; g += NT)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + (g >> 3)) * cop + n0 + 8 * (g & 7)) =
          *reinterpret_cast<const uint4*>(st + tc::swizzle(g >> 3, g & 7));
  } else {
    // the block's rows: one contiguous span from byte 128 m0, in 16-byte stores
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)m0 * CO);
    for (int g = tid; g < rows * 8; g += NT) dst[g] = *reinterpret_cast<const uint4*>(st + tc::swizzle(g >> 3, g & 7));
  }
}

// nch chunks of CP channels (1 unless WIDE), cop output channels (CO unless WIDE).
template <int CP, bool WIDE>
int launch_tc(cudaStream_t s, const void* xp, const void* offset, const void* wpk, const void* bias, void* out,
              int M, int D, int H, int W, int aperture, int nch, int cop) {
  constexpr int KP = k_rows(CP);
  CUtensorMap wm;
  const uint64_t dims[2] = {(uint64_t)cop, (uint64_t)27 * nch * KP};
  const uint64_t stride[1] = {(uint64_t)cop * 2};
  const uint32_t box[2] = {CO, KP};
  const int rc = tma::encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wpk, dims, stride, box);
  if (rc != 0) return rc;
  auto kernel = deform_fwd_tc_kernel<CP, WIDE>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<KP>::bytes);
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<dim3((unsigned)((M + TBM - 1) / TBM), (unsigned)(cop / CO)), NT, FwdSmem<KP>::bytes, s>>>(
      wm, static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(offset),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, D, H, W, aperture, nch, cop);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- f32: 3xTF32 tensor cores
constexpr int F_WARPS = 16;              // warps a block: a tile of F_WARPS rows (H) x WV columns (W), a row a warp
constexpr int F_BM = WV * F_WARPS;       // voxels a block
constexpr int F_NT = 32 * F_WARPS;
constexpr int F_STAGES = 2;              // the weight ring
constexpr int F_PANEL = CO * 128;        // a K panel of a weight plane: [64 n][32 k] f32, 128-byte rows
constexpr int F_SLOT = 4 * F_PANEL;      // a tap's hi and lo planes, two panels each

// Shared memory of the f32 block (offsets from a 1024-aligned base).
template <int CP> struct F32Smem {
  static constexpr int RS = CP + 4;                  // a sample row's stride in f32: fragment reads on 32 banks
  static constexpr int w = 0;                        // the weight ring
  static constexpr int a = w + F_STAGES * F_SLOT;    // per warp, its 16 rows of samples [16][RS]
  static constexpr int corners = a + F_BM * RS * 4;  // per warp, the tap's corners of its 16 voxels
  static constexpr int bars = corners + F_BM * 64;   // full[F_STAGES], then each slot's count of warps done
  static constexpr int bytes = bars + F_STAGES * 12 + 1024;
};

// The A fragment of Wgmma32 from a warp's 16 rows of f32 samples (row
// stride rs floats; rows lane / 4 + 8 (q & 1), columns k0 + lane % 4 +
// 4 (q >> 1)), split into TF32 hi and lo.
__device__ __forceinline__ void sample_fragment(const float* rows, int rs, int k0, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    tc::split_tf32(rows[((lane >> 2) + 8 * (q & 1)) * rs + k0 + (lane & 3) + 4 * (q >> 1)], hi[q], lo[q]);
}

// A step's hi and lo weight planes (maps hi, lo; the step's K columns from
// k0, its 64 N rows from row), two K panels each, into the ring slot at
// dst, reported to bar.
__device__ __forceinline__ void load_tap_3xtf32(uint8_t* dst, const CUtensorMap* hi, const CUtensorMap* lo,
                                                uint64_t* bar, int k0, int row) {
  tma::mbar_expect_tx(bar, F_SLOT);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    tma::load_2d(dst + p * F_PANEL, hi, bar, k0 + 32 * p, row);
    tma::load_2d(dst + (2 + p) * F_PANEL, lo, bar, k0 + 32 * p, row);
  }
}

// s += w * v channel by channel, the product and the sum each rounded (no
// FMA): the plain version's `cols += weight * x`.
__device__ __forceinline__ void add_corner_f32(float4& s, float w, const float4& v) {
  s.x = __fadd_rn(s.x, __fmul_rn(w, v.x));
  s.y = __fadd_rn(s.y, __fmul_rn(w, v.y));
  s.z = __fadd_rn(s.z, __fmul_rn(w, v.z));
  s.w = __fadd_rn(s.w, __fmul_rn(w, v.w));
}

// CP: x's padded channels (40 or 64). xp [M, CP], offset [M, 81], whmap and
// wlmap over the weight's hi and lo planes [27 x 64, CP] (zero past C),
// bias [64] or null, out [M, 64]; f32. WIDE (CP = 64 only), as the bf16
// route's: xp [M, 64 nch] walked in 27 nch steps (tap, chunk), the planes
// [27 x cop, 64 nch], the N tile on the grid's y, bias [cop], out [M, cop].
template <int CP, bool WIDE>
__global__ void __launch_bounds__(F_NT, 16 / F_WARPS)
deform_fwd_3xtf32_kernel(const __grid_constant__ CUtensorMap whmap, const __grid_constant__ CUtensorMap wlmap,
                         const float* __restrict__ x, const float* __restrict__ offset,
                         const float* __restrict__ bias, float* __restrict__ out, int D, int H, int W,
                         int aperture, int nch_arg, int cop_arg) {
  static_assert(!WIDE || CP == 64, "the wide form takes x in 64-channel chunks");
  using S = F32Smem<CP>;
  const int nch = WIDE ? nch_arg : 1;              // x's chunks of CP channels
  const int cop = WIDE ? cop_arg : CO;             // the output's padded channels
  const int n0 = WIDE ? CO * (int)blockIdx.y : 0;  // the block's N tile
  const int ldx = nch * CP;                        // x's row
  const int steps = 27 * nch;
  constexpr int KS = CP / 8;               // k slices of a tap
  constexpr int ROUND = CP == 64 ? 4 : 5;  // k slices whose split fragments are in registers at once
  constexpr int GS = CP / 4;               // gather lanes per voxel, 4 channels each
  constexpr int ITEMS = WV * GS / 32;      // a lane's (voxel, 4 channels) items per tap
  static_assert(KS % ROUND == 0 && (WV * GS) % 32 == 0, "the rounds and the items are whole");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = tc::smem_addr(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  unsigned* done = reinterpret_cast<unsigned*>(sm + S::bars + F_STAGES * 8);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block's tile: F_WARPS rows x WV columns from (h0, w0) of the
  // (batch, depth) plane bd; the warp's row is h = h0 + warp, its voxels j
  // the columns w0 + j (voxel index m_row + j), those inside the plane only
  const int tiles_w = (W + WV - 1) / WV, tiles_h = (H + F_WARPS - 1) / F_WARPS;
  const int bd = blockIdx.x / (tiles_w * tiles_h);
  const int h = (blockIdx.x / tiles_w) % tiles_h * F_WARPS + warp, w0 = blockIdx.x % tiles_w * WV;
  const int m_row = (bd * H + h) * W + w0;
  const int r0 = WV * warp;  // the warp's first row of the block's m64 tiles: 16 of its warpgroup's 64
  float* rows = reinterpret_cast<float*>(sm + S::a) + r0 * S::RS;
  int4* wcorner = reinterpret_cast<int4*>(sm + S::corners + warp * WV * 64);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < F_STAGES; ++s) {
      tma::mbar_init(&full[s], 1);
      done[s] = 0u;
    }
    tma::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < F_STAGES; ++t)
      load_tap_3xtf32(sm + S::w + t * F_SLOT, &whmap, &wlmap, &full[t], (t % nch) * CP, (t / nch) * cop + n0);
  }

  // the warp's corner phase: lane l takes its voxel l / 2, the z plane l % 2
  const int cv = lane >> 1, cz = lane & 1;
  const bool cin_plane = h < H && w0 + cv < W;
  const int4 cvx = cin_plane ? make_int4(bd % D, h, w0 + cv, (bd - bd % D) * H * W) : make_int4(-1, 0, 0, 0);
  const float* op = offset + (size_t)(cin_plane ? m_row + cv : 0) * 81;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
  if (cvx.x >= 0) {
    o0 = __ldg(op);
    o1 = __ldg(op + 1);
    o2 = __ldg(op + 2);
  }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int tap = WIDE ? step / nch : step;
    const int cb = WIDE ? (step - tap * nch) * CP : 0;  // the step's first channel
    if (cb == 0) {
      tap_corners(wcorner, cv, cz, cvx, tap, o0, o1, o2, D, H, W, aperture);
      if (cvx.x >= 0 && tap + 1 < 27) {  // the next tap's offsets, in flight during the gather
        o0 = __ldg(op + 3 * tap + 3);
        o1 = __ldg(op + 3 * tap + 4);
        o2 = __ldg(op + 3 * tap + 5);
      }
    } else {
      __syncwarp();  // the warp's fragment reads of the last step are done
    }
    // the gather: item i of a lane is voxel v, channels c .. c + 3
#pragma unroll 1
    for (int i = 0; i < ITEMS; ++i) {
      const int item = lane + 32 * i;
      const int v = item / GS, c = 4 * (item - v * GS);
      const int4 ia = wcorner[v * 4], ib = wcorner[v * 4 + 1];
      const int4 wa = wcorner[v * 4 + 2], wb = wcorner[v * 4 + 3];
      const int id[8] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
      const int wbits[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      float4 xr[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) xr[q] = __ldg(reinterpret_cast<const float4*>(x + (size_t)id[q] * ldx + cb + c));
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < 8; ++q) add_corner_f32(s, __int_as_float(wbits[q]), xr[q]);
      *reinterpret_cast<float4*>(rows + v * S::RS + c) = s;
    }
    __syncwarp();  // the warp's samples are stored before it reads them back as fragments

    const int slot = step % F_STAGES;
    tma::mbar_wait(&full[slot], (step / F_STAGES) & 1);
    const uint32_t sb = base + S::w + slot * F_SLOT;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += ROUND) {
      uint32_t ah[ROUND][4], al[ROUND][4];
#pragma unroll
      for (int kk = 0; kk < ROUND; ++kk) sample_fragment(rows, S::RS, 8 * (k0 + kk), ah[kk], al[kk]);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROUND; ++kk) {
        // k slice k: panel k / 4, 32 bytes a slice into its 128-byte rows; lo two panels on
        const int k = k0 + kk;
        const uint32_t bh = sb + (k >> 2) * F_PANEL + (k & 3) * 32;
        tc::mma_3xtf32<CO>(acc, ah[kk], al[kk], bh, bh + 2 * F_PANEL);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
    }
    // the warp is done with the slot; the last of the block's warps refills it
    if (lane == 0 && step + F_STAGES < steps) {
      __threadfence_block();
      if (atomicAdd(&done[slot], 1u) % F_WARPS == F_WARPS - 1) {
        const int next = step + F_STAGES;
        load_tap_3xtf32(sm + S::w + slot * F_SLOT, &whmap, &wlmap, &full[slot], (next % nch) * CP,
                        (next / nch) * cop + n0);
      }
    }
  }

  // out = acc + bias in f32, the warp's voxels from the accumulator's
  // registers: voxel lane / 4 (+ 8), columns 8 i + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int j = (lane >> 2) + 8 * ((e >> 1) & 1);
    const int n = 8 * (e >> 2) + 2 * (lane & 3);
    if (h >= H || w0 + j >= W) continue;
    float2 o = make_float2(acc[e], acc[e + 1]);
    if (bias != nullptr) o = make_float2(o.x + bias[n0 + n], o.y + bias[n0 + n + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(m_row + j) * cop + n0 + n) = o;
  }
}

// nch chunks of CP channels (1 unless WIDE), cop output channels (CO unless WIDE).
template <int CP, bool WIDE>
int launch_3xtf32(cudaStream_t s, const void* xp, const void* offset, const void* wsplit, const void* bias,
                  void* out, int M, int D, int H, int W, int aperture, int nch, int cop) {
  CUtensorMap whm, wlm;
  const uint64_t dims[2] = {(uint64_t)nch * CP, (uint64_t)27 * cop};
  const uint64_t stride[1] = {(uint64_t)nch * CP * 4};
  const uint32_t box[2] = {32, CO};  // 128-byte inner boxes: the swizzle's span
  const float* wlo = static_cast<const float*>(wsplit) + (size_t)27 * cop * nch * CP;
  int rc = tma::encode(&whm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, wsplit, dims, stride, box);
  if (rc == 0) rc = tma::encode(&wlm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, wlo, dims, stride, box);
  if (rc != 0) return rc;
  auto kernel = deform_fwd_3xtf32_kernel<CP, WIDE>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Smem<CP>::bytes);
  if (opted_in != cudaSuccess) return (int)opted_in;
  const int tiles = M / (H * W) * ((H + F_WARPS - 1) / F_WARPS) * ((W + WV - 1) / WV);
  kernel<<<dim3((unsigned)tiles, (unsigned)(cop / CO)), F_NT, F32Smem<CP>::bytes, s>>>(
      whm, wlm, static_cast<const float*>(xp), static_cast<const float*>(offset), static_cast<const float*>(bias),
      static_cast<float*>(out), D, H, W, aperture, nch, cop);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 route (3xTF32 on the tensor cores). xp [B, D, H, W, CP] (x padded
// with zero channels to CP = 40 or 64), offset [B, D, H, W, 81] (tap-major
// (dD, dH, dW)), wsplit [2][27, CO, CP] (each tap's weight plane, K
// contiguous, zero past C, split into TF32 hi and lo), bias [CO] or null,
// out [B, D, H, W, CO]; f32, contiguous. Returns cudaErrorInvalidValue for
// Co != CO, CP not 40 or 64, C outside 1..CP, M < 1 or an xp, wsplit or
// out not 16-byte aligned, else the first error of the tensor maps'
// encoding or the launch.
extern "C" int dpf_deform_conv3d_3xtf32(const void* xp, const void* offset, const void* wsplit, const void* bias,
                                        void* out, int B, int D, int H, int W, int C, int CP, int Co, int aperture,
                                        void* stream) {
  const int M = B * D * H * W;
  if (Co != CO || (CP != 40 && CP != 64) || C < 1 || C > CP || M < 1 ||
      ((uintptr_t)xp | (uintptr_t)wsplit | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CP == 40 ? launch_3xtf32<40, false>(s, xp, offset, wsplit, bias, out, M, D, H, W, aperture, 1, CO)
                  : launch_3xtf32<64, false>(s, xp, offset, wsplit, bias, out, M, D, H, W, aperture, 1, CO);
}

// bf16 route (the tensor-core kernel). xp [B, D, H, W, CP] (x padded with
// zero channels to CP = 40 or 64), offset [B, D, H, W, 81], wpk [27, KP, CO]
// (each tap's weight rows, zero past C; KP = CP rounded up to 16), bias
// [CO] or null, out [B, D, H, W, CO]; bf16, contiguous. Returns
// cudaErrorInvalidValue for Co != CO, CP not 40 or 64, C outside 1..CP,
// M < 1 or an xp, offset, wpk or out not 16-byte aligned, else the first
// error of the tensor map's encoding or the launch.
extern "C" int dpf_deform_conv3d_tc(const void* xp, const void* offset, const void* wpk, const void* bias,
                                    void* out, int B, int D, int H, int W, int C, int CP, int Co, int aperture,
                                    void* stream) {
  const int M = B * D * H * W;
  if (Co != CO || (CP != 40 && CP != 64) || C < 1 || C > CP || M < 1 ||
      ((uintptr_t)xp | (uintptr_t)offset | (uintptr_t)wpk | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CP == 40 ? launch_tc<40, false>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture, 1, CO)
                  : launch_tc<64, false>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture, 1, CO);
}

// The other widths, both routes (is_bf16 selects bf16, else f32): x padded
// to CPX = 64 nch channels (xp [B, D, H, W, CPX]) and the output to COP, a
// multiple of 64 (out [B, D, H, W, COP], bias [COP] or null, zero past Co).
// bf16: wpk [27, CPX, COP] (each tap's weight rows, zero past C and Co).
// f32: wpk [2][27, COP, CPX] (each tap's weight plane, K contiguous, split
// into TF32 hi and lo). Returns cudaErrorInvalidValue for CPX or COP not a
// positive multiple of 64, C outside 1..CPX, M < 1 or an xp, offset (bf16),
// wpk or out not 16-byte aligned, else the first error of the tensor maps'
// encoding or the launch.
extern "C" int dpf_deform_conv3d_wide(const void* xp, const void* offset, const void* wpk, const void* bias,
                                      void* out, int B, int D, int H, int W, int C, int CPX, int COP,
                                      int aperture, int is_bf16, void* stream) {
  const int M = B * D * H * W;
  if (CPX < 64 || CPX % 64 != 0 || COP < CO || COP % CO != 0 || C < 1 || C > CPX || M < 1 ||
      ((uintptr_t)xp | (is_bf16 ? (uintptr_t)offset : 0) | (uintptr_t)wpk | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_tc<64, true>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture, CPX / 64, COP)
                 : launch_3xtf32<64, true>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture, CPX / 64, COP);
}

// Dynamic shared memory of the tensor-core block for CP = 40 or 64, for the
// build report.
extern "C" int dpf_deform_conv3d_tc_smem_bytes(int cp) {
  return cp == 40 ? FwdSmem<k_rows(40)>::bytes : FwdSmem<k_rows(64)>::bytes;
}

// Dynamic shared memory of the f32 block for CP = 40 or 64, for the build
// report.
extern "C" int dpf_deform_conv3d_3xtf32_smem_bytes(int cp) {
  return cp == 40 ? F32Smem<40>::bytes : F32Smem<64>::bytes;
}
