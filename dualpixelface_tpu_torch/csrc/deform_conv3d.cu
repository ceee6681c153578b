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
// f32 (the checks' exact sums): `deform_conv3d_kernel`, the first SIMT
// design: a block owns 128 output voxels x Cout; per tap it computes the 8
// corner indices and weights of its voxels once into shared memory, then
// builds the A tile (16 channels x 128 voxels) by weighted corner loads,
// rounds each sample to the input dtype, and runs the shared SIMT GEMM tile
// (common.cuh), exact f32 FMA on the CUDA cores.
#include "common.cuh"
#include "conv_tc.cuh"
#include "tma.cuh"

namespace {

using namespace dpf;

constexpr float EPS = 1.0f / 1024.0f;
constexpr float AP = 3.0f;
constexpr int CO = 64;  // the ANM deform convs' output channels, the only caller
constexpr int TN = 4;   // 16 * TN = CO: one block covers every output channel

// ---------------------------------------------------------------- f32: SIMT
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
deform_conv3d_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                     const T* __restrict__ wmat, const T* __restrict__ bias, T* __restrict__ out,
                     int B, int D, int H, int W, int C, int aperture) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][16 * TN];
  __shared__ int cidx[8][BM];   // corner voxel index, -1 when outside
  __shared__ float cwt[8][BM];  // corner weight
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int m0 = blockIdx.x * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 27; ++tap) {
    if (tid < BM) {
      const int m = m0 + tid;
      if (m < M) {
        int t = m;
        const int w = t % W; t /= W;
        const int h = t % H; t /= H;
        const int d = t % D;
        const int b = t / D;
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const T* op = offset + (size_t)m * 81 + tap * 3;
        const float pd = (float)(d - 1 + kd) + to_f32(op[0]);
        float ph = (float)(h - 1 + kh) + to_f32(op[1]);
        float pw = (float)(w - 1 + kw) + to_f32(op[2]);
        if (aperture) {
          ph = fminf(fmaxf(ph, (float)h - AP), (float)h + AP + 1.0f - EPS);
          pw = fminf(fmaxf(pw, (float)w - AP), (float)w + AP + 1.0f - EPS);
        }
        const float d0 = floorf(pd), h0 = floorf(ph), w0 = floorf(pw);
        const float fd = pd - d0, fh = ph - h0, fw = pw - w0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int cz = q >> 2, cy = (q >> 1) & 1, cx = q & 1;
          const float zi = d0 + cz, yi = h0 + cy, xi = w0 + cx;
          const bool ok = zi >= 0.0f && zi <= (float)(D - 1) && yi >= 0.0f &&
                          yi <= (float)(H - 1) && xi >= 0.0f && xi <= (float)(W - 1);
          const float wz = cz ? fd : 1.0f - fd;
          const float wy = cy ? fh : 1.0f - fh;
          const float wx = cx ? fw : 1.0f - fw;
          cidx[q][tid] = ok ? ((b * D + (int)zi) * H + (int)yi) * W + (int)xi : -1;
          cwt[q][tid] = ok ? (wz * wy) * wx : 0.0f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          cidx[q][tid] = -1;
          cwt[q][tid] = 0.0f;
        }
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += BK) {
      const int c = c0 + tx;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int ml = ty + 16 * r;
        float s = 0.0f;
        if (c < C) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int id = cidx[q][ml];
            if (id >= 0) s += cwt[q][ml] * to_f32(x[(size_t)id * C + c]);
          }
        }
        As[tx][ml] = round_to<T>(s);
      }
      load_b_tile<T, TN>(Bs, wmat, tap * C + c0, min(BK, C - c0), CO, tid);
      __syncthreads();
      mma_tile<TN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }
  store_tile<T, TN>(out, bias, acc, m0, M, CO, tx, ty);
}

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

// CP: x's padded channels (40 or 64). xp [M, CP], offset [M, 81], wmap over
// wpk [27 KP, 64] (zero rows past C), bias [64] or null, out [M, 64]; bf16.
template <int CP>
__global__ void __launch_bounds__(NT, 2)
deform_fwd_tc_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ offset, const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int M, int D, int H, int W, int aperture) {
  constexpr int KP = k_rows(CP);
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
      tma::load_2d(sm + S::w + t * S::w_slot, &wmap, &full[t], 0, t * KP);
    }
  }

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  const int r0 = WV * warp;  // the warp's first row: 16 of its warpgroup's 64
  const int grp = lane / GS, c = CPL * (lane - grp * GS);
  const bool lane_on = grp < GPW;
  const float dmax = (float)(D - 1), hmax = (float)(H - 1), wmax = (float)(W - 1);
  // the warp's corner phase: lane l takes voxel r0 + l / 2, the z plane l % 2
  const int cv = lane >> 1, cz = lane & 1;
  const int4 cvx = vox[r0 + cv];

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    uint8_t* at = sm + S::a + (tap & 1) * A_TILE;
    {
      // the tap's 8 corners of the warp's 16 voxels, 4 a lane: clamped
      // indices (always inside the tensor) and weights, zero for a corner
      // outside the volume or a voxel past M
      const __nv_bfloat16* op = offs + (r0 + cv) * 81 + tap * 3;
      const float pd = (float)(cvx.x - 1 + kd) + __bfloat162float(op[0]);
      float ph = (float)(cvx.y - 1 + kh) + __bfloat162float(op[1]);
      float pw = (float)(cvx.z - 1 + kw) + __bfloat162float(op[2]);
      if (aperture) {
        ph = fminf(fmaxf(ph, (float)cvx.y - AP), (float)cvx.y + AP + 1.0f - EPS);
        pw = fminf(fmaxf(pw, (float)cvx.z - AP), (float)cvx.z + AP + 1.0f - EPS);
      }
      int z0, z1, y0, y1, x0, x1;
      float wz0, wz1, wy0, wy1, wx0, wx1;
      axis(pd, dmax, z0, z1, wz0, wz1);
      axis(ph, hmax, y0, y1, wy0, wy1);
      axis(pw, wmax, x0, x1, wx0, wx1);
      const float wz = cvx.x < 0 ? 0.0f : (cz ? wz1 : wz0);
      const int zb = cvx.w + (cz ? z1 : z0) * HW;
      __syncwarp();  // the warp's reads of the last tap's corners are done
      wcorner[cv * 4 + cz] = make_int4(zb + y0 * W + x0, zb + y0 * W + x1, zb + y1 * W + x0, zb + y1 * W + x1);
      wcorner[cv * 4 + 2 + cz] = make_int4(__float_as_int((wz * wy0) * wx0), __float_as_int((wz * wy0) * wx1),
                                           __float_as_int((wz * wy1) * wx0), __float_as_int((wz * wy1) * wx1));
      __syncwarp();
    }
    // the gather: this warp's 16 rows of the A tile, which only its
    // warpgroup's wgmma of tap - 2 read (done: wgmma_wait<1> at tap - 1)
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
      for (int q = 0; q < 8; ++q) xr[q] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)id[q] * CP + c));
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
    __syncthreads();          // the A hand-off; every wgmma of tap - 2 is done
    if (tid == 0 && tap >= 1 && tap + 1 < 27) {  // the next tap's rows, into the slot tap - 2 used
      const int s = (tap + 1) % STAGES;
      tma::mbar_expect_tx(&full[s], S::w_slot);
      tma::load_2d(sm + S::w + s * S::w_slot, &wmap, &full[s], 0, (tap + 1) * KP);
    }
    const int s = tap % STAGES;
    tma::mbar_wait(&full[s], (tap / STAGES) & 1);
    const uint32_t sa = base + S::a + (tap & 1) * A_TILE + wg * 64 * 128;
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
      v0 += __bfloat162float(bias[n]);
      v1 += __bfloat162float(bias[n + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(st + tc::swizzle(r, n >> 3) + (n & 7) * 2) = __floats2bfloat162_rn(v0, v1);
  }
  __syncthreads();
  // the block's rows: one contiguous span from byte 128 m0, in 16-byte stores
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)m0 * CO);
  for (int g = tid; g < rows * 8; g += NT) dst[g] = *reinterpret_cast<const uint4*>(st + tc::swizzle(g >> 3, g & 7));
}

template <int CP>
int launch_tc(cudaStream_t s, const void* xp, const void* offset, const void* wpk, const void* bias, void* out,
              int M, int D, int H, int W, int aperture) {
  constexpr int KP = k_rows(CP);
  CUtensorMap wm;
  const uint64_t dims[2] = {(uint64_t)CO, (uint64_t)27 * KP};
  const uint64_t stride[1] = {(uint64_t)CO * 2};
  const uint32_t box[2] = {CO, KP};
  const int rc = tma::encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wpk, dims, stride, box);
  if (rc != 0) return rc;
  auto kernel = deform_fwd_tc_kernel<CP>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem<KP>::bytes);
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<(unsigned)((M + TBM - 1) / TBM), NT, FwdSmem<KP>::bytes, s>>>(
      wm, static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(offset),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, D, H, W, aperture);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 route (the SIMT kernel). x [B, D, H, W, C], offset [B, D, H, W, 81]
// (tap-major (dD, dH, dW)), wmat [27*C, CO], bias [CO] or null, out
// [B, D, H, W, CO]; f32, contiguous. Returns cudaErrorInvalidValue for
// Co != CO, else cudaGetLastError() after the launch.
extern "C" int dpf_deform_conv3d(const void* x, const void* offset, const void* wmat, const void* bias, void* out,
                                 int B, int D, int H, int W, int C, int Co, int aperture, void* stream) {
  if (Co != CO) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * D * H * W;
  deform_conv3d_kernel<float><<<(unsigned)((M + dpf::BM - 1) / dpf::BM), dpf::NTHREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(offset), static_cast<const float*>(wmat),
      static_cast<const float*>(bias), static_cast<float*>(out), B, D, H, W, C, aperture);
  return (int)cudaGetLastError();
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
  return CP == 40 ? launch_tc<40>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture)
                  : launch_tc<64>(s, xp, offset, wpk, bias, out, M, D, H, W, aperture);
}

// Dynamic shared memory of the tensor-core block for CP = 40 or 64, for the
// build report.
extern "C" int dpf_deform_conv3d_tc_smem_bytes(int cp) {
  return cp == 40 ? FwdSmem<k_rows(40)>::bytes : FwdSmem<k_rows(64)>::bytes;
}
