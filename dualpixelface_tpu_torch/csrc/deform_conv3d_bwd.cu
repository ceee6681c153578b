// K2: backward of the deformable 3x3x3 convolution (K1), NDHWC, f32 or bf16.
//
// Replaces the TPU kernel `deform_conv3d_fused_bwd` -> `_fused_bwd_call`
// (`_bwd_kernel`; dualpixelface_tpu/ops/kernels/deform_fused.py:985, call at
// :933). Given the cotangent g [M, 64] of K1's output (M = B*D*H*W voxels),
// it returns the gradients of x, offset and the weight (the bias gradient is
// g summed over voxels, taken by the caller):
//   gcols[m, tap, c] = T(sum_n g[m, n] W[tap*C + c, n])   (rounded like cols)
//   gx[corner]      += corner weight * gcols               (scatter)
//   goff[m, tap, a]  = sum_c gcols * sum_q x[corner q, c] * d(weight q)/d(pos a)
//   gw[tap*C + c, n] = sum_m cols[m, tap, c] g[m, n]       (cols rounded to T)
// with the conventions of the plain version (autograd through
// `deform_conv3d_plain`) and of the TPU kernel's `_hat_grad`: floor-based
// corners (at an integer position the floor corner's derivative is -1, the
// ceil corner's +1), corners outside the volume contribute nothing, D
// unclamped, and with `aperture` the H/W clamp to [out - 3, out + 4 - 1/1024]
// passes the gradient with factor 1 strictly inside, 0.5 exactly on either
// bound (the derivative of min(max(p, lo), hi) at a tie) and 0 outside.
//
// Bound on the H100: operations. At the train path's shapes (B = 2,
// [2, 4, 192, 144, Cin], Cin 35 and 64) the two contractions (gcols and gw)
// are twice K1's, ~2 x 2 x 221184 x 27 x Cin x 64 FLOP on the tensor cores,
// beside ~31 GFLOP of f32 gather work (the samples, their derivatives, the
// gx scatter) on the CUDA cores, against ~290 MB that must move in bf16. At
// the trainer's f32 batch 4 the contractions are 302.7 GFLOP, 908 as
// 3xTF32 (1.84 ms at 495 TFLOP/s), beside 62.7 GFLOP of gather work (0.94
// ms on the CUDA cores).
// The TPU ran the forward's one-hot matmuls in reverse; the card has a cheap
// gather and f32 atomics, so this is a gather/scatter. Two routes:
//
// bf16 (the train path): `deform_bwd_tc_kernel`, the contractions on the
// tensor cores. A block of two warpgroups owns one tap and a strided share
// of the voxel tiles (BM = 128 voxels each; blocks of the same share walk
// the same tiles, so the 27 taps' reads of g and offset meet in L2). Per
// tile: the g tile [128 voxels x 64] arrives by TMA (tma.cuh; two buffers,
// the next tile's load in flight while this one is worked), beside the
// tap's weight rows [CP x 64], loaded once per block. Warpgroup 0 forms
// gcols = g . W_tap^T with `wgmma` m64nCPk16 (A the g tile, K-major as it
// lies; B the weight rows, K-major) and stages it rounded to bf16 (the
// rounding point of the plain version and of the TPU kernel's `gsb`),
// while warpgroup 1 computes the 8 corners of each voxel (one thread per
// voxel). Then all 256 threads gather and scatter: CP / 4 lanes per voxel,
// 4 channels a lane (x padded to CP = 40 channels for Cin <= 40, so a
// voxel-corner row is 80 or 128 aligned bytes), per corner one 8-byte load
// of x, the sample and its three derivative sums, and one 4-channel f32
// vector reduction into gx (`atomicAdd` on a float4: a quarter of the
// atomic instructions of one per channel, the same bytes; a voxel's 8
// corner loads are issued before any is used); the offset
// gradients are summed over the voxel's lanes with shuffles and stored
// rounded. The samples, rounded to bf16, go to shared memory as [voxel]
// [channel] rows (one 8-byte store a lane, the 128-byte swizzle), and
// warpgroup 0 adds gw += cols^T . g with `wgmma` m64n64k16, both operands
// MN-major over the voxels through the transpose flags (A the samples, B
// the same g tile that fed gcols). Each tile's m64n64 product is added
// into the block's f32 gw partial in shared memory (so no accumulator holds
// registers through the gather), written out once as a per-block partial
// sum (no atomics on gw).
//
// f32 (every committed run config trains in f32): `deform_bwd_3xtf32_kernel`,
// the same skeleton with its two contractions in split-TF32 (3xTF32:
// operands split into bit-masked TF32 halves, a_lo b_hi + a_hi b_lo +
// a_hi b_hi in the f32 accumulator, conv_tc.cuh), which keeps IEEE f32's
// accuracy where one TF32 pass would not. TF32 `wgmma` has no transpose
// flags, so both B operands are K-major and the g tile, raw f32 as TMA
// brings it ([voxel][n] in two 128-byte halves over n), is the A operand of
// both products, read from shared memory into registers and split there:
// gcols = g . W_tap^T (m64nCPk8, K = n; B the tap's weight rows, split by
// the wrapper into two planes [27][CP][64]) and gw^T = g^T . cols
// (m64nCPk8, K = the tile's voxels; B the samples, which the gather stores
// split, as [channel][voxel] rows). gcols and the samples stay f32 (no
// rounding point: the plain version's f32 sums). x is padded to CP = 40 or
// 64 f32 channels (160- or 256-byte rows): 16-byte corner loads, float4
// reductions into gx32, goff summed with shuffles and stored in f32. f32
// doubles every tile, so a tile is BM = 64 voxels (one m64 row tile): 105
// KB of shared memory at CP = 40 (two blocks of 8 warps an SM), 141 KB at
// 64 (one block of 16 warps). Warpgroup 0 runs the MMAs, warpgroup 1 the
// corners, every warp the gather.
//
// Both: a second pass adds the gw partials, and one casts gx32 (f32) to the
// input dtype, dropping the padded channels (f32 at C = CP: gx32 is gx).
//
// Other widths (the TPU kernel takes any Cin and Co): both routes' wide
// forms (`dpf_deform_conv3d_bwd_wide`; bf16 the CP = 64 kernel instantiated
// with WIDE, f32 `deform_bwd_3xtf32_wide_kernel`, a kernel of its own). x
// comes in 64-channel chunks and g and the weight rows with zero columns up
// to whole N tiles of 64; the grid's z gives each block one chunk and one N
// tile. gcols of a chunk needs every N tile (its K is Co) before its one
// rounding, so a block of N tile 0 forms it over the N tiles in turn (the g
// tile and the weight rows of each by TMA into the same buffers), then
// gathers and scatters its chunk, adds into gx and writes goff (directly
// with one chunk, else each chunk's f32 share, summed and rounded once by the
// second pass). Every block adds its N tile's gw; a block of another N tile
// forms no gcols and no derivative sums, and gathers again for its samples
// alone: right, not fast. The committed widths (Cin 35 and 64, Co 64) keep
// the tuned forms.
#include "common.cuh"
#include "conv_tc.cuh"
#include "tma.cuh"

namespace {

using namespace dpf;

constexpr float EPS = 1.0f / 1024.0f;
constexpr float AP = 3.0f;
constexpr int CO = 64;     // the tuned forms' output channels (the committed ANM's), the wide forms' N tile
constexpr int CMAX = 64;   // the tuned forms' largest Cin, the wide forms' chunk of x's channels
constexpr int NT = 256;    // threads per block (8 warps) of the bf16 route

// d/dpos of the aperture clamp min(max(pos, lo), hi).
__device__ __forceinline__ float clamp_grad(float pos, float lo, float hi) {
  if (pos > lo && pos < hi) return 1.0f;
  if (pos == lo || pos == hi) return 0.5f;
  return 0.0f;
}

// The 8 trilinear corners q of voxel m's sample at `tap`, into column `slot`
// of the [8][S] shared arrays: flat voxel index (-1 when outside the volume
// or m >= M), weight, and the weight's derivatives along D, H, W (H and W
// times the aperture clamp's gradient).
template <typename T, int S>
__device__ __forceinline__ void voxel_corners(const T* __restrict__ offset, int m, int M, int tap, int D, int H,
                                              int W, int aperture, int slot, int (*cidx)[S], float (*cw)[S],
                                              float (*cdd)[S], float (*cdh)[S], float (*cdw)[S]) {
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const bool valid = m < M;
  float d0 = 0.f, h0 = 0.f, w0 = 0.f, fd = 0.f, fh = 0.f, fw = 0.f, gh = 0.f, gwt = 0.f;
  int b = 0;
  if (valid) {
    int t = m;
    const int w = t % W; t /= W;
    const int h = t % H; t /= H;
    const int d = t % D;
    b = t / D;
    const T* op = offset + (size_t)m * 81 + tap * 3;
    const float pd = (float)(d - 1 + kd) + to_f32(op[0]);
    float ph = (float)(h - 1 + kh) + to_f32(op[1]);
    float pw = (float)(w - 1 + kw) + to_f32(op[2]);
    gh = 1.0f;
    gwt = 1.0f;
    if (aperture) {
      const float hlo = (float)h - AP, hhi = (float)h + AP + 1.0f - EPS;
      const float wlo = (float)w - AP, whi = (float)w + AP + 1.0f - EPS;
      gh = clamp_grad(ph, hlo, hhi);
      gwt = clamp_grad(pw, wlo, whi);
      ph = fminf(fmaxf(ph, hlo), hhi);
      pw = fminf(fmaxf(pw, wlo), whi);
    }
    d0 = floorf(pd); h0 = floorf(ph); w0 = floorf(pw);
    fd = pd - d0; fh = ph - h0; fw = pw - w0;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int cz = q >> 2, cy = (q >> 1) & 1, cx = q & 1;
    const float zi = d0 + cz, yi = h0 + cy, xi = w0 + cx;
    const bool ok = valid && zi >= 0.0f && zi <= (float)(D - 1) && yi >= 0.0f && yi <= (float)(H - 1) &&
                    xi >= 0.0f && xi <= (float)(W - 1);
    const float wz = cz ? fd : 1.0f - fd;
    const float wy = cy ? fh : 1.0f - fh;
    const float wx = cx ? fw : 1.0f - fw;
    const float sz = cz ? 1.0f : -1.0f, sy = cy ? 1.0f : -1.0f, sx = cx ? 1.0f : -1.0f;
    cidx[q][slot] = ok ? ((b * D + (int)zi) * H + (int)yi) * W + (int)xi : -1;
    cw[q][slot] = ok ? (wz * wy) * wx : 0.0f;
    cdd[q][slot] = ok ? sz * wy * wx : 0.0f;
    cdh[q][slot] = ok ? wz * sy * wx * gh : 0.0f;
    cdw[q][slot] = ok ? wz * wy * sx * gwt : 0.0f;
  }
}

// gw[k] = T(sum over splits of the partial sums), k over 27*C*CO.
template <typename T>
__global__ void reduce_gw_kernel(const float* __restrict__ gwp, T* __restrict__ gw, int n, int nsplit) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float s = 0.0f;
  for (int p = 0; p < nsplit; ++p) s += gwp[(size_t)p * n + k];
  gw[k] = from_f32<T>(s);
}

// ------------------------------------------------------- bf16: tensor cores
constexpr int TBM = 128;                 // voxels per tile: two m64 row tiles of gcols
constexpr int G_TILE = TBM * CO * 2;     // a g tile, bf16 [128][64]: 128-byte rows
constexpr int W_SLOT = CMAX * CO * 2;    // the tap's weight rows, bf16 [CP][64]
constexpr int COLS_BYTES = TBM * 128;    // cols bf16 [128 voxels][64 channels]: 128-byte rows

// Shared memory of the tensor-core block (offsets from a 1024-aligned base).
struct TcSmem {
  static constexpr int g = 0;                          // two g tiles
  static constexpr int w = g + 2 * G_TILE;             // the tap's weight rows
  static constexpr int cols = w + W_SLOT;              // cols, the A of gw (MN-major)
  static constexpr int gcols = cols + COLS_BYTES;      // gcols bf16 [128][CP]
  static constexpr int corners = gcols + TBM * CMAX * 2;  // idx, weight, 3 derivatives [8][128]
  static constexpr int gw = corners + 5 * 8 * TBM * 4;  // the gw partial, f32 [64 channels][64]
  static constexpr int bars = gw + CMAX * CO * 4;      // full[2], weights
  static constexpr int bytes = bars + 3 * 8 + 1024;
};

// One 4-channel f32 reduction into global memory (red.global.add.v4.f32).
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// CP: x's padded channels (40 or 64), the gcols wgmma's N. x [M, CP], wpk
// [27, CP, 64] (zero rows past C), gx32 [M, CP] (zeroed), gwp [nsplit, 27 C, 64].
//
// WIDE (CP = 64 only): any Cin and any Co. x comes as nch chunks of 64
// channels (x and gx32 [M, 64 nch]), g and the weight rows padded with zero
// columns to nco N tiles of 64 (g [M, 64 nco], wpk [27, 64 nch, 64 nco]),
// and the grid's z names the block's chunk ch and N tile nt. Per voxel tile
// a block of N tile 0 forms its chunk's gcols over all of Co, one N tile
// after the other into the same accumulator (the g tile and the weight rows
// of each arrive by TMA in turn), so gcols is rounded once; gathers and
// scatters its chunk's channels, adds into gx and writes goff: directly
// when nch is 1, else as the chunk's f32 share in goffp [nch, M, 81], summed
// and rounded once by the caller's second pass. Every block adds its N
// tile's gw (gwp [nsplit, 27 C, 64 nco]); a block of another N tile forms
// only the samples for it, gathering again: right, not fast.
template <int CP, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
deform_bwd_tc_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ offset,
                     float* __restrict__ gx32, __nv_bfloat16* __restrict__ goff, float* __restrict__ gwp, int M,
                     int D, int H, int W, int C, int aperture, int nsplit, int nch_arg, int nco_arg,
                     float* __restrict__ goffp) {
  static_assert(!WIDE || CP == 64, "the wide form takes x in 64-channel chunks");
  constexpr int GS = CP / 4;        // lanes per voxel, 4 channels each
  constexpr int GPW = 32 / GS;      // voxels a warp works at once
  constexpr int NGROUPS = (NT / 32) * GPW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* gcs = reinterpret_cast<__nv_bfloat16*>(sm + TcSmem::gcols);
  int (*cidx)[TBM] = reinterpret_cast<int (*)[TBM]>(sm + TcSmem::corners);
  float (*cw)[TBM] = reinterpret_cast<float (*)[TBM]>(sm + TcSmem::corners + 8 * TBM * 4);
  float (*cdd)[TBM] = cw + 8;
  float (*cdh)[TBM] = cw + 16;
  float (*cdw)[TBM] = cw + 24;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + TcSmem::bars);
  uint64_t* wbar = full + 2;

  const int tap = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (M + TBM - 1) / TBM;
  const uint32_t base = tc::smem_addr(sm);
  const int nch = WIDE ? nch_arg : 1, nco = WIDE ? nco_arg : 1;
  const int nt = WIDE ? (int)blockIdx.z / nch : 0;  // the block's N tile of gw
  const int cb = WIDE ? ((int)blockIdx.z - nt * nch) * CP : 0;  // its chunk's first channel
  const int ldx = nch * CP;                         // x's and gx32's row
  const bool side = nt == 0;                        // this block adds into gx and writes goff
  uint32_t par = 0;                                 // WIDE: the parity of full[0]'s next phase

  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(wbar, 1);
    tma::fence_mbar_init();
  }
  // cols' channels past CP stay zero (the gw wgmma's M is 64); the gw
  // partial starts at zero
  for (int e = tid; e < COLS_BYTES / 16; e += NT) reinterpret_cast<uint4*>(sm + TcSmem::cols)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < CMAX * CO / 4; e += NT) reinterpret_cast<float4*>(sm + TcSmem::gw)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  tc::fence_proxy_async();
  __syncthreads();
  if (!WIDE && tid == 0) {
    tma::mbar_expect_tx(wbar, CP * CO * 2);
    tma::load_2d(sm + TcSmem::w, &wmap, wbar, 0, tap * CP);
    if (split < ntiles) {
      tma::mbar_expect_tx(&full[0], G_TILE);
      tma::load_2d(sm + TcSmem::g, &gmap, &full[0], 0, split * TBM);
    }
  }

  int i = 0;
  for (int tile = split; tile < ntiles; tile += nsplit, ++i) {
    const int buf = WIDE ? 0 : i & 1, m0 = tile * TBM;
    const uint32_t gt = base + TcSmem::g + buf * G_TILE;
    if constexpr (WIDE) {
      if (side) {
        // gcols = g . W_tap^T over the nco N tiles, one after the other (the
        // g tile and the chunk's weight rows of each by TMA into the first g
        // buffer and the weight slot), while warpgroup 1 forms the corners
        float accg[2][CP / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < CP / 2; ++e) accg[h][e] = 0.0f;
        for (int p = 0; p < nco; ++p) {
          if (tid == 0) {
            tma::mbar_expect_tx(&full[0], G_TILE + CP * CO * 2);
            tma::load_2d(sm + TcSmem::g, &gmap, &full[0], CO * p, m0);
            tma::load_2d(sm + TcSmem::w, &wmap, &full[0], CO * p, tap * ldx + cb);
          }
          if (tid < 128) {
            tma::mbar_wait(&full[0], par);
            tc::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < CO / 16; ++kk) {
              const uint64_t db = tc::desc(base + TcSmem::w + kk * 32);
#pragma unroll
              for (int h = 0; h < 2; ++h) tc::Wgmma<CP>::mma(accg[h], tc::desc(gt + h * 64 * 128 + kk * 32), db);
            }
            tc::wgmma_commit();
            tc::wgmma_wait<0>();
          } else if (p == 0) {
            const int v = tid - 128;
            voxel_corners<__nv_bfloat16, TBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
          }
          par ^= 1u;
          __syncthreads();  // the g buffer and the weight slot are free
        }
        if (tid < 128) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < CP / 2; e += 2) {
              const int r = 64 * h + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
              const int n = 8 * (e >> 2) + 2 * (lane & 3);
              *reinterpret_cast<__nv_bfloat162*>(&gcs[r * CP + n]) = __floats2bfloat162_rn(accg[h][e], accg[h][e + 1]);
            }
        }
      } else if (tid >= 128) {  // another N tile's block: its samples alone need the corners
        const int v = tid - 128;
        voxel_corners<__nv_bfloat16, TBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
      }
      // the gw product's g tile, N tile nt, in flight during the gather
      if (tid == 0) {
        tma::mbar_expect_tx(&full[0], G_TILE);
        tma::load_2d(sm + TcSmem::g, &gmap, &full[0], CO * nt, m0);
      }
    } else {
      if (tid == 0 && tile + nsplit < ntiles) {  // the next tile's g, into the buffer tile i - 1 used
        tma::mbar_expect_tx(&full[buf ^ 1], G_TILE);
        tma::load_2d(sm + TcSmem::g + (buf ^ 1) * G_TILE, &gmap, &full[buf ^ 1], 0, (tile + nsplit) * TBM);
      }
      if (tid < 128) {
        // gcols = g . W_tap^T on the tensor cores, rounded to bf16
        float accg[2][CP / 2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < CP / 2; ++e) accg[h][e] = 0.0f;
        tma::mbar_wait(wbar, 0);
        tma::mbar_wait(&full[buf], (i >> 1) & 1);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CO / 16; ++kk) {
          const uint64_t db = tc::desc(base + TcSmem::w + kk * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) tc::Wgmma<CP>::mma(accg[h], tc::desc(gt + h * 64 * 128 + kk * 32), db);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < CP / 2; e += 2) {
            const int r = 64 * h + 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
            const int n = 8 * (e >> 2) + 2 * (lane & 3);
            *reinterpret_cast<__nv_bfloat162*>(&gcs[r * CP + n]) = __floats2bfloat162_rn(accg[h][e], accg[h][e + 1]);
          }
      } else {
        const int v = tid - 128;
        voxel_corners<__nv_bfloat16, TBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
      }
    }
    __syncthreads();

    // gather / scatter: lanes j of a group take channels 4 j .. 4 j + 3 of
    // one voxel; the loop runs alike in every lane of a warp (the offset
    // gradients are summed over the group with shuffles)
    const int grp = lane / GS, j = lane - grp * GS, c = 4 * j;
    for (int v0 = warp * GPW; v0 < TBM; v0 += NGROUPS) {
      const int v = v0 + grp;
      const bool on = grp < GPW && v < TBM;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, pd = 0.f, ph = 0.f, pw = 0.f;
      if (on) {
        // (a wide block of another N tile reads no gcols: it takes the
        // samples alone)
        const uint2 gr = side ? *reinterpret_cast<const uint2*>(&gcs[v * CP + c]) : make_uint2(0u, 0u);
        const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.x));
        const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gr.y));
        // the 8 corners' loads first, all in flight at once
        int ids[8];
        uint2 xrs[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          ids[q] = cidx[q][v];
          xrs[q] = ids[q] < 0 ? make_uint2(0u, 0u)
                              : __ldg(reinterpret_cast<const uint2*>(x + (size_t)ids[q] * ldx + cb + c));
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int id = ids[q];
          if (id < 0) continue;
          const uint2 xr = xrs[q];
          const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
          const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
          const float wq = cw[q][v];
          s0 += wq * x01.x;
          s1 += wq * x01.y;
          s2 += wq * x23.x;
          s3 += wq * x23.y;
          if (side) {
            const float t = g01.x * x01.x + g01.y * x01.y + g23.x * x23.x + g23.y * x23.y;
            pd += cdd[q][v] * t;
            ph += cdh[q][v] * t;
            pw += cdw[q][v] * t;
            if (wq != 0.0f && cb + c < C)
              red_add4(gx32 + (size_t)id * ldx + cb + c, wq * g01.x, wq * g01.y, wq * g23.x, wq * g23.y);
          }
        }
        // cols [v][c .. c + 3], rounded to bf16: one 8-byte store
        const __nv_bfloat162 c01 = __floats2bfloat162_rn(s0, s1), c23 = __floats2bfloat162_rn(s2, s3);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&c01);
        packed.y = *reinterpret_cast<const uint32_t*>(&c23);
        *reinterpret_cast<uint2*>(sm + TcSmem::cols + tc::swizzle(v, c >> 3) + (c & 7) * 2) = packed;
      }
      if (!side) continue;  // block-uniform: every lane of a warp takes the shuffles or none
      // the group's sum lands in its lane 0: a tree over GS <= 16 lanes whose
      // first step folds the lanes past the largest power of two below GS
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float td = __shfl_down_sync(0xffffffffu, pd, off);
        const float th = __shfl_down_sync(0xffffffffu, ph, off);
        const float tw = __shfl_down_sync(0xffffffffu, pw, off);
        if (j + off < GS) {
          pd += td;
          ph += th;
          pw += tw;
        }
      }
      if (on && j == 0 && m0 + v < M) {
        if (nch == 1) {
          __nv_bfloat16* op = goff + (size_t)(m0 + v) * 81 + tap * 3;
          op[0] = __float2bfloat16_rn(pd);
          op[1] = __float2bfloat16_rn(ph);
          op[2] = __float2bfloat16_rn(pw);
        } else {
          float* op = goffp + ((size_t)(cb / CP) * M + m0 + v) * 81 + tap * 3;
          op[0] = pd;
          op[1] = ph;
          op[2] = pw;
        }
      }
    }
    tc::fence_proxy_async();  // cols, written by the generic proxy, is read by wgmma
    __syncthreads();

    if (tid < 128) {
      // gw += cols^T . g: A and B both MN-major over the tile's voxels (the
      // transpose flags), cols [v][c] and the g tile [v][n]; the m64n64
      // accumulators are added into the block's f32 partial in shared
      // memory, so they hold no registers through the gather
      if (WIDE) tma::mbar_wait(&full[0], par);
      float accw[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) accw[e] = 0.0f;
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TBM / 16; ++kk)
        tc::Wgmma<64, 1, 1>::mma(accw, tc::desc(base + TcSmem::cols + kk * 2048), tc::desc(gt + kk * 2048));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      float* gws = reinterpret_cast<float*>(sm + TcSmem::gw);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int cc = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int n = 8 * (e >> 2) + 2 * (lane & 3);
        float2* a = reinterpret_cast<float2*>(&gws[cc * CO + n]);
        const float2 old = *a;
        *a = make_float2(old.x + accw[e], old.y + accw[e + 1]);
      }
    }
    if (WIDE) par ^= 1u;
    __syncthreads();  // this tile's g buffer, cols, gcols and corners are free
  }

  if constexpr (WIDE) {
    // the block's gw partial: its chunk's rows c < C, its N tile's columns
    const int rows = min(CP, C - cb), cop = nco * CO;
    float* part = gwp + ((size_t)split * 27 + tap) * C * cop;
    for (int e = tid; e < rows * CO / 4; e += NT) {
      const int r = e / (CO / 4), q4 = e - r * (CO / 4);
      *reinterpret_cast<float4*>(part + (size_t)(cb + r) * cop + CO * nt + 4 * q4) =
          reinterpret_cast<const float4*>(sm + TcSmem::gw)[e];
    }
  } else {
    // the block's gw partial, rows c < C, in 16-byte stores (the loop's last
    // barrier ordered the partial's last update before these reads)
    float4* part = reinterpret_cast<float4*>(gwp + ((size_t)split * 27 + tap) * C * CO);
    for (int e = tid; e < C * CO / 4; e += NT) part[e] = reinterpret_cast<const float4*>(sm + TcSmem::gw)[e];
  }
}

// ------------------------------------------------------- f32: 3xTF32 tensor cores
constexpr int FBM = 64;                // voxels per tile: one m64 row tile of gcols
constexpr int F_HALF = FBM * 128;      // half a g tile: f32 [64 voxels][32 n], 128-byte rows
constexpr int F_G_TILE = 2 * F_HALF;   // a g tile, f32 [64][64] as two halves over n

// Shared memory of the f32 block (offsets from a 1024-aligned base). A
// plane of the weight rows or of cols^T is two 128-byte-swizzled halves
// [CP][32] (over n, over the tile's voxels); hi, then lo.
template <int CP> struct F32Smem {
  // threads and blocks an SM: at CP = 40 two blocks of 8 warps share an SM;
  // at 64 the one block has 16, for as many corner loads in flight
  static constexpr int threads = CP == 40 ? 256 : 512;
  static constexpr int blocks = CP == 40 ? 2 : 1;
  static constexpr int RS = CP + 4;                     // gcols / gw^T row stride in floats: 16-byte rows off the banks' period
  static constexpr int PLANE = 2 * CP * 128;
  static constexpr int g = 0;                           // two g tiles
  static constexpr int w = g + 2 * F_G_TILE;            // the tap's weight rows, hi and lo planes
  static constexpr int cols = w + 2 * PLANE;            // cols^T [c][voxel], hi and lo planes
  static constexpr int gcols = cols + 2 * PLANE;        // gcols f32 [64 voxels][RS]
  static constexpr int corners = gcols + FBM * RS * 4;  // idx, weight, 3 derivatives [8][64]
  static constexpr int gw = corners + 5 * 8 * FBM * 4;  // the gw^T partial, f32 [64 n][RS]
  static constexpr int bars = gw + CO * RS * 4;         // full[2], weights
  static constexpr int bytes = bars + 3 * 8 + 1024;
};

// The A fragment of gw^T's m64nCPk8 (rows n0 + lane / 4 (+ 8), columns,
// the voxels, v0 + lane % 4 (+ 4)): g^T read out of the [voxel][n] g tile,
// split into TF32 halves.
__device__ __forceinline__ void gt_fragment_3xtf32(const uint8_t* gt, int n0, int v0, uint32_t (&hi)[4],
                                                   uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + (lane >> 2) + 8 * (q & 1);
    const int v = v0 + (lane & 3) + 4 * (q >> 1);
    const float a = *reinterpret_cast<const float*>(gt + (n >> 5) * F_HALF + tc::swizzle(v, (n & 31) >> 2) + (n & 3) * 4);
    tc::split_tf32(a, hi[q], lo[q]);
  }
}

// CP: x's padded channels (40 or 64), the N of both products. x [M, CP],
// wsplit [2][27, CP, 64] (hi, lo; zero rows past C), gx32 [M, CP] (zeroed),
// goff [M, 81], gwp [nsplit, 27 C, 64]; f32.
template <int CP>
__global__ void __launch_bounds__(F32Smem<CP>::threads, F32Smem<CP>::blocks)
deform_bwd_3xtf32_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap whmap,
                         const __grid_constant__ CUtensorMap wlmap, const float* __restrict__ x,
                         const float* __restrict__ offset, float* __restrict__ gx32, float* __restrict__ goff,
                         float* __restrict__ gwp, int M, int D, int H, int W, int C, int aperture, int nsplit) {
  using S = F32Smem<CP>;
  constexpr int GS = CP / 4;        // lanes per voxel, 4 channels each
  constexpr int GPW = 32 / GS;      // voxels a warp works at once
  constexpr int NGROUPS = (S::threads / 32) * GPW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  float* gcs = reinterpret_cast<float*>(sm + S::gcols);
  float* gws = reinterpret_cast<float*>(sm + S::gw);
  int (*cidx)[FBM] = reinterpret_cast<int (*)[FBM]>(sm + S::corners);
  float (*cw)[FBM] = reinterpret_cast<float (*)[FBM]>(sm + S::corners + 8 * FBM * 4);
  float (*cdd)[FBM] = cw + 8;
  float (*cdh)[FBM] = cw + 16;
  float (*cdw)[FBM] = cw + 24;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  uint64_t* wbar = full + 2;

  const int tap = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (M + FBM - 1) / FBM;
  const uint32_t base = tc::smem_addr(sm);

  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::mbar_init(&full[1], 1);
    tma::mbar_init(wbar, 1);
    tma::fence_mbar_init();
  }
  for (int e = tid; e < CO * S::RS / 4; e += S::threads) reinterpret_cast<float4*>(gws)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (tid == 0) {
    tma::mbar_expect_tx(wbar, 2 * S::PLANE);
    for (int hf = 0; hf < 2; ++hf) {
      tma::load_2d(sm + S::w + hf * CP * 128, &whmap, wbar, 32 * hf, tap * CP);
      tma::load_2d(sm + S::w + S::PLANE + hf * CP * 128, &wlmap, wbar, 32 * hf, tap * CP);
    }
    if (split < ntiles) {
      tma::mbar_expect_tx(&full[0], F_G_TILE);
      tma::load_2d(sm + S::g, &gmap, &full[0], 0, split * FBM);
      tma::load_2d(sm + S::g + F_HALF, &gmap, &full[0], 32, split * FBM);
    }
  }

  int i = 0;
  for (int tile = split; tile < ntiles; tile += nsplit, ++i) {
    const int buf = i & 1, m0 = tile * FBM;
    const uint8_t* gt = sm + S::g + buf * F_G_TILE;
    if (tid == 0 && tile + nsplit < ntiles) {  // the next tile's g, into the buffer tile i - 1 used
      uint8_t* nt = sm + S::g + (buf ^ 1) * F_G_TILE;
      tma::mbar_expect_tx(&full[buf ^ 1], F_G_TILE);
      tma::load_2d(nt, &gmap, &full[buf ^ 1], 0, (tile + nsplit) * FBM);
      tma::load_2d(nt + F_HALF, &gmap, &full[buf ^ 1], 32, (tile + nsplit) * FBM);
    }
    if (tid < 128) {
      // gcols = g . W_tap^T in 3xTF32 (K = n, 8 k slices in two rounds of
      // four: the split fragments of a round stay in registers until its
      // MMAs are done); gcols stays f32
      float accg[CP / 2];
#pragma unroll
      for (int e = 0; e < CP / 2; ++e) accg[e] = 0.0f;
      tma::mbar_wait(wbar, 0);
      tma::mbar_wait(&full[buf], (i >> 1) & 1);
#pragma unroll
      for (int k0 = 0; k0 < CO / 8; k0 += 4) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tc::a_fragment_3xtf32(gt + ((k0 + kk) >> 2) * F_HALF, 16 * warp, 8 * ((k0 + kk) & 3), ah[kk], al[kk]);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t wb = base + S::w + ((k0 + kk) >> 2) * CP * 128 + ((k0 + kk) & 3) * 32;
          tc::mma_3xtf32<CP>(accg, ah[kk], al[kk], wb, wb + S::PLANE);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
      }
#pragma unroll
      for (int e = 0; e < CP / 2; e += 2) {
        const int r = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int n = 8 * (e >> 2) + 2 * (lane & 3);
        *reinterpret_cast<float2*>(&gcs[r * S::RS + n]) = make_float2(accg[e], accg[e + 1]);
      }
    } else if (tid < 128 + FBM) {
      const int v = tid - 128;
      voxel_corners<float, FBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
    }
    __syncthreads();

    // gather / scatter, as the bf16 route's, on f32 rows: lanes j of a
    // group take channels 4 j .. 4 j + 3 of one voxel
    const int grp = lane / GS, j = lane - grp * GS, c = 4 * j;
    for (int v0 = warp * GPW; v0 < FBM; v0 += NGROUPS) {
      const int v = v0 + grp;
      const bool on = grp < GPW && v < FBM;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, pd = 0.f, ph = 0.f, pw = 0.f;
      if (on) {
        const float4 gc = *reinterpret_cast<const float4*>(&gcs[v * S::RS + c]);
        // the 8 corners' loads first, all in flight at once
        int ids[8];
        float4 xrs[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          ids[q] = cidx[q][v];
          xrs[q] = ids[q] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : __ldg(reinterpret_cast<const float4*>(x + (size_t)ids[q] * CP + c));
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int id = ids[q];
          if (id < 0) continue;
          const float4 xr = xrs[q];
          const float wq = cw[q][v];
          s0 += wq * xr.x;
          s1 += wq * xr.y;
          s2 += wq * xr.z;
          s3 += wq * xr.w;
          const float t = gc.x * xr.x + gc.y * xr.y + gc.z * xr.z + gc.w * xr.w;
          pd += cdd[q][v] * t;
          ph += cdh[q][v] * t;
          pw += cdw[q][v] * t;
          if (c < C && wq != 0.0f) red_add4(gx32 + (size_t)id * CP + c, wq * gc.x, wq * gc.y, wq * gc.z, wq * gc.w);
        }
        // cols^T [c + k][v], split into the hi and lo planes; at step st lane
        // j writes channel k = (st + j / 2) % 4, so a step's stores spread
        // over the swizzle's 8 row classes (2-way bank conflicts, not 8)
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const int k = (st + (j >> 1)) & 3;
          const float sv = k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3;
          uint32_t hi, lo;
          tc::split_tf32(sv, hi, lo);
          uint8_t* p = sm + S::cols + (v >> 5) * CP * 128 + tc::swizzle(c + k, (v & 31) >> 2) + (v & 3) * 4;
          *reinterpret_cast<uint32_t*>(p) = hi;
          *reinterpret_cast<uint32_t*>(p + S::PLANE) = lo;
        }
      }
      // the group's sum lands in its lane 0 (as the bf16 route's)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float td = __shfl_down_sync(0xffffffffu, pd, off);
        const float th = __shfl_down_sync(0xffffffffu, ph, off);
        const float tw = __shfl_down_sync(0xffffffffu, pw, off);
        if (j + off < GS) {
          pd += td;
          ph += th;
          pw += tw;
        }
      }
      if (on && j == 0 && m0 + v < M) {
        float* op = goff + (size_t)(m0 + v) * 81 + tap * 3;
        op[0] = pd;
        op[1] = ph;
        op[2] = pw;
      }
    }
    tc::fence_proxy_async();  // cols, written by the generic proxy, is read by wgmma
    __syncthreads();

    if (tid < 128) {
      // gw^T += g^T . cols in 3xTF32 (K = the tile's 64 voxels, two rounds
      // of four k slices), added into the block's f32 partial in shared
      // memory
      float accw[CP / 2];
#pragma unroll
      for (int e = 0; e < CP / 2; ++e) accw[e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < FBM / 8; k0 += 4) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) gt_fragment_3xtf32(gt, 16 * warp, 8 * (k0 + kk), ah[kk], al[kk]);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t cb = base + S::cols + ((k0 + kk) >> 2) * CP * 128 + ((k0 + kk) & 3) * 32;
          tc::mma_3xtf32<CP>(accw, ah[kk], al[kk], cb, cb + S::PLANE);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
      }
#pragma unroll
      for (int e = 0; e < CP / 2; e += 2) {
        const int n = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int cc = 8 * (e >> 2) + 2 * (lane & 3);
        float2* a = reinterpret_cast<float2*>(&gws[n * S::RS + cc]);
        const float2 old = *a;
        *a = make_float2(old.x + accw[e], old.y + accw[e + 1]);
      }
    }
    tc::fence_proxy_async();  // the g tile, read by the generic proxy, is refilled by TMA
    __syncthreads();          // this tile's g buffer, cols, gcols and corners are free
  }

  // the block's gw partial [c][n], rows c < C, from the transposed sum
  float* part = gwp + ((size_t)split * 27 + tap) * C * CO;
  for (int e = tid; e < C * CO; e += S::threads) {
    const int cc = e / CO, n = e - cc * CO;
    part[e] = gws[n * S::RS + cc];
  }
}

// The wide form (`dpf_deform_conv3d_bwd_wide`), as the bf16 route's: x and
// gx32 [M, 64 nch], g [M, 64 nco], wsplit [2][27, 64 nch, 64 nco], the
// grid's z the block's chunk and N tile, goffp [nch, M, 81] when nch > 1,
// gwp [nsplit, 27 C, 64 nco]. The blocks of N tile 0 form their chunk's
// gcols over every N tile in turn (the g tile and the weight rows of each by
// TMA into the first g buffer and the weight planes) and add into gx and
// goff; the other blocks need only the samples and their own N tile's g, for
// gw. A kernel of its own, so the tuned one's code stays as it is.
__global__ void __launch_bounds__(F32Smem<64>::threads, F32Smem<64>::blocks)
deform_bwd_3xtf32_wide_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap whmap,
                              const __grid_constant__ CUtensorMap wlmap, const float* __restrict__ x,
                              const float* __restrict__ offset, float* __restrict__ gx32, float* __restrict__ goff,
                              float* __restrict__ gwp, int M, int D, int H, int W, int C, int aperture, int nsplit,
                              int nch, int nco, float* __restrict__ goffp) {
  constexpr int CP = 64;
  using S = F32Smem<CP>;
  constexpr int GS = CP / 4;        // lanes per voxel, 4 channels each
  constexpr int GPW = 32 / GS;      // voxels a warp works at once
  constexpr int NGROUPS = (S::threads / 32) * GPW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  float* gcs = reinterpret_cast<float*>(sm + S::gcols);
  float* gws = reinterpret_cast<float*>(sm + S::gw);
  int (*cidx)[FBM] = reinterpret_cast<int (*)[FBM]>(sm + S::corners);
  float (*cw)[FBM] = reinterpret_cast<float (*)[FBM]>(sm + S::corners + 8 * FBM * 4);
  float (*cdd)[FBM] = cw + 8;
  float (*cdh)[FBM] = cw + 16;
  float (*cdw)[FBM] = cw + 24;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::bars);
  const uint8_t* gt = sm + S::g;

  const int tap = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (M + FBM - 1) / FBM;
  const uint32_t base = tc::smem_addr(sm);
  const int nt = (int)blockIdx.z / nch;             // the block's N tile of gw
  const int cb = ((int)blockIdx.z - nt * nch) * CP;  // its chunk's first channel
  const int ldx = nch * CP;                         // x's and gx32's row
  const bool side = nt == 0;                        // this block adds into gx and writes goff
  uint32_t par = 0;                                 // the parity of full[0]'s next phase

  if (tid == 0) {
    tma::mbar_init(&full[0], 1);
    tma::fence_mbar_init();
  }
  for (int e = tid; e < CO * S::RS / 4; e += S::threads) reinterpret_cast<float4*>(gws)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int tile = split; tile < ntiles; tile += nsplit) {
    const int m0 = tile * FBM;
    if (side) {
      // gcols = g . W_tap^T over the nco N tiles in turn, while warpgroup 1
      // forms the corners
      float accg[CP / 2];
#pragma unroll
      for (int e = 0; e < CP / 2; ++e) accg[e] = 0.0f;
      for (int p = 0; p < nco; ++p) {
        if (tid == 0) {
          tma::mbar_expect_tx(&full[0], F_G_TILE + 2 * S::PLANE);
          tma::load_2d(sm + S::g, &gmap, &full[0], CO * p, m0);
          tma::load_2d(sm + S::g + F_HALF, &gmap, &full[0], CO * p + 32, m0);
          for (int hf = 0; hf < 2; ++hf) {
            tma::load_2d(sm + S::w + hf * CP * 128, &whmap, &full[0], CO * p + 32 * hf, tap * ldx + cb);
            tma::load_2d(sm + S::w + S::PLANE + hf * CP * 128, &wlmap, &full[0], CO * p + 32 * hf, tap * ldx + cb);
          }
        }
        if (tid < 128) {
          tma::mbar_wait(&full[0], par);
#pragma unroll
          for (int k0 = 0; k0 < CO / 8; k0 += 4) {
            uint32_t ah[4][4], al[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              tc::a_fragment_3xtf32(gt + ((k0 + kk) >> 2) * F_HALF, 16 * warp, 8 * ((k0 + kk) & 3), ah[kk], al[kk]);
            tc::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t wb = base + S::w + ((k0 + kk) >> 2) * CP * 128 + ((k0 + kk) & 3) * 32;
              tc::mma_3xtf32<CP>(accg, ah[kk], al[kk], wb, wb + S::PLANE);
            }
            tc::wgmma_commit();
            tc::wgmma_wait<0>();
          }
        } else if (tid < 128 + FBM && p == 0) {
          const int v = tid - 128;
          voxel_corners<float, FBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
        }
        par ^= 1u;
        tc::fence_proxy_async();  // the g tile, read by the generic proxy, is refilled by TMA
        __syncthreads();          // the g buffer and the weight planes are free
      }
      if (tid < 128) {
#pragma unroll
        for (int e = 0; e < CP / 2; e += 2) {
          const int r = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
          const int n = 8 * (e >> 2) + 2 * (lane & 3);
          *reinterpret_cast<float2*>(&gcs[r * S::RS + n]) = make_float2(accg[e], accg[e + 1]);
        }
      }
    } else if (tid >= 128 && tid < 128 + FBM) {
      const int v = tid - 128;
      voxel_corners<float, FBM>(offset, m0 + v, M, tap, D, H, W, aperture, v, cidx, cw, cdd, cdh, cdw);
    }
    if (tid == 0) {  // the gw product's g tile, N tile nt, in flight during the gather
      tma::mbar_expect_tx(&full[0], F_G_TILE);
      tma::load_2d(sm + S::g, &gmap, &full[0], CO * nt, m0);
      tma::load_2d(sm + S::g + F_HALF, &gmap, &full[0], CO * nt + 32, m0);
    }
    __syncthreads();

    // gather / scatter, as the tuned kernel's on the chunk's channels; the
    // blocks of other N tiles form the samples alone
    const int grp = lane / GS, j = lane - grp * GS, c = 4 * j;
    for (int v0 = warp * GPW; v0 < FBM; v0 += NGROUPS) {
      const int v = v0 + grp;
      const bool on = grp < GPW && v < FBM;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, pd = 0.f, ph = 0.f, pw = 0.f;
      if (on) {
        const float4 gc = side ? *reinterpret_cast<const float4*>(&gcs[v * S::RS + c]) : make_float4(0.f, 0.f, 0.f, 0.f);
        // the 8 corners' loads first, all in flight at once
        int ids[8];
        float4 xrs[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          ids[q] = cidx[q][v];
          xrs[q] = ids[q] < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                              : __ldg(reinterpret_cast<const float4*>(x + (size_t)ids[q] * ldx + cb + c));
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int id = ids[q];
          if (id < 0) continue;
          const float4 xr = xrs[q];
          const float wq = cw[q][v];
          s0 += wq * xr.x;
          s1 += wq * xr.y;
          s2 += wq * xr.z;
          s3 += wq * xr.w;
          if (side) {
            const float t = gc.x * xr.x + gc.y * xr.y + gc.z * xr.z + gc.w * xr.w;
            pd += cdd[q][v] * t;
            ph += cdh[q][v] * t;
            pw += cdw[q][v] * t;
            if (cb + c < C && wq != 0.0f)
              red_add4(gx32 + (size_t)id * ldx + cb + c, wq * gc.x, wq * gc.y, wq * gc.z, wq * gc.w);
          }
        }
        // cols^T [c + k][v], split into the hi and lo planes (the tuned
        // kernel's order of stores)
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const int k = (st + (j >> 1)) & 3;
          const float sv = k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3;
          uint32_t hi, lo;
          tc::split_tf32(sv, hi, lo);
          uint8_t* p = sm + S::cols + (v >> 5) * CP * 128 + tc::swizzle(c + k, (v & 31) >> 2) + (v & 3) * 4;
          *reinterpret_cast<uint32_t*>(p) = hi;
          *reinterpret_cast<uint32_t*>(p + S::PLANE) = lo;
        }
      }
      if (side) {  // block-uniform: every lane of the warp takes the shuffles
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float td = __shfl_down_sync(0xffffffffu, pd, off);
          const float th = __shfl_down_sync(0xffffffffu, ph, off);
          const float tw = __shfl_down_sync(0xffffffffu, pw, off);
          if (j + off < GS) {
            pd += td;
            ph += th;
            pw += tw;
          }
        }
        if (on && j == 0 && m0 + v < M) {
          float* op = (nch == 1 ? goff : goffp + (size_t)(cb / CP) * M * 81) + (size_t)(m0 + v) * 81 + tap * 3;
          op[0] = pd;
          op[1] = ph;
          op[2] = pw;
        }
      }
    }
    tc::fence_proxy_async();  // cols, written by the generic proxy, is read by wgmma
    __syncthreads();

    if (tid < 128) {
      // gw^T += g^T . cols in 3xTF32, N tile nt's g, as the tuned kernel's
      tma::mbar_wait(&full[0], par);
      float accw[CP / 2];
#pragma unroll
      for (int e = 0; e < CP / 2; ++e) accw[e] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < FBM / 8; k0 += 4) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) gt_fragment_3xtf32(gt, 16 * warp, 8 * (k0 + kk), ah[kk], al[kk]);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t colb = base + S::cols + ((k0 + kk) >> 2) * CP * 128 + ((k0 + kk) & 3) * 32;
          tc::mma_3xtf32<CP>(accw, ah[kk], al[kk], colb, colb + S::PLANE);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
      }
#pragma unroll
      for (int e = 0; e < CP / 2; e += 2) {
        const int n = 16 * warp + (lane >> 2) + 8 * ((e >> 1) & 1);
        const int cc = 8 * (e >> 2) + 2 * (lane & 3);
        float2* a = reinterpret_cast<float2*>(&gws[n * S::RS + cc]);
        const float2 old = *a;
        *a = make_float2(old.x + accw[e], old.y + accw[e + 1]);
      }
    }
    par ^= 1u;
    tc::fence_proxy_async();  // the g tile, read by the generic proxy, is refilled by TMA
    __syncthreads();          // this tile's g buffer, cols, gcols and corners are free
  }

  // the block's gw partial [c][n]: its chunk's rows c < C, its N tile's columns
  const int rows = min(CP, C - cb), cop = nco * CO;
  float* part = gwp + ((size_t)split * 27 + tap) * C * cop + (size_t)cb * cop + CO * nt;
  for (int e = tid; e < rows * CO; e += S::threads) {
    const int cc = e / CO, n = e - cc * CO;
    part[(size_t)cc * cop + n] = gws[n * S::RS + cc];
  }
}

// gx [M, C] = T(gx32 [M, CP]): the one rounding of x's gradient, the padded
// channels dropped.
template <typename T>
__global__ void cast_depad_kernel(const float* __restrict__ gx32, T* __restrict__ gx, long long n, int C, int CP) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = i / C;
  gx[i] = from_f32<T>(gx32[m * CP + (i - m * C)]);
}

// nch chunks of CP channels and nco N tiles (both 1 unless WIDE).
template <int CP, bool WIDE>
int launch_tc(cudaStream_t s, const void* x, const void* offset, const void* wpk, const void* g, float* gx32,
              void* goff, float* gwp, int M, int D, int H, int W, int C, int aperture, int nsplit, int nch, int nco,
              float* goffp) {
  CUtensorMap gm, wm;
  const uint64_t gdims[2] = {(uint64_t)CO * nco, (uint64_t)M}, wdims[2] = {(uint64_t)CO * nco, (uint64_t)27 * nch * CP};
  const uint64_t stride[1] = {(uint64_t)CO * nco * 2};
  const uint32_t gbox[2] = {CO, TBM}, wbox[2] = {CO, CP};
  int rc = tma::encode(&gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, gdims, stride, gbox);
  if (rc != 0) return rc;
  rc = tma::encode(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wpk, wdims, stride, wbox);
  if (rc != 0) return rc;
  auto kernel = deform_bwd_tc_kernel<CP, WIDE>;
  static const cudaError_t opted_in =  // once per instantiation and process (one card)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem::bytes);
  if (opted_in != cudaSuccess) return (int)opted_in;
  kernel<<<dim3(27, (unsigned)nsplit, (unsigned)(nch * nco)), NT, TcSmem::bytes, s>>>(
      gm, wm, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(offset), gx32,
      static_cast<__nv_bfloat16*>(goff), gwp, M, D, H, W, C, aperture, nsplit, nch, nco, goffp);
  return (int)cudaGetLastError();
}

template <int CP, bool WIDE>
int launch_3xtf32(cudaStream_t s, const void* x, const void* offset, const void* wsplit, const void* g, float* gx32,
                  void* goff, float* gwp, int M, int D, int H, int W, int C, int aperture, int nsplit, int nch,
                  int nco, float* goffp) {
  CUtensorMap gm, whm, wlm;
  const uint64_t gdims[2] = {(uint64_t)CO * nco, (uint64_t)M}, wdims[2] = {(uint64_t)CO * nco, (uint64_t)27 * nch * CP};
  const uint64_t stride[1] = {(uint64_t)CO * nco * 4};
  const uint32_t gbox[2] = {32, FBM}, wbox[2] = {32, CP};  // 128-byte inner boxes: the swizzle's span
  const float* wlo = static_cast<const float*>(wsplit) + (size_t)27 * nch * CP * CO * nco;
  int rc = tma::encode(&gm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, g, gdims, stride, gbox);
  if (rc == 0) rc = tma::encode(&whm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, wsplit, wdims, stride, wbox);
  if (rc == 0) rc = tma::encode(&wlm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, wlo, wdims, stride, wbox);
  if (rc != 0) return rc;
  if constexpr (WIDE) {
    auto kernel = deform_bwd_3xtf32_wide_kernel;
    static const cudaError_t opted_in =  // once per process (one card)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Smem<CP>::bytes);
    if (opted_in != cudaSuccess) return (int)opted_in;
    kernel<<<dim3(27, (unsigned)nsplit, (unsigned)(nch * nco)), F32Smem<CP>::threads, F32Smem<CP>::bytes, s>>>(
        gm, whm, wlm, static_cast<const float*>(x), static_cast<const float*>(offset), gx32,
        static_cast<float*>(goff), gwp, M, D, H, W, C, aperture, nsplit, nch, nco, goffp);
  } else {
    auto kernel = deform_bwd_3xtf32_kernel<CP>;
    static const cudaError_t opted_in =  // once per instantiation and process (one card)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32Smem<CP>::bytes);
    if (opted_in != cudaSuccess) return (int)opted_in;
    kernel<<<dim3(27, (unsigned)nsplit), F32Smem<CP>::threads, F32Smem<CP>::bytes, s>>>(
        gm, whm, wlm, static_cast<const float*>(x), static_cast<const float*>(offset), gx32,
        static_cast<float*>(goff), gwp, M, D, H, W, C, aperture, nsplit);
  }
  return (int)cudaGetLastError();
}

int reduce_gw(cudaStream_t s, const float* gwp, void* gw, int C, int nsplit, bool bf16) {
  const int n = 27 * C * CO;
  if (bf16)
    reduce_gw_kernel<__nv_bfloat16><<<(n + 255) / 256, 256, 0, s>>>(gwp, static_cast<__nv_bfloat16*>(gw), n, nsplit);
  else
    reduce_gw_kernel<float><<<(n + 255) / 256, 256, 0, s>>>(gwp, static_cast<float*>(gw), n, nsplit);
  return (int)cudaGetLastError();
}

// gw [27 C, Co] = T(sum over splits of gwp [nsplit, 27 C, COP]), the padded
// columns dropped; goff [M, 81] = T(sum over the nch chunks of goffp
// [nch, M, 81]) when nch > 1 (the chunks' shares, summed in f32 and rounded
// once).
template <typename T>
__global__ void reduce_wide_kernel(const float* __restrict__ gwp, T* __restrict__ gw, int rows, int Co, int COP,
                                   int nsplit, const float* __restrict__ goffp, T* __restrict__ goff, long long noff,
                                   int nch) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ngw = (long long)rows * Co;
  if (k < ngw) {
    const long long r = k / Co, n = k - r * Co;
    float acc = 0.0f;
    for (int p = 0; p < nsplit; ++p) acc += gwp[((long long)p * rows + r) * COP + n];
    gw[k] = from_f32<T>(acc);
  } else if (nch > 1 && k < ngw + noff) {
    const long long i = k - ngw;
    float acc = 0.0f;
    for (int c = 0; c < nch; ++c) acc += goffp[(long long)c * noff + i];
    goff[i] = from_f32<T>(acc);
  }
}

template <typename T>
int reduce_wide(cudaStream_t s, const float* gwp, void* gw, int C, int Co, int COP, int nsplit, const float* goffp,
                void* goff, long long noff, int nch) {
  const long long n = (long long)27 * C * Co + (nch > 1 ? noff : 0);
  reduce_wide_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      gwp, static_cast<T*>(gw), 27 * C, Co, COP, nsplit, goffp, static_cast<T*>(goff), noff, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 route (the tensor-core kernel). xp [B, D, H, W, CP] (x padded with
// zero channels to CP = 40 or 64), offset [B, D, H, W, 81], wpk [27, CP, CO]
// (the tap's weight rows, zero past C), g [B, D, H, W, CO]; bf16,
// contiguous, 16-byte aligned. Scratch: gx32 f32 [B, D, H, W, CP] (zeroed
// here), gwp f32 [nsplit, 27*C, CO]. Outputs: gx [B, D, H, W, C], goff like
// offset, gw [27*C, CO], bf16. Returns cudaErrorInvalidValue for Co != CO,
// CP not 40 or 64, C outside 1..CP, nsplit outside 1..ceil(M / 128) or a
// misaligned pointer,
// else the first error of the tensor maps' encoding or a launch.
extern "C" int dpf_deform_conv3d_bwd_tc(const void* xp, const void* offset, const void* wpk, const void* g,
                                        float* gx32, void* gx, void* goff, float* gwp, void* gw, int B, int D,
                                        int H, int W, int C, int CP, int Co, int nsplit, int aperture,
                                        void* stream) {
  const int M = B * D * H * W;
  if (Co != CO || (CP != 40 && CP != 64) || C < 1 || C > CP || M < 1 || nsplit < 1 ||
      nsplit > (M + TBM - 1) / TBM || ((uintptr_t)xp | (uintptr_t)wpk | (uintptr_t)g | (uintptr_t)gx32) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaMemsetAsync(gx32, 0, (size_t)M * CP * sizeof(float), s);
  if (rc != 0) return rc;
  rc = CP == 40 ? launch_tc<40, false>(s, xp, offset, wpk, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, 1, 1, nullptr)
                : launch_tc<64, false>(s, xp, offset, wpk, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, 1, 1, nullptr);
  if (rc != 0) return rc;
  rc = reduce_gw(s, gwp, gw, C, nsplit, true);
  if (rc != 0) return rc;
  const long long n = (long long)M * C;
  cast_depad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(gx32, static_cast<__nv_bfloat16*>(gx), n, C, CP);
  return (int)cudaGetLastError();
}

// f32 route (3xTF32 on the tensor cores). xp [B, D, H, W, CP] (x padded
// with zero channels to CP = 40 or 64), offset [B, D, H, W, 81], wsplit
// [2][27, CP, CO] (the taps' weight rows, zero past C, split into TF32 hi
// and lo planes), g [B, D, H, W, CO]; f32, contiguous, 16-byte aligned.
// Scratch: gx32 f32 [B, D, H, W, CP] (zeroed here; it may be gx itself when
// C == CP), gwp f32 [nsplit, 27*C, CO]. Outputs: gx [B, D, H, W, C], goff
// like offset, gw [27*C, CO], f32. Returns cudaErrorInvalidValue for
// Co != CO, CP not 40 or 64, C outside 1..CP, nsplit outside
// 1..ceil(M / 64), gx == gx32 with C != CP or a misaligned pointer, else
// the first error of the tensor maps' encoding or a launch.
extern "C" int dpf_deform_conv3d_bwd_3xtf32(const void* xp, const void* offset, const void* wsplit, const void* g,
                                            float* gx32, void* gx, void* goff, float* gwp, void* gw, int B, int D,
                                            int H, int W, int C, int CP, int Co, int nsplit, int aperture,
                                            void* stream) {
  const int M = B * D * H * W;
  if (Co != CO || (CP != 40 && CP != 64) || C < 1 || C > CP || M < 1 || nsplit < 1 ||
      nsplit > (M + FBM - 1) / FBM || (gx == gx32 && C != CP) ||
      ((uintptr_t)xp | (uintptr_t)wsplit | (uintptr_t)g | (uintptr_t)gx32) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaMemsetAsync(gx32, 0, (size_t)M * CP * sizeof(float), s);
  if (rc != 0) return rc;
  rc = CP == 40 ? launch_3xtf32<40, false>(s, xp, offset, wsplit, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, 1, 1, nullptr)
                : launch_3xtf32<64, false>(s, xp, offset, wsplit, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, 1, 1, nullptr);
  if (rc != 0) return rc;
  rc = reduce_gw(s, gwp, gw, C, nsplit, false);
  if (rc != 0 || gx == gx32) return rc;
  const long long n = (long long)M * C;
  cast_depad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(gx32, static_cast<float*>(gx), n, C, CP);
  return (int)cudaGetLastError();
}

// The other widths, both routes (is_bf16 selects bf16, else f32). x padded
// to CPX = 64 nch channels (xp [B, D, H, W, CPX]) and the cotangent to COP
// = 64 nco, g [B, D, H, W, COP] (zero past Co). bf16: wpk [27, CPX, COP]
// (the taps' weight rows, zero past C and Co); f32: wpk [2][27, CPX, COP]
// (those rows split into TF32 hi and lo planes). Scratch: gx32 f32
// [B, D, H, W, CPX] (zeroed here; for f32 it may be gx itself when
// C == CPX), gwp f32 [nsplit, 27*C, COP], goffp f32 [nch, B, D, H, W, 81]
// (unused when nch is 1). Outputs: gx [B, D, H, W, C], goff like offset,
// gw [27*C, Co], in the input dtype. Returns cudaErrorInvalidValue for CPX
// or COP not a positive multiple of 64, C outside 1..CPX, Co outside
// 1..COP, nsplit outside 1..ceil(M / tile), gx == gx32 other than for f32
// with C == CPX, goffp null with nch > 1 or a misaligned pointer, else the
// first error of the tensor maps' encoding or a launch.
extern "C" int dpf_deform_conv3d_bwd_wide(const void* xp, const void* offset, const void* wpk, const void* g,
                                          float* gx32, void* gx, void* goff, float* gwp, void* gw, float* goffp,
                                          int B, int D, int H, int W, int C, int CPX, int Co, int COP, int nsplit,
                                          int aperture, int is_bf16, void* stream) {
  const int M = B * D * H * W, nch = CPX / 64, nco = COP / CO;
  const int tile = is_bf16 ? TBM : FBM;
  if (CPX < 64 || CPX % 64 != 0 || COP < CO || COP % CO != 0 || C < 1 || C > CPX || Co < 1 || Co > COP ||
      M < 1 || nsplit < 1 || nsplit > (M + tile - 1) / tile || (gx == gx32 && (is_bf16 || C != CPX)) ||
      (nch > 1 && goffp == nullptr) ||
      ((uintptr_t)xp | (uintptr_t)wpk | (uintptr_t)g | (uintptr_t)gx32) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaMemsetAsync(gx32, 0, (size_t)M * CPX * sizeof(float), s);
  if (rc != 0) return rc;
  const long long noff = (long long)M * 81;
  if (is_bf16) {
    rc = launch_tc<64, true>(s, xp, offset, wpk, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, nch, nco, goffp);
    if (rc == 0) rc = reduce_wide<__nv_bfloat16>(s, gwp, gw, C, Co, COP, nsplit, goffp, goff, noff, nch);
  } else {
    rc = launch_3xtf32<64, true>(s, xp, offset, wpk, g, gx32, goff, gwp, M, D, H, W, C, aperture, nsplit, nch, nco,
                                 goffp);
    if (rc == 0) rc = reduce_wide<float>(s, gwp, gw, C, Co, COP, nsplit, goffp, goff, noff, nch);
  }
  if (rc != 0 || gx == gx32) return rc;
  const long long n = (long long)M * C;
  if (is_bf16)
    cast_depad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(gx32, static_cast<__nv_bfloat16*>(gx), n, C, CPX);
  else
    cast_depad_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(gx32, static_cast<float*>(gx), n, C, CPX);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the tensor-core blocks, for the build report.
extern "C" int dpf_deform_conv3d_bwd_tc_smem_bytes() { return TcSmem::bytes; }
extern "C" int dpf_deform_conv3d_bwd_3xtf32_smem_bytes(int cp) {
  return cp == 40 ? F32Smem<40>::bytes : F32Smem<64>::bytes;
}
