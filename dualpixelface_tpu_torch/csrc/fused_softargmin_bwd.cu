// K4: backward of the fused x4 upsample + soft-argmin (K3).
//
// Replaces the TPU kernel `_fsam_bwd` (`_bwd_kernel`;
// dualpixelface_tpu/ops/kernels/fused_softargmin.py:198, call at :221).
// With p = softmax(logits) over the 4D upsampled bins of an output pixel and
// out = sum_j p_j dv_j, the cotangent of the logits is
//   glogit_j = g * p_j * (dv_j - out)
// and the cost gradient is U^T glogit for the separable align-corners
// operator U = Wd x Wy x Wx: dcost [B, D, h, w], summed in f32 and written
// once in the cost's dtype.
//
// Bound on the H100: the exps. At the train path's shape ([2, 8, 192, 144]
// -> 768 x 576) it moves ~3.5 MB in bf16 (cost and g read once, dcost
// written once: 1.0 us) and does ~0.43 GFLOP of f32 work, K3's
// interpolation and softmax and the transposed interpolation (6.4 us at
// 67 TFLOP/s), but takes 28.3 M exps on the special-function units (6.8 us).
//
// Design: owner computes. A block owns a tile of coarse cells, all D planes
// x RB coarse rows x SPAN coarse columns, and recomputes every output pixel
// whose taps touch it: the output rows of its band (`bands`, from the host:
// ~4 RB + 4 rows) x the quads of its columns and one on each side. Each lane
// of a warp takes one quad (fsam.cuh) of one output row: it recomputes the
// pixels' planes and bins as K3 does (one exp2 per bin, shifted by the
// largest bin), folds the glogits onto
// the planes as it goes (per plane, S0 = sum of w e and S1 = sum of w dv e
// over the plane's bins, so gd = g/sum (S1 - out S0) with no stored exps),
// keeps each pixel's gd on the quad's middle column and hands its shares
// of the outer two to the neighbouring lanes by warp shuffles: lane L then
// holds the whole of its column's share (lanes 0 and 31 only feed their
// neighbours). The block's warps split the band's output rows; each adds
// its rows into its own shared-memory copy of the tile (one lane per
// column: no atomics), and the copies are summed in a fixed order and
// written once. One launch, no f32 scratch in device memory, and the same
// sums in the same order on every run. D <= 16 compiles the taps in (one
// instantiation per D); above, `fsam_bwd_wide_kernel` takes D at run time
// and a block owns 16 of the planes (fsam.cuh).
#include <cstring>

#include "fsam.cuh"

namespace {

using namespace fsam;

constexpr int NW = 8;     // warps per block, each a share of the band's output rows
constexpr int RB = 8;     // coarse rows per band
constexpr int SPAN = 30;  // coarse columns a block owns: lanes 1..30 of its warps
constexpr int THREADS = NW * 32;

// One pixel's bins with q shifted: per plane S0 += w e, S1 += w dv e.
template <int D>
__device__ __forceinline__ void plane_sums(const float (&q)[D], const Bins& bn, float (&S0)[D], float (&S1)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) S0[d] = S1[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < FACTOR * D; ++j) {
    const float e = ex2(bin_logit<D>(q, bn, j));
    S0[tap_lo<D>(j)] = fmaf(bn.wa[j], e, S0[tap_lo<D>(j)]);
    S1[tap_lo<D>(j)] = fmaf(bn.wadv[j], e, S1[tap_lo<D>(j)]);
    S0[tap_hi<D>(j)] = fmaf(bn.wb[j], e, S0[tap_hi<D>(j)]);
    S1[tap_hi<D>(j)] = fmaf(bn.wbdv[j], e, S1[tap_hi<D>(j)]);
  }
}

// One pixel's gd (into S1) from the quad's columns R, the pixel's weights
// u on them and its cotangent g, the bins shifted by the largest.
template <int D>
__device__ __forceinline__ void pixel_gd(const float (&R)[3][D], float4 u, float g, const Bins& bn, float (&S1)[D]) {
  float q[D], S0[D];
  pixel_planes<D>(R, u, q);
  shift_by_max_bin<D>(q, bn);
  plane_sums<D>(q, bn, S0, S1);
  float sum = 0.0f, num = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    sum += S0[d];
    num += S1[d];
  }
  const float rs = __frcp_rn(sum), out = num * rs, gi = g * rs;
#pragma unroll
  for (int d = 0; d < D; ++d) S1[d] = gi * fmaf(-out, S0[d], S1[d]);
}

// Column q's share of a pixel's gd: its weight on the quad's middle column
// stays, its shares of the outer columns go to the neighbouring lanes,
// whose middle column they are. Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void gather_columns(float (&col)[D], float4 u, const float (&gd)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d)
    col[d] = fmaf(u.y, gd[d], col[d]) + __shfl_up_sync(0xffffffffu, u.z * gd[d], 1) +
             __shfl_down_sync(0xffffffffu, u.x * gd[d], 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 8 ? 2 : 1)
fsam_bwd_kernel(const T* __restrict__ cost, const T* __restrict__ gout, T* __restrict__ dcost, int h, int w,
                const int2* __restrict__ ytap, const float2* __restrict__ ywt, const float4* __restrict__ xu,
                const int2* __restrict__ bands, const __grid_constant__ Bins bn) {
  extern __shared__ float acc[];  // [NW][RB][D][32]: each warp's copy of the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * SPAN, r0 = blockIdx.y * RB, b = blockIdx.z;
  const int Hp = FACTOR * h, Wp = FACTOR * w;
  const int q = c0 - 1 + lane;  // this lane's quad and the column it gathers
  const bool active = q >= 0 && q < w;

  for (int i = threadIdx.x; i < NW * RB * D * 32; i += THREADS) acc[i] = 0.0f;
  __syncthreads();

  float* mine = acc + warp * RB * D * 32 + lane;
  const T* cb = cost + (size_t)b * D * h * w;
  const Quad qd(q, w);
  const int2 band = __ldg(bands + blockIdx.y);
  for (int Y = band.x + warp; Y < band.y; Y += NW) {  // warp-uniform
    const int2 yi = __ldg(ytap + Y);
    const float2 yw = __ldg(ywt + Y);
    float R[3][D];
    if (active) rows_interp<T, D>(cb, h, w, yi.x, yi.y, yw.x, yw.y, qd, R);
    const T* grow = gout + ((size_t)b * Hp + Y) * Wp + 4 * q;
    float col[D];  // column q's share of this output row
#pragma unroll
    for (int d = 0; d < D; ++d) col[d] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float gd[D];
#pragma unroll
      for (int d = 0; d < D; ++d) gd[d] = 0.0f;
      if (active) {
        u = __ldg(xu + 4 * q + k);
        pixel_gd<D>(R, u, to_f32(grow[k]), bn, gd);
      }
      gather_columns<D>(col, u, gd);
    }
    const bool r0in = yi.x >= r0 && yi.x < r0 + RB;
    const bool r1in = yw.y != 0.0f && yi.y >= r0 && yi.y < r0 + RB;
    float* row0 = mine + (yi.x - r0) * D * 32;
    float* row1 = mine + (yi.y - r0) * D * 32;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (r0in) row0[d * 32] += yw.x * col[d];
      if (r1in) row1[d * 32] += yw.y * col[d];
    }
  }
  __syncthreads();

  // the tile: lanes 1..30 of the copies, summed in warp order, written once
  for (int i = threadIdx.x; i < RB * D * 32; i += THREADS) {
    const int L = i & 31, d = (i >> 5) % D, r = i / (32 * D);
    const int col = c0 - 1 + L, yc = r0 + r;
    if (L == 0 || L == 31 || col >= w || yc >= h) continue;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < NW; ++k) v += acc[k * RB * D * 32 + i];
    dcost[(((size_t)b * D + d) * h + yc) * w + col] = from_f32<T>(v);
  }
}

constexpr int smem_bytes(int D) { return NW * RB * D * 32 * (int)sizeof(float); }

template <typename T, int D>
int launch(const void* cost, const void* gout, void* dcost, int B, int h, int w, const int* ytap,
           const float* ywt, const float* xu, const int* bands, const Bins& bn, cudaStream_t s) {
  constexpr int smem = smem_bytes(D);
  static const int attr = (int)cudaFuncSetAttribute(fsam_bwd_kernel<T, D>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != 0) return attr;
  const dim3 grid((unsigned)((w + SPAN - 1) / SPAN), (unsigned)((h + RB - 1) / RB), (unsigned)B);
  fsam_bwd_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(cost), static_cast<const T*>(gout), static_cast<T*>(dcost), h, w,
      reinterpret_cast<const int2*>(ytap), reinterpret_cast<const float2*>(ywt),
      reinterpret_cast<const float4*>(xu), reinterpret_cast<const int2*>(bands), bn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* cost, const void* gout, void* dcost, int B, int h, int w, const int* ytap,
             const float* ywt, const float* xu, const int* bands, const Bins& bn, cudaStream_t s) {
  switch (D) {
#define FSAM_CASE(d) \
  case d:            \
    return launch<T, d>(cost, gout, dcost, B, h, w, ytap, ywt, xu, bands, bn, s);
    FSAM_CASE(1) FSAM_CASE(2) FSAM_CASE(3) FSAM_CASE(4) FSAM_CASE(5) FSAM_CASE(6) FSAM_CASE(7) FSAM_CASE(8)
    FSAM_CASE(9) FSAM_CASE(10) FSAM_CASE(11) FSAM_CASE(12) FSAM_CASE(13) FSAM_CASE(14) FSAM_CASE(15) FSAM_CASE(16)
#undef FSAM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// D > MAXD: the planes in chunks of DC = 16. A block owns one chunk of
// its tile's planes (the grid's z: batch x chunk) and recomputes, for every
// output pixel of its band, the whole softmax (`wide_softmax`: the planes
// walked twice, the bins shifted by the largest), then, a third walk over
// the planes around its chunk, the plane sums S0 and S1 of the bins that
// touch the chunk; the rest is the kernel above with DC planes.
constexpr int DC = MAXD;

template <typename T>
__device__ __forceinline__ void wide_pixel_gd(const WidePixel<T>& px, float g, const float* __restrict__ bins, int D,
                                              int d0, float (&S1)[DC]) {
  const int nb = FACTOR * D;
  const float *wa = bins, *wb = bins + nb, *wadv = bins + 3 * nb, *wbdv = bins + 4 * nb;
  float sum, num;
  const float m = wide_softmax<T>(px, bins, D, sum, num);
  float S0[DC];
#pragma unroll
  for (int d = 0; d < DC; ++d) S0[d] = S1[d] = 0.0f;
  float plo;
  if (d0 > 0) {  // the bins between planes d0 - 1 and d0 give plane d0 their hi share
    plo = (px.plane(d0 - 1) - m) * LOG2E;
    const float phi = (px.plane(d0) - m) * LOG2E;
    for (int j = wide_first_bin(d0 - 1, D); j < nb && wide_lo(j, D) == d0 - 1; ++j) {
      const float e = ex2(fmaf(__ldg(wb + j), phi, __ldg(wa + j) * plo));
      S0[0] = fmaf(__ldg(wb + j), e, S0[0]);
      S1[0] = fmaf(__ldg(wbdv + j), e, S1[0]);
    }
    plo = phi;
  } else {
    plo = (px.plane(0) - m) * LOG2E;
  }
#pragma unroll
  for (int dd = 0; dd < DC; ++dd) {
    const int d = d0 + dd;
    if (d >= D) break;
    const float phi = d + 1 < D ? (px.plane(d + 1) - m) * LOG2E : plo;
    for (int j = wide_first_bin(d, D); j < nb && wide_lo(j, D) == d; ++j) {
      const float e = ex2(fmaf(__ldg(wb + j), phi, __ldg(wa + j) * plo));
      S0[dd] = fmaf(__ldg(wa + j), e, S0[dd]);
      S1[dd] = fmaf(__ldg(wadv + j), e, S1[dd]);
      if (d + 1 == D) {  // the last plane's bins: lo = hi
        S0[dd] = fmaf(__ldg(wb + j), e, S0[dd]);
        S1[dd] = fmaf(__ldg(wbdv + j), e, S1[dd]);
      } else if (dd + 1 < DC) {
        S0[dd + 1] = fmaf(__ldg(wb + j), e, S0[dd + 1]);
        S1[dd + 1] = fmaf(__ldg(wbdv + j), e, S1[dd + 1]);
      }
    }
    plo = phi;
  }
  const float rs = __frcp_rn(sum), out = num * rs, gi = g * rs;
#pragma unroll
  for (int d = 0; d < DC; ++d) S1[d] = gi * fmaf(-out, S0[d], S1[d]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fsam_bwd_wide_kernel(const T* __restrict__ cost, const T* __restrict__ gout, T* __restrict__ dcost, int D, int h,
                     int w, const int2* __restrict__ ytap, const float2* __restrict__ ywt,
                     const float4* __restrict__ xu, const int2* __restrict__ bands, const float* __restrict__ bins) {
  extern __shared__ float acc[];  // [NW][RB][DC][32]: each warp's copy of the tile's chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nchunk = (D + DC - 1) / DC;
  const int c0 = blockIdx.x * SPAN, r0 = blockIdx.y * RB, b = blockIdx.z / nchunk;
  const int d0 = (blockIdx.z - b * nchunk) * DC;
  const int Hp = FACTOR * h, Wp = FACTOR * w;
  const int q = c0 - 1 + lane;  // this lane's quad and the column it gathers
  const bool active = q >= 0 && q < w;

  for (int i = threadIdx.x; i < NW * RB * DC * 32; i += THREADS) acc[i] = 0.0f;
  __syncthreads();

  float* mine = acc + warp * RB * DC * 32 + lane;
  const int2 band = __ldg(bands + blockIdx.y);
  for (int Y = band.x + warp; Y < band.y; Y += NW) {  // warp-uniform
    const int2 yi = __ldg(ytap + Y);
    const float2 yw = __ldg(ywt + Y);
    WidePixel<T> px{cost + (size_t)b * D * h * w, (size_t)h * w, w, yi.x, yi.y, yw.x, yw.y, Quad(q, w),
                    make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    const T* grow = gout + ((size_t)b * Hp + Y) * Wp + 4 * q;
    float col[DC];  // column q's share of this output row
#pragma unroll
    for (int d = 0; d < DC; ++d) col[d] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float gd[DC];
#pragma unroll
      for (int d = 0; d < DC; ++d) gd[d] = 0.0f;
      if (active) {
        u = __ldg(xu + 4 * q + k);
        px.u = u;
        wide_pixel_gd<T>(px, to_f32(grow[k]), bins, D, d0, gd);
      }
      gather_columns<DC>(col, u, gd);
    }
    const bool r0in = yi.x >= r0 && yi.x < r0 + RB;
    const bool r1in = yw.y != 0.0f && yi.y >= r0 && yi.y < r0 + RB;
    float* row0 = mine + (yi.x - r0) * DC * 32;
    float* row1 = mine + (yi.y - r0) * DC * 32;
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      if (r0in) row0[d * 32] += yw.x * col[d];
      if (r1in) row1[d * 32] += yw.y * col[d];
    }
  }
  __syncthreads();

  // the tile's chunk: lanes 1..30 of the copies, summed in warp order, written once
  for (int i = threadIdx.x; i < RB * DC * 32; i += THREADS) {
    const int L = i & 31, d = (i >> 5) % DC, r = i / (32 * DC);
    const int col = c0 - 1 + L, yc = r0 + r;
    if (L == 0 || L == 31 || col >= w || yc >= h || d0 + d >= D) continue;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < NW; ++k) v += acc[k * RB * DC * 32 + i];
    dcost[(((size_t)b * D + d0 + d) * h + yc) * w + col] = from_f32<T>(v);
  }
}

}  // namespace

// D > 16 (any D): as `dpf_fused_softargmin_bwd`, the bin table on the
// device, f32 [5, 4D] (the rows of `Bins`, each 4D long). One launch;
// returns cudaGetLastError(), or cudaErrorInvalidValue for D <= 16 or
// band_rows other than RB.
extern "C" int dpf_fused_softargmin_bwd_wide(const void* cost, const void* gout, void* dcost, int B, int D, int h,
                                             int w, const int* ytap, const float* ywt, const float* xu,
                                             const int* bands, int band_rows, const float* bins, int is_bf16,
                                             void* stream) {
  if (D <= MAXD || band_rows != RB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int smem = smem_bytes(DC);
  const dim3 grid((unsigned)((w + SPAN - 1) / SPAN), (unsigned)((h + RB - 1) / RB),
                  (unsigned)(B * ((D + DC - 1) / DC)));
  if (is_bf16) {
    static const int attr = (int)cudaFuncSetAttribute(fsam_bwd_wide_kernel<__nv_bfloat16>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != 0) return attr;
    fsam_bwd_wide_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(cost), static_cast<const __nv_bfloat16*>(gout),
        static_cast<__nv_bfloat16*>(dcost), D, h, w, reinterpret_cast<const int2*>(ytap),
        reinterpret_cast<const float2*>(ywt), reinterpret_cast<const float4*>(xu),
        reinterpret_cast<const int2*>(bands), bins);
  } else {
    static const int attr = (int)cudaFuncSetAttribute(fsam_bwd_wide_kernel<float>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != 0) return attr;
    fsam_bwd_wide_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(cost), static_cast<const float*>(gout), static_cast<float*>(dcost), D, h, w,
        reinterpret_cast<const int2*>(ytap), reinterpret_cast<const float2*>(ywt),
        reinterpret_cast<const float4*>(xu), reinterpret_cast<const int2*>(bands), bins);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory of K4's block for D coarse planes.
extern "C" int dpf_fused_softargmin_bwd_smem_bytes(int D) { return smem_bytes(D); }

// cost [B, D, h, w] (1 <= D <= 16) and gout [B, 4h, 4w] in one dtype (is_bf16
// selects bf16, else f32); dcost [B, D, h, w] the output in that dtype, every
// element written. ytap, ywt, xu and bins as for K3 (`dpf_fused_softargmin`);
// bands int32 [ceil(h / band_rows), 2]: the output rows [first, end) whose
// taps touch coarse rows [band_rows i, band_rows (i + 1)), on the device.
// One launch; returns cudaGetLastError(), or cudaErrorInvalidValue for D
// outside 1..16 or band_rows other than RB.
extern "C" int dpf_fused_softargmin_bwd(const void* cost, const void* gout, void* dcost, int B, int D, int h,
                                        int w, const int* ytap, const float* ywt, const float* xu,
                                        const int* bands, int band_rows, const float* bins, int is_bf16,
                                        void* stream) {
  if (band_rows != RB) return (int)cudaErrorInvalidValue;
  Bins bn;
  memcpy(&bn, bins, sizeof bn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(D, cost, gout, dcost, B, h, w, ytap, ywt, xu, bands, bn, s)
                 : dispatch<float>(D, cost, gout, dcost, B, h, w, ytap, ywt, xu, bands, bn, s);
}
