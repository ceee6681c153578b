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
// are twice K1's, ~2 x 2 x 221184 x 27 x Cin x 64 FLOP, against ~100 MB
// that must move in bf16. Design: the TPU ran the forward's one-hot
// matmuls in reverse; the card has a cheap gather and f32 atomics, so this
// is a gather/scatter. A block owns one tap and a strided share of the
// voxel tiles (32 voxels each); per tile it recomputes the 8 corner indices,
// weights and weight derivatives of its voxels (as K1 does), forms gcols
// with a small SIMT product against the tap's weight rows kept in shared
// memory, then one warp per voxel walks the channels (neighbouring lanes on
// neighbouring channels, so loads and atomics coalesce): it scatters gx with
// f32 atomicAdd into an f32 buffer, reduces the three offset gradients with
// warp shuffles, and stores the rounded samples for gw. gw accumulates in
// f32 registers per block over its tiles, is written as per-block partial
// sums, and a second pass adds the partials (no atomics on gw, no bf16
// atomics anywhere). A third pass casts gx to bf16 when the input is bf16.
// SIMT f32 FMA and the atomics cap it well below the bound; tensor cores
// are later work.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr float EPS = 1.0f / 1024.0f;
constexpr float AP = 3.0f;
constexpr int CO = 64;     // K1's output channels
constexpr int CMAX = 64;   // largest Cin the kernel takes
constexpr int TV = 32;     // voxels per tile
constexpr int NT = 256;    // threads per block (8 warps)

// d/dpos of the aperture clamp min(max(pos, lo), hi).
__device__ __forceinline__ float clamp_grad(float pos, float lo, float hi) {
  if (pos > lo && pos < hi) return 1.0f;
  if (pos == lo || pos == hi) return 0.5f;
  return 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(NT)
deform_bwd_kernel(const T* __restrict__ x, const T* __restrict__ offset,
                  const T* __restrict__ wmat, const T* __restrict__ g, float* __restrict__ gx32,
                  T* __restrict__ goff, float* __restrict__ gwp, int B, int D, int H, int W, int C,
                  int aperture, int nsplit) {
  __shared__ float Gs[TV][CO + 1];      // g tile [voxel][n]
  __shared__ float Ws[CMAX][CO + 1];    // this tap's weight rows [c][n]
  __shared__ float GCs[TV][CMAX + 1];   // gcols [voxel][c], rounded to T
  __shared__ float As[CMAX][TV + 1];    // cols [c][voxel], rounded to T
  __shared__ int cidx[8][TV];           // corner voxel index, -1 when outside
  __shared__ float cw[8][TV];           // corner weight
  __shared__ float cdd[8][TV], cdh[8][TV], cdw[8][TV];  // its derivative along D, H, W

  const int tap = blockIdx.y, split = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int M = B * D * H * W;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;

  for (int e = tid; e < CMAX * CO; e += NT) {
    const int c = e / CO, n = e - c * CO;
    Ws[c][n] = c < C ? to_f32(wmat[(size_t)(tap * C + c) * CO + n]) : 0.0f;
  }

  float acc[4][4];  // gw partial: c = ty + 16 i, n = tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int ntiles = (M + TV - 1) / TV;
  for (int tile = split; tile < ntiles; tile += nsplit) {
    const int m0 = tile * TV;
    __syncthreads();  // the previous tile's readers are done

    if (tid < TV) {
      const int m = m0 + tid;
      bool valid = m < M;
      float d0 = 0.f, h0 = 0.f, w0 = 0.f, fd = 0.f, fh = 0.f, fw = 0.f, gh = 0.f, gwt = 0.f;
      int b = 0, d = 0, h = 0, w = 0;
      if (valid) {
        int t = m;
        w = t % W; t /= W;
        h = t % H; t /= H;
        d = t % D;
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
        const bool ok = valid && zi >= 0.0f && zi <= (float)(D - 1) && yi >= 0.0f &&
                        yi <= (float)(H - 1) && xi >= 0.0f && xi <= (float)(W - 1);
        const float wz = cz ? fd : 1.0f - fd;
        const float wy = cy ? fh : 1.0f - fh;
        const float wx = cx ? fw : 1.0f - fw;
        const float sz = cz ? 1.0f : -1.0f, sy = cy ? 1.0f : -1.0f, sx = cx ? 1.0f : -1.0f;
        cidx[q][tid] = ok ? ((b * D + (int)zi) * H + (int)yi) * W + (int)xi : -1;
        cw[q][tid] = ok ? (wz * wy) * wx : 0.0f;
        cdd[q][tid] = ok ? sz * wy * wx : 0.0f;
        cdh[q][tid] = ok ? wz * sy * wx * gh : 0.0f;
        cdw[q][tid] = ok ? wz * wy * sx * gwt : 0.0f;
      }
    }
    for (int e = tid; e < TV * CO; e += NT) {
      const int r = e / CO, n = e - r * CO;
      const int m = m0 + r;
      Gs[r][n] = m < M ? to_f32(g[(size_t)m * CO + n]) : 0.0f;
    }
    __syncthreads();

    // gcols = g . W_tap^T: voxel r = ty + 16 i, channel c = tx + 16 j
    {
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int n = 0; n < CO; ++n) {
        float a[2], bw[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = Gs[ty + 16 * i][n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = Ws[tx + 16 * j][n];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bw[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) GCs[ty + 16 * i][tx + 16 * j] = round_to<T>(s[i][j]);
    }
    __syncthreads();

    // one warp per voxel: samples, gx scatter, offset gradients
    for (int i = 0; i < TV / 8; ++i) {
      const int r = warp + 8 * i;
      float pd = 0.0f, ph = 0.0f, pw = 0.0f;
#pragma unroll
      for (int j = 0; j < CMAX / 32; ++j) {
        const int c = lane + 32 * j;
        float s = 0.0f;
        if (c < C) {
          const float gc = GCs[r][c];
          float sd = 0.0f, sh = 0.0f, sw = 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int id = cidx[q][r];
            if (id < 0) continue;
            const float xv = to_f32(x[(size_t)id * C + c]);
            const float wq = cw[q][r];
            s += wq * xv;
            sd += cdd[q][r] * xv;
            sh += cdh[q][r] * xv;
            sw += cdw[q][r] * xv;
            if (wq != 0.0f) atomicAdd(&gx32[(size_t)id * C + c], wq * gc);
          }
          pd += gc * sd;
          ph += gc * sh;
          pw += gc * sw;
        }
        As[c][r] = round_to<T>(s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        pd += __shfl_xor_sync(0xffffffffu, pd, o);
        ph += __shfl_xor_sync(0xffffffffu, ph, o);
        pw += __shfl_xor_sync(0xffffffffu, pw, o);
      }
      const int m = m0 + r;
      if (lane == 0 && m < M) {
        T* op = goff + (size_t)m * 81 + tap * 3;
        op[0] = from_f32<T>(pd);
        op[1] = from_f32<T>(ph);
        op[2] = from_f32<T>(pw);
      }
    }
    __syncthreads();

    // gw partial += cols^T . g
#pragma unroll 4
    for (int r = 0; r < TV; ++r) {
      float a[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][r];
#pragma unroll
      for (int j = 0; j < 4; ++j) bg[j] = Gs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bg[j], acc[i][j]);
    }
  }

  float* part = gwp + (size_t)split * 27 * C * CO;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) part[(size_t)(tap * C + c) * CO + tx + 16 * j] = acc[i][j];
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

template <typename T>
int launch(cudaStream_t s, const void* x, const void* offset, const void* wmat, const void* g,
           float* gx32, void* goff, float* gwp, void* gw, int B, int D, int H, int W, int C,
           int aperture, int nsplit) {
  deform_bwd_kernel<T><<<dim3((unsigned)nsplit, 27), NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(offset), static_cast<const T*>(wmat),
      static_cast<const T*>(g), gx32, static_cast<T*>(goff), gwp, B, D, H, W, C, aperture, nsplit);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int n = 27 * C * CO;
  reduce_gw_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(gwp, static_cast<T*>(gw), n, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, D, H, W, C] (C <= 64), offset [B, D, H, W, 81], wmat [27*C, CO], g
// [B, D, H, W, CO]; contiguous, one dtype (is_bf16 selects bf16, else f32).
// Scratch: gx32 f32 [B*D*H*W*C] (zeroed here), gwp f32 [nsplit, 27*C, CO].
// Outputs: gx [B, D, H, W, C] (for f32 pass gx32 itself), goff like
// offset, gw [27*C, CO], all in the input dtype. Returns
// cudaErrorInvalidValue for Co != CO, C > 64 or nsplit < 1, else the first
// launch error.
extern "C" int dpf_deform_conv3d_bwd(const void* x, const void* offset, const void* wmat,
                                     const void* g, float* gx32, void* gx, void* goff, float* gwp,
                                     void* gw, int B, int D, int H, int W, int C, int Co,
                                     int nsplit, int aperture, int is_bf16, void* stream) {
  if (Co != CO || C < 1 || C > CMAX || nsplit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nx = (long long)B * D * H * W * C;
  int rc = (int)cudaMemsetAsync(gx32, 0, (size_t)nx * sizeof(float), s);
  if (rc != 0) return rc;
  rc = is_bf16 ? launch<__nv_bfloat16>(s, x, offset, wmat, g, gx32, goff, gwp, gw, B, D, H, W, C,
                                       aperture, nsplit)
               : launch<float>(s, x, offset, wmat, g, gx32, goff, gwp, gw, B, D, H, W, C,
                               aperture, nsplit);
  if (rc != 0 || !is_bf16) return rc;
  return dpf::cast_bf16(gx32, gx, nx, s);
}
