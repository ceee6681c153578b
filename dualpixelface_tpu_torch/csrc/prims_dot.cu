// T4: batched small product, the contraction primitive of the fused deform
// kernel. a [G, m, k] x b [G, k, n] -> out [G, m, n] in f32: products of
// the input dtype's values (exact in f32 for bf16), sums in f32.
//
// Replaces the TPU kernel `dot_bench` -> `kern` (tools/bench_vpu_prims.py:94,
// call at :104): one MXU `dot_general` per grid step with
// preferred_element_type f32.
//
// Bound on the H100: at (m, k, n) = (128, 2240, 64) in f32, operations on
// the CUDA cores, barely (per g 36.7 MFLOP against 1.75 MB: 21 FLOP per
// byte, just above the f32 ridge of 67 TFLOP/s over 3.35 TB/s); in bf16,
// bytes (the tensor cores would take a seventh of the time the memory
// does). At m = 32, bytes in either dtype.
// Design: a tiled SIMT product with f32 FMA, no library call. A block of
// 16 x 16 threads owns 16*TM rows of one g and all 64 columns; each thread
// keeps TM x 4 accumulators (rows ty + 16 i, columns tx + 16 j). Per step
// of BK = 32 along k it stages the a tile transposed in shared memory
// (32 consecutive threads read 32 consecutive k of one row; a row stride of
// 16*TM + 1 keeps the stores on distinct banks) and the b tile as it lies
// (rows of 64 contiguous values). TM = 8 for m > 32, TM = 2 for m <= 32, so
// the small-m case wastes no rows; rows past m are masked. A tensor-core
// (mma.sync / wgmma) path is later work.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr int N = 64;
constexpr int TN = N / 16;
constexpr int KB = 32;

template <typename T, int TMR>
__global__ void __launch_bounds__(NTHREADS)
batched_dot_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out, int m, int k) {
  constexpr int MB = 16 * TMR;
  __shared__ float As[KB][MB + 1];
  __shared__ float Bs[KB][N];
  const int g = blockIdx.y, m0 = blockIdx.x * MB;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* ag = a + (size_t)g * m * k;
  const T* bg = b + (size_t)g * k * N;

  float acc[TMR][TN];
#pragma unroll
  for (int i = 0; i < TMR; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += KB) {
    for (int e = tid; e < KB * MB; e += NTHREADS) {
      const int kk = e % KB, row = e / KB;
      float v = 0.0f;
      if (m0 + row < m && k0 + kk < k) v = to_f32(ag[(size_t)(m0 + row) * k + k0 + kk]);
      As[kk][row] = v;
    }
    for (int e = tid; e < KB * N; e += NTHREADS) {
      const int kk = e / N, n = e % N;
      Bs[kk][n] = k0 + kk < k ? to_f32(bg[(size_t)(k0 + kk) * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KB; ++kk) {
      float av[TMR], bv[TN];
#pragma unroll
      for (int i = 0; i < TMR; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TMR; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* og = out + (size_t)g * m * N;
#pragma unroll
  for (int i = 0; i < TMR; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) og[(size_t)row * N + tx + 16 * j] = acc[i][j];
  }
}

template <typename T>
void launch(int G, int m, int k, cudaStream_t s, const void* a, const void* b, float* out) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  if (m <= 32)
    batched_dot_kernel<T, 2><<<dim3((unsigned)((m + 31) / 32), (unsigned)G), NTHREADS, 0, s>>>(pa, pb, out, m, k);
  else
    batched_dot_kernel<T, 8><<<dim3((unsigned)((m + 127) / 128), (unsigned)G), NTHREADS, 0, s>>>(pa, pb, out, m, k);
}

}  // namespace

// a [G, m, k], b [G, k, 64] (one dtype: is_bf16 selects bf16, else f32),
// out [G, m, 64] f32; all contiguous. Returns cudaErrorInvalidValue for
// n != 64, else cudaGetLastError() after the launch.
extern "C" int dpf_batched_dot(const void* a, const void* b, void* out, int G, int m, int k, int n,
                               int is_bf16, void* stream) {
  if (n != N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(G, m, k, s, a, b, static_cast<float*>(out));
  else
    launch<float>(G, m, k, s, a, b, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
