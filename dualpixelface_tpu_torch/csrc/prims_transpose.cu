// T3: transpose-sum, the relayout primitive of the fused deform kernel.
// x [G, 8, 128, 80] -> out[g, c, l] = sum_k x[g, k, l, c], shape [G, 80, 128],
// each add rounded to the data dtype, in k order.
//
// Replaces the TPU kernel `transpose_bench` -> `kern`
// (tools/bench_vpu_prims.py:70, call at :80): an in-kernel minor-dims
// transpose [128, 80] -> [80, 128] of each of the 8 slabs of a block.
//
// Bound on the H100: bytes (8 x 128 x 80 values read and 80 x 128 written
// per g, one add per value read).
// Design: a block owns one g. For each k it stages the [128, 80] slab in
// shared memory with coalesced loads along the 80-wide rows (a row stride
// of 81 floats, so the transposed reads fall on 32 distinct banks), then
// each thread adds its 40 outputs' values from the transposed slab into
// registers; the [80, 128] result is written once, coalesced along the
// 128-wide rows.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr int REPS = 8;
constexpr int L = 128;   // rows of a slab, lanes of the output
constexpr int C = 80;    // columns of a slab, rows of the output
constexpr int THREADS = 256;
constexpr int PER = L * C / THREADS;  // outputs (and loads per slab) per thread: 40

template <typename T>
__global__ void __launch_bounds__(THREADS)
transpose_sum_kernel(const T* __restrict__ x, T* __restrict__ out) {
  __shared__ float slab[L][C + 1];
  const int g = blockIdx.x, t = threadIdx.x;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.0f;
  for (int k = 0; k < REPS; ++k) {
    const T* src = x + ((size_t)g * REPS + k) * L * C;
#pragma unroll 8
    for (int j = 0; j < PER; ++j) {
      const int e = t + THREADS * j;
      slab[e / C][e % C] = to_f32(src[e]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int o = t + THREADS * j;  // o = c * L + l
      acc[j] = round_to<T>(acc[j] + slab[o % L][o / L]);
    }
    __syncthreads();
  }
  T* dst = out + (size_t)g * C * L;
#pragma unroll
  for (int j = 0; j < PER; ++j) dst[t + THREADS * j] = from_f32<T>(acc[j]);
}

}  // namespace

// x [G, 8, 128, 80], out [G, 80, 128], contiguous, one dtype (is_bf16
// selects bf16, else f32). Returns cudaGetLastError() after the launch.
extern "C" int dpf_transpose_sum(const void* x, void* out, int G, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    transpose_sum_kernel<__nv_bfloat16><<<G, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                             static_cast<__nv_bfloat16*>(out));
  else
    transpose_sum_kernel<float><<<G, THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
