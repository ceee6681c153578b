// T2: lane gather-sum, the gather primitive of the fused deform kernel.
// out[g, r, l] = sum_k tab[g, r, idx[g, k, l]] for k = 0..7 in order, each
// add rounded to the data dtype (f32 with int32 indices, bf16 with int16).
//
// Replaces the TPU kernel `gather_bench` -> `kern` (tools/bench_vpu_prims.py:39,
// call at :53): Mosaic's `dynamic_gather` (`take_along_axis` along the
// 128 lanes of a vreg row) with the index row broadcast over every row.
//
// Bound on the H100: bytes. Per g the kernel reads rows x 128 table values
// and 8 x 128 indices and writes rows x 128 values, at 2 operations per
// gathered value: 2 per 4-byte f32 value moved, far below the ~20
// FLOP/byte f32 ridge (67 TFLOP/s over 3.35 TB/s).
// Design: a block owns RT rows of one g. Each thread holds its lane's 8
// indices in registers (read once per block, coalesced). The block stages
// its rows in shared memory with coalesced loads, then each thread gathers
// from its row in shared memory (random lanes, at worst 32-way bank
// conflicts, never a device-memory transaction) and writes its output lane:
// neighbouring threads take neighbouring lanes, so every device-memory
// access is coalesced and each byte is moved once.
#include "common.cuh"

namespace {

using namespace dpf;

constexpr int LANES = 128;
constexpr int REPS = 8;     // index rows per g
constexpr int RT = 32;      // table rows per block
constexpr int THREADS = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
lane_gather_sum_kernel(const T* __restrict__ tab, const I* __restrict__ idx, T* __restrict__ out,
                       int rows) {
  __shared__ float rs[RT][LANES];
  const int g = blockIdx.y;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, rows - r0);
  const int lane = threadIdx.x % LANES, half = threadIdx.x / LANES;
  int ix[REPS];
#pragma unroll
  for (int k = 0; k < REPS; ++k) ix[k] = (int)idx[((size_t)g * REPS + k) * LANES + lane] & (LANES - 1);

  const size_t base = ((size_t)g * rows + r0) * LANES;
  for (int e = threadIdx.x; e < nr * LANES; e += THREADS) rs[e / LANES][e % LANES] = to_f32(tab[base + e]);
  __syncthreads();
  for (int r = half; r < nr; r += THREADS / LANES) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < REPS; ++k) acc = round_to<T>(acc + rs[r][ix[k]]);
    out[base + (size_t)r * LANES + lane] = from_f32<T>(acc);
  }
}

}  // namespace

// tab [G, rows, 128], idx [G, 8, 128], out [G, rows, 128], contiguous;
// is_bf16: bf16 data with int16 indices, else f32 data with int32 indices.
// Indices are taken modulo 128, as the plain version takes them.
// Returns cudaGetLastError() after the launch.
extern "C" int dpf_lane_gather_sum(const void* tab, const void* idx, void* out, int G, int rows,
                                   int is_bf16, void* stream) {
  dim3 grid((unsigned)((rows + RT - 1) / RT), (unsigned)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    lane_gather_sum_kernel<__nv_bfloat16, int16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(tab), static_cast<const int16_t*>(idx),
        static_cast<__nv_bfloat16*>(out), rows);
  else
    lane_gather_sum_kernel<float, int32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(tab), static_cast<const int32_t*>(idx), static_cast<float*>(out), rows);
  return (int)cudaGetLastError();
}
