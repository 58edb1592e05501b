// Per-cell in-order sums for the flock's 3x3 block means, written by
// hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the float scatter-add `bin2d` of
// `src/repro/core/neighbors.py::cell_block_mean`, which the compiled
// reference runs on the CPU as a loop over the SEs in id order, so each
// cell's float32 sum adds its members in id order, starting from 0.
// `index_add_` on CUDA adds through atomics in no fixed order and would
// round differently from run to run.
//
// The design: one thread per cell walks the cell's CSR segment of the
// stable cell sort (`order[starts[c] .. starts[c] + counts[c])`, its
// members in id order) and adds, in that order and rounding each add
// (`__fadd_rn`, no contraction), the five quantities the flock reads:
// the member count, the two position coordinates and the two heading
// components. Every cell's five sums are written, so the output needs no
// memset. The sums are bit-identical to the in-order CPU sum.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void cell_sums_kernel(const float2* __restrict__ pos,
                                 const float2* __restrict__ vec,
                                 const int64_t* __restrict__ order,
                                 const int64_t* __restrict__ starts,
                                 const int64_t* __restrict__ counts,
                                 int ncells, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncells) return;
  const int64_t s = starts[c], m = counts[c];
  float n = 0.f, sx = 0.f, sy = 0.f, vx = 0.f, vy = 0.f;
  for (int64_t k = 0; k < m; ++k) {
    const int64_t j = order[s + k];
    const float2 p = pos[j], v = vec[j];
    n = __fadd_rn(n, 1.f);
    sx = __fadd_rn(sx, p.x);
    sy = __fadd_rn(sy, p.y);
    vx = __fadd_rn(vx, v.x);
    vy = __fadd_rn(vy, v.y);
  }
  out[c] = n;
  out[ncells + c] = sx;
  out[2 * ncells + c] = sy;
  out[3 * ncells + c] = vx;
  out[4 * ncells + c] = vy;
}

}  // namespace

extern "C" int cell_sums_launch(const void* pos, const void* vec,
                                const void* order, const void* starts,
                                const void* counts, int ncells, void* out,
                                void* stream) {
  if (ncells <= 0) return 0;
  const int blocks = (ncells + kThreads - 1) / kThreads;
  cell_sums_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(vec),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(counts), ncells, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cell_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
