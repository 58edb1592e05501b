// Cell-list proximity LP histogram, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/proximity/grid.py::proximity_lp_counts_grid
// which tiles a materialised (N, 9 * capacity) candidate table in
// 256 x 256 VMEM blocks and reduces it with n_lp masked VPU sums.
//
// What bounds it on this card: the work is a gather. Each sender reads
// the positions and LPs of the members of its 3x3 neighbour cells
// (about 9 * mean occupancy of them, ~56 at the paper's density) and
// does ~11 float32 operations per candidate, far below the card's
// float32 rate; the bytes it must move once are O(N) (sorted positions,
// LPs, flags, the CSR offsets, the output), so at the engine's sizes the
// floor is the memory rate, and at 10k SEs launch latency dominates.
//
// What the design does about it:
//   * it never builds the candidate table: it reads the CSR grid that
//     the wrapper's stable sort produced (order, starts, counts, and
//     positions / LPs / sender flags gathered into sorted order), so the
//     only traffic is the sorted arrays themselves;
//   * one thread per row in sorted cell order, so the threads of a warp
//     mostly share their 9 segments and their loads hit L1/L2;
//   * the histogram lives in registers: a fully unrolled compare-add
//     over a compile-time bound MAXL >= n_lp (4 ... 64);
//   * non-senders write zeros and leave at once.
//
// Per pair it evaluates exactly the reference's compiled expression:
//   d = |pi - pj|; d = min(d, area - d); fma(dx, dx, dy * dy) <= rng^2
// with the intrinsics written out, so nvcc's own contraction picks
// neither the operand order nor the rounding. Each segment is read up to
// min(count, capacity) members, like the reference's segment window;
// the wrapper reports the grid's overflow flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float wrapped(float a, float b, float area) {
  float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(area, d));
}

template <int MAXL>
__global__ void grid_lp_counts_kernel(
    const float2* __restrict__ pos_sorted,      // (n,) sorted cell order
    const int32_t* __restrict__ lp_sorted,      // (n,)
    const uint8_t* __restrict__ sender_sorted,  // (n,) 0/1
    const int32_t* __restrict__ cell_sorted,    // (n,) cell of each row
    const int64_t* __restrict__ order,          // (n,) sorted row -> id
    const int64_t* __restrict__ starts,         // (ncell^2,)
    const int64_t* __restrict__ counts,         // (ncell^2,)
    int n, int ncell, int capacity, int n_lp, float area, float rng2,
    int32_t* __restrict__ out) {                // (n, n_lp) id order
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t* o = out + order[i] * n_lp;
  int hist[MAXL];
#pragma unroll
  for (int t = 0; t < MAXL; ++t) hist[t] = 0;
  if (sender_sorted[i]) {
    const float2 p = pos_sorted[i];
    const int c = cell_sorted[i];
    const int cx = c / ncell, cy = c - (c / ncell) * ncell;
    for (int di = -1; di <= 1; ++di) {
      int nx = cx + di;
      nx += nx < 0 ? ncell : 0;
      nx -= nx >= ncell ? ncell : 0;
      for (int dj = -1; dj <= 1; ++dj) {
        int ny = cy + dj;
        ny += ny < 0 ? ncell : 0;
        ny -= ny >= ncell ? ncell : 0;
        const int nc = nx * ncell + ny;
        const int64_t s = starts[nc];
        const int64_t cnt = counts[nc];
        const int64_t m = cnt < capacity ? cnt : capacity;
        for (int64_t k = 0; k < m; ++k) {
          const int64_t j = s + k;
          if (j == i) continue;
          const float2 q = pos_sorted[j];
          const float dx = wrapped(p.x, q.x, area);
          const float dy = wrapped(p.y, q.y, area);
          if (__fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= rng2) {
            const int l = lp_sorted[j];
#pragma unroll
            for (int t = 0; t < MAXL; ++t) hist[t] += (l == t);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < MAXL; ++t) {
    if (t < n_lp) o[t] = hist[t];
  }
}

template <int MAXL>
void launch(const void* pos_sorted, const void* lp_sorted,
            const void* sender_sorted, const void* cell_sorted,
            const void* order, const void* starts, const void* counts, int n,
            int ncell, int capacity, int n_lp, float area, float rng2,
            void* out, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  grid_lp_counts_kernel<MAXL><<<blocks, threads, 0, stream>>>(
      static_cast<const float2*>(pos_sorted),
      static_cast<const int32_t*>(lp_sorted),
      static_cast<const uint8_t*>(sender_sorted),
      static_cast<const int32_t*>(cell_sorted),
      static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(counts), n, ncell, capacity, n_lp, area,
      rng2, static_cast<int32_t*>(out));
}

}  // namespace

extern "C" int grid_lp_counts_launch(
    const void* pos_sorted, const void* lp_sorted, const void* sender_sorted,
    const void* cell_sorted, const void* order, const void* starts,
    const void* counts, int n, int ncell, int capacity, int n_lp, float area,
    float rng2, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lp <= 4) {
    launch<4>(pos_sorted, lp_sorted, sender_sorted, cell_sorted, order,
              starts, counts, n, ncell, capacity, n_lp, area, rng2, out, s);
  } else if (n_lp <= 8) {
    launch<8>(pos_sorted, lp_sorted, sender_sorted, cell_sorted, order,
              starts, counts, n, ncell, capacity, n_lp, area, rng2, out, s);
  } else if (n_lp <= 16) {
    launch<16>(pos_sorted, lp_sorted, sender_sorted, cell_sorted, order,
               starts, counts, n, ncell, capacity, n_lp, area, rng2, out, s);
  } else if (n_lp <= 32) {
    launch<32>(pos_sorted, lp_sorted, sender_sorted, cell_sorted, order,
               starts, counts, n, ncell, capacity, n_lp, area, rng2, out, s);
  } else if (n_lp <= 64) {
    launch<64>(pos_sorted, lp_sorted, sender_sorted, cell_sorted, order,
               starts, counts, n, ncell, capacity, n_lp, area, rng2, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* proximity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
