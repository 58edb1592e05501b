// Dense proximity LP histogram, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/proximity/proximity.py::proximity_lp_counts
// which sweeps (256 x 256) tiles of sender x recipient pairs and reduces
// the per-sender histogram as `mask @ onehot(lp)` on the MXU.
//
// What bounds it on this card: operations. It reads O(N) bytes (the
// positions, LPs and sender flags, and writes N * n_lp counts) but tests
// n_senders * (N - 1) pairs at ~11 float32 operations each, so the floor
// is the float32 (non-tensor-core) rate.
//
// What the design does about it:
//   * a block of TILE sender rows (one per thread) stages TILE recipient
//     positions and LPs at a time in shared memory, so each recipient is
//     read from device memory once per block, not once per pair;
//   * the histogram is a per-thread register count (fully unrolled
//     compare-add over a compile-time bound MAXL >= n_lp): there is no
//     shared one-hot operand worth a tensor-core product here, and the
//     counts stay exact integers;
//   * nothing is padded: the last tile is cut at n, and no padded row or
//     column reaches the output.
//
// Per pair it evaluates exactly the reference's compiled expression
//   d = |pi - pj|; d = min(d, area - d); fma(dx, dx, dy * dy) <= rng^2
// with the intrinsics written out. Later work: skip warps without
// senders (every warp now runs the sweep if any of its rows sends).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;

__device__ __forceinline__ float wrapped(float a, float b, float area) {
  float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(area, d));
}

template <int MAXL>
__global__ void __launch_bounds__(TILE) dense_lp_counts_kernel(
    const float2* __restrict__ pos,      // (n,)
    const int32_t* __restrict__ lp,      // (n,)
    const uint8_t* __restrict__ sender,  // (n,) 0/1
    int n, int n_lp, float area, float rng2,
    int32_t* __restrict__ out) {         // (n, n_lp)
  __shared__ float2 spos[TILE];
  __shared__ int32_t slp[TILE];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool active = i < n && sender[i];
  const float2 p = i < n ? pos[i] : make_float2(0.f, 0.f);
  int hist[MAXL];
#pragma unroll
  for (int t = 0; t < MAXL; ++t) hist[t] = 0;
  for (int base = 0; base < n; base += TILE) {
    const int j = base + threadIdx.x;
    if (j < n) {
      spos[threadIdx.x] = pos[j];
      slp[threadIdx.x] = lp[j];
    }
    __syncthreads();
    const int m = min(TILE, n - base);
    if (active) {
      for (int k = 0; k < m; ++k) {
        if (base + k == i) continue;
        const float2 q = spos[k];
        const float dx = wrapped(p.x, q.x, area);
        const float dy = wrapped(p.y, q.y, area);
        if (__fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= rng2) {
          const int l = slp[k];
#pragma unroll
          for (int t = 0; t < MAXL; ++t) hist[t] += (l == t);
        }
      }
    }
    __syncthreads();
  }
  if (i < n) {
#pragma unroll
    for (int t = 0; t < MAXL; ++t) {
      if (t < n_lp) out[(int64_t)i * n_lp + t] = hist[t];
    }
  }
}

template <int MAXL>
void launch(const void* pos, const void* lp, const void* sender, int n,
            int n_lp, float area, float rng2, void* out,
            cudaStream_t stream) {
  const int blocks = (n + TILE - 1) / TILE;
  dense_lp_counts_kernel<MAXL><<<blocks, TILE, 0, stream>>>(
      static_cast<const float2*>(pos), static_cast<const int32_t*>(lp),
      static_cast<const uint8_t*>(sender), n, n_lp, area, rng2,
      static_cast<int32_t*>(out));
}

}  // namespace

extern "C" int dense_lp_counts_launch(const void* pos, const void* lp,
                                      const void* sender, int n, int n_lp,
                                      float area, float rng2, void* out,
                                      void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lp <= 4) {
    launch<4>(pos, lp, sender, n, n_lp, area, rng2, out, s);
  } else if (n_lp <= 8) {
    launch<8>(pos, lp, sender, n, n_lp, area, rng2, out, s);
  } else if (n_lp <= 16) {
    launch<16>(pos, lp, sender, n, n_lp, area, rng2, out, s);
  } else if (n_lp <= 32) {
    launch<32>(pos, lp, sender, n, n_lp, area, rng2, out, s);
  } else if (n_lp <= 64) {
    launch<64>(pos, lp, sender, n, n_lp, area, rng2, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* proximity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
