// The partitioners' greedy capacity-constrained assignment, written by
// hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the `lax.scan` of
// `src/repro/core/partition.py::capacity_assign`, which walks the
// N * L (SE, LP) pairs in ascending cost and gives an unplaced SE the
// first LP whose filled weight plus the SE's stays within the LP's
// capacity. kmeans runs it 9 times a partition and bestresponse 8, on
// 40,000 pairs at 10k SEs and 4 LPs, which a host loop scans in tens of
// milliseconds a call.
//
// The scan is sequential by definition (each admission changes the
// fills the next pair reads), so the kernel is one block in which one
// thread makes every decision, and the design keeps that thread fed:
//   * the wrapper sorts the flat costs on the device (stable, so ties
//     go to the lower flat index i * L + l, as the reference's
//     argsort) and hands the kernel the order;
//   * the whole block stages the next CHUNK entries of the order in
//     shared memory with coalesced loads, then thread 0 scans them;
//   * what thread 0 reads per pair lives in shared memory when it fits
//     (up to kSmemRows SEs): each SE's LP as one byte and its weight,
//     loaded by the whole block first, and the L fills; past that the
//     LPs and weights stay in global memory (`out`, `weights`);
//   * the scan stops as soon as every SE is placed (the reference scans
//     on, deciding nothing);
//   * an SE no LP could fit (only with uneven weights and tight caps)
//     takes the LP with the most capacity left, the first one on ties
//     (jnp.argmax), filled in by the whole block.
// float32 sums round as the reference's (`__fadd_rn`, `__fsub_rn`).
// Without the shared copies each pair waited on L2 round trips for the
// SE's LP and weight (1.3x slower on an H100 at 10k SEs x 4 LPs).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;
constexpr int kMaxLp = 64;
// SEs whose LP byte and weight fit the dynamic shared memory
constexpr int kSmemRows = 40 * 1024;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
capacity_assign_kernel(const int64_t* __restrict__ order,
                       const float* __restrict__ weights,
                       const float* __restrict__ caps, int n, int n_lp,
                       int32_t* __restrict__ out) {
  __shared__ int64_t chunk[kChunk];
  __shared__ float fill[kMaxLp];
  __shared__ float cap[kMaxLp];
  __shared__ int left, fallback;
  extern __shared__ float smem[];  // kSmem: n weights, then n LP bytes
  float* w_s = smem;
  int8_t* lp_s = reinterpret_cast<int8_t*>(smem + n);
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) {
    if (kSmem) {
      w_s[i] = weights[i];
      lp_s[i] = -1;
    } else {
      out[i] = -1;
    }
  }
  if (tid < n_lp) {
    fill[tid] = 0.f;
    cap[tid] = caps[tid];
  }
  if (tid == 0) left = n;
  __syncthreads();
  const int64_t total = int64_t(n) * n_lp;
  for (int64_t base = 0; base < total && left > 0; base += kChunk) {
    const int m = int(min(int64_t(kChunk), total - base));
    for (int k = tid; k < m; k += kThreads) chunk[k] = order[base + k];
    __syncthreads();
    if (tid == 0) {
      int remaining = left;
      for (int k = 0; k < m && remaining > 0; ++k) {
        const int64_t flat = chunk[k];
        const int i = int(flat / n_lp);
        if ((kSmem ? int(lp_s[i]) : out[i]) >= 0) continue;
        const int l = int(flat - int64_t(i) * n_lp);
        const float s = __fadd_rn(fill[l], kSmem ? w_s[i] : weights[i]);
        if (s <= cap[l]) {
          if (kSmem) {
            lp_s[i] = int8_t(l);
          } else {
            out[i] = l;
          }
          fill[l] = s;
          --remaining;
        }
      }
      left = remaining;
    }
    __syncthreads();
  }
  if (left > 0 && tid == 0) {
    int best = 0;
    float most = __fsub_rn(cap[0], fill[0]);
    for (int l = 1; l < n_lp; ++l) {
      const float spare = __fsub_rn(cap[l], fill[l]);
      if (spare > most) {
        most = spare;
        best = l;
      }
    }
    fallback = best;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int l = kSmem ? int(lp_s[i]) : out[i];
    out[i] = l >= 0 ? l : fallback;
  }
}

}  // namespace

extern "C" int capacity_assign_launch(const void* order, const void* weights,
                                      const void* caps, int n, int n_lp,
                                      void* out, void* stream) {
  if (n <= 0) return 0;
  if (n_lp < 1 || n_lp > kMaxLp)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto o = static_cast<const int64_t*>(order);
  const auto w = static_cast<const float*>(weights);
  const auto c = static_cast<const float*>(caps);
  const auto r = static_cast<int32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmemRows) {
    const int bytes = n * 5;  // n float weights, n LP bytes
    cudaError_t err = cudaFuncSetAttribute(
        capacity_assign_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 5 * kSmemRows);
    if (err != cudaSuccess) return static_cast<int>(err);
    capacity_assign_kernel<true><<<1, kThreads, bytes, s>>>(o, w, c, n, n_lp,
                                                            r);
  } else {
    capacity_assign_kernel<false><<<1, kThreads, 0, s>>>(o, w, c, n, n_lp, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* capacity_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
