// The backward of the chunked WKV's intra-chunk term (`wkv_intra.cu`),
// written by hand for Hopper (sm_90a). For the gradient dA of
//
//   A[t, i] = sum_n r[t, n] k[i, n] e[t, i, n],  e = exp(l_prev[t, n] - l[i, n]),
//
// over i < t inside each chunk, it writes
//
//   dr[t, n] = sum_{i<t} dA[t, i] k[i, n] e[t, i, n]
//   dk[i, n] = sum_{t>i} dA[t, i] r[t, n] e[t, i, n]
//   dl_prev  = r . dr            dl = -k . dk
//
// so one recompute of e over the lower triangle gives all four.
//
// Replaces no Pallas kernel: the reference differentiates its jnp term
// (`src/repro/models/rwkv6.py:117-120`) by `jax.grad`, which saves the
// (B, H, c, c, N) float32 exponentials for every chunk. Autograd in torch
// does the same, and takes 0 x inf = NaN from the masked upper triangle
// once a chunk's decay passes float32's range; here the exponent of a
// pair on or above the diagonal is -inf (its exponential is 0) and no
// positive exponent is formed.
//
// The design: one block a (chunk, slice of 32 n values) (16 at N 16),
// 128 threads. A thread keeps one n and walks a set of i-blocks (8 rows
// of i): it holds their k and l in registers, runs t from the block's
// first row down the chunk, and for each t recomputes the 8 exponentials,
// adds dA[t, i] r[t, n] e into its 8 dk sums (registers: each i-block
// belongs to one thread group, so dk needs no reduction) and the row's
// dA k e into dr[t, n]. The groups (G = 128 / slice) take the i-blocks in
// a snake order, which gives each the same number of (t, i-block) steps;
// each group adds its dr into its own copy in shared memory, and the
// copies are summed in group order at the end, so the result is the same
// in every run (no atomics). r and l_prev are staged in shared memory
// (the groups share them); dA is read from the L2 by all lanes alike (a
// broadcast), as float4 where it is 16-byte aligned. Shared memory: 2 c
// slice + G c slice floats (96 KB at c 128, N 64).
//
// Bound: the exponentials, as the forward's (1.07 G a layer at
// rwkv6-1.6b's training microbatch), with two fused adds a pair beside
// each.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 128;
constexpr int kThreads = 128;
// rows of i a thread holds at once
constexpr int kIB = 8;
// n values a block at most (a warp's lanes)
constexpr int kMaxSlice = 32;

struct Args {
  const float* r;
  const float* k;
  const float* lp;
  const float* l;
  const float* dA;
  int c, N;
  float* dr;
  float* dk;
  float* dlp;
  float* dl;
};

// One row t against the thread's i-block [i0, i0 + kIB): the
// exponentials, dk's sums and row t's share of dr. `kMasked` rows lie in
// the diagonal block, where i >= t takes -inf.
template <bool kMasked>
__device__ __forceinline__ void row_step(const float* __restrict__ dA_row,
                                         bool vec, int i0, int t, float rt,
                                         float pt, const float (&kk)[kIB],
                                         const float (&ll)[kIB],
                                         float (&dk)[kIB], float* dr_slot) {
  float da[kIB];
  if (!kMasked && vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(dA_row));
    const float4 b = __ldg(reinterpret_cast<const float4*>(dA_row) + 1);
    da[0] = a.x, da[1] = a.y, da[2] = a.z, da[3] = a.w;
    da[4] = b.x, da[5] = b.y, da[6] = b.z, da[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kIB; ++j)
      da[j] = (!kMasked || i0 + j < t) ? __ldg(dA_row + j) : 0.f;
  }
  float drp = 0.f;
#pragma unroll
  for (int j = 0; j < kIB; ++j) {
    const float x = (!kMasked || i0 + j < t) ? pt - ll[j] : -INFINITY;
    const float m = da[j] * __expf(x);
    dk[j] = fmaf(m, rt, dk[j]);
    drp = fmaf(m, kk[j], drp);
  }
  *dr_slot += drp;
}

__global__ void __launch_bounds__(kThreads)
wkv_intra_bwd_kernel(Args p) {
  extern __shared__ float smem[];
  const int c = p.c, N = p.N;
  const int ns = N < kMaxSlice ? N : kMaxSlice;
  const int groups = kThreads / ns;
  float* rs = smem;             // [c][ns]
  float* ps = rs + c * ns;      // [c][ns]
  float* drs = ps + c * ns;     // [groups][c][ns]
  const int n0 = blockIdx.y * ns;
  const int64_t in0 = int64_t(blockIdx.x) * c * N;
  const float* dA = p.dA + int64_t(blockIdx.x) * c * c;
  const int tid = threadIdx.x, n = tid % ns, g = tid / ns;

  for (int e = tid; e < c * ns; e += kThreads) {
    const int t = e / ns, m = e - t * ns;
    const int64_t at = in0 + int64_t(t) * N + n0 + m;
    rs[e] = p.r[at];
    ps[e] = p.lp[at];
  }
  for (int e = tid; e < groups * c * ns; e += kThreads) drs[e] = 0.f;
  __syncthreads();

  const bool vec = (c & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.dA) & 15) == 0;
  float* drg = drs + g * c * ns;
  const int nib = (c + kIB - 1) / kIB;
  for (int round = 0; round * groups < nib; ++round) {
    const int ib = round * groups + ((round & 1) ? groups - 1 - g : g);
    if (ib >= nib) continue;
    const int i0 = ib * kIB;
    float kk[kIB], ll[kIB], dk[kIB];
#pragma unroll
    for (int j = 0; j < kIB; ++j) {
      const int i = i0 + j;
      const int64_t at = in0 + int64_t(i) * N + n0 + n;
      kk[j] = i < c ? p.k[at] : 0.f;
      ll[j] = i < c ? p.l[at] : 0.f;
      dk[j] = 0.f;
    }
    const int diag_end = i0 + kIB < c ? i0 + kIB : c;
    for (int t = i0 + 1; t < diag_end; ++t)
      row_step<true>(dA + int64_t(t) * c + i0, vec, i0, t, rs[t * ns + n],
                     ps[t * ns + n], kk, ll, dk, drg + t * ns + n);
    for (int t = diag_end; t < c; ++t)
      row_step<false>(dA + int64_t(t) * c + i0, vec, i0, t, rs[t * ns + n],
                      ps[t * ns + n], kk, ll, dk, drg + t * ns + n);
#pragma unroll
    for (int j = 0; j < kIB; ++j) {
      const int i = i0 + j;
      if (i < c) {
        const int64_t at = in0 + int64_t(i) * N + n0 + n;
        p.dk[at] = dk[j];
        p.dl[at] = -kk[j] * dk[j];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < c * ns; e += kThreads) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += drs[gg * c * ns + e];
    const int t = e / ns, m = e - t * ns;
    const int64_t at = in0 + int64_t(t) * N + n0 + m;
    p.dr[at] = s;
    p.dlp[at] = rs[e] * s;
  }
}

}  // namespace

// r, k, l_prev, l, dr, dk, dl_prev, dl: (B, H, S, N) float32; dA: (B, H,
// S/c, c, c) float32; all contiguous. `chunks` is B H S / c; N 16, 32 or
// a multiple of 32; 1 <= c <= 128.
extern "C" int wkv_intra_bwd_launch(const void* r, const void* k,
                                    const void* l_prev, const void* l,
                                    const void* dA, int chunks, int c, int N,
                                    void* dr, void* dk, void* dl_prev,
                                    void* dl, void* stream) {
  if (c < 1 || c > kMaxChunk || !(N == 16 || N % kMaxSlice == 0) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 0) return 0;
  const int ns = N < kMaxSlice ? N : kMaxSlice;
  const int groups = kThreads / ns;
  const size_t bytes = size_t(2 + groups) * c * ns * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{static_cast<const float*>(r),  static_cast<const float*>(k),
         static_cast<const float*>(l_prev), static_cast<const float*>(l),
         static_cast<const float*>(dA), c, N,
         static_cast<float*>(dr), static_cast<float*>(dk),
         static_cast<float*>(dl_prev), static_cast<float*>(dl)};
  dim3 grid(chunks, N / ns);
  wkv_intra_bwd_kernel<<<grid, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv_intra_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
