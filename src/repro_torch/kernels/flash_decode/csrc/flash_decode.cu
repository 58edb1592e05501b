// Flash-decode for Hopper (sm_90a): one query token per sequence against
// a (B, S, Hkv, D) KV cache, GQA kept grouped, split-K over S and a
// combine pass.
//
// Replaces the Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_decode/flash_decode.py:60, pallas_call at
// :76), whose grid (B * Hkv, kv block) carries a (G, D) query group per
// KV head through a sequential sweep of the cache, masks kpos > pos and
// skips blocks past pos.
//
// Bound: bytes. The cache rows up to pos are read once for all G query
// heads of their KV head: at B 16, Hkv 4, D 64, pos ~544 in bf16 that is
// ~8.9 MB, ~2.7 us at 3.35 TB/s. The arithmetic (2 * G * D per key) is
// far below the card's rate.
//
// Design: a TPU core sweeps the cache in order; 64 (b, kv head) pairs
// would leave most of 132 SMs idle, so the sweep is cut along S.
// Kernel 1, grid (B * Hkv, ceil(S / 64)): each block of 4 warps takes
// 64 cache rows, each warp every 4th row. A lane holds D / 32 columns of
// the G query rows; for each key the warp reduces G dot products by
// shuffles and updates G online-softmax states (m, l, acc) in f32, so
// every K/V row is read once for the whole group. P is rounded to V's
// type before P.V, as the Pallas kernel does. Rows past pos are never
// read; a block wholly past pos writes an empty partial. The 4 warps
// merge in shared memory and write (m, l, acc) to f32 scratch. Kernel 2,
// grid B * Hkv, merges the splits up to pos per (b, head) and divides by
// max(l, 1e-30). S need not be a multiple of anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;  // cache rows per block
constexpr int WARPS = 4;
constexpr int MAX_G = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// DPL = columns a lane holds (D <= 32 * DPL)
template <typename T, int D, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, int S, int Hkv, int G,
                      int pos, float scale, float* __restrict__ part_m,
                      float* __restrict__ part_l,
                      float* __restrict__ part_acc) {
  __shared__ float sm_m[WARPS][MAX_G];
  __shared__ float sm_l[WARPS][MAX_G];
  __shared__ float sm_acc[WARPS][MAX_G][D];

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t pbase = static_cast<int64_t>(bk) * n_split + split;
  const int start = split * CHUNK;
  if (start > pos) {  // wholly past pos: an empty partial
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      part_acc[pbase * G * D + i] = 0.f;
    }
    if (threadIdx.x < G) {
      part_m[pbase * G + threadIdx.x] = NEG_INF;
      part_l[pbase * G + threadIdx.x] = 0.f;
    }
    return;
  }

  float qr[MAX_G][DPL];
  float acc[MAX_G][DPL];
  float m[MAX_G], l[MAX_G];
  const T* qg = q + (static_cast<int64_t>(b) * Hkv + hk) * G * D;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < D) ? to_f(qg[g * D + d]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const int end = min(min(start + CHUNK, S), pos + 1);
  for (int j = start + warp; j < end; j += WARPS) {
    const int64_t row = ((static_cast<int64_t>(b) * S + j) * Hkv + hk) * D;
    float kd[DPL], vd[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kd[i] = d < D ? to_f(kc[row + d]) : 0.f;
      vd[i] = d < D ? to_f(vc[row + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot = fmaf(qr[g][i], kd[i], dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float s = dot * scale;
        const float m_new = fmaxf(m[g], s);
        const float p = expf(s - m_new);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + p;
        m[g] = m_new;
        const float pv = to_f(from_f<T>(p));
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pv, vd[i], acc[g][i] * corr);
      }
    }
  }

  // merge the warps of this block
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) sm_acc[warp][g][d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    part_acc[pbase * G * D + i] = A;
    if (d == 0) {
      part_m[pbase * G + g] = M;
      part_l[pbase * G + g] = L;
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      int n_split, int n_used, int G, int D,
                                      T* __restrict__ out) {
  const int bk = blockIdx.x;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int64_t base = static_cast<int64_t>(bk) * n_split;
    float M = NEG_INF;
    for (int s = 0; s < n_used; ++s) M = fmaxf(M, part_m[(base + s) * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float c = expf(part_m[(base + s) * G + g] - M);
      L += part_l[(base + s) * G + g] * c;
      A += part_acc[(base + s) * G * D + i] * c;
    }
    // out (B, Hq, D) with query head hk * G + g: row bk * G + g
    out[static_cast<int64_t>(bk) * G * D + i] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, int B, int S,
             int Hkv, int G, int pos, float scale, void* part_m,
             void* part_l, void* part_acc, void* out, cudaStream_t s) {
  constexpr int DPL = (D + 31) / 32;
  const int n_split = (S + CHUNK - 1) / CHUNK;
  const int n_used = pos / CHUNK + 1;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  decode_partial_kernel<T, D, DPL><<<dim3(B * Hkv, n_split), WARPS * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), S, Hkv, G, pos, scale, pm, pl, pa);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = min(1024, ((G * D + 31) / 32) * 32);
  decode_combine_kernel<T><<<B * Hkv, threads, 0, s>>>(
      pm, pl, pa, n_split, min(n_used, n_split), G, D, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, int B, int S,
           int Hkv, int G, int D, int pos, float scale, void* pm, void* pl,
           void* pa, void* out, cudaStream_t s) {
#define FD_CASE(DD) \
  case DD: return launch_d<T, DD>(q, kc, vc, B, S, Hkv, G, pos, scale, pm, pl, pa, out, s)
  switch (D) {
    FD_CASE(16);
    FD_CASE(32);
    FD_CASE(64);
    FD_CASE(128);
#undef FD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, Hkv * G, D); kc, vc: (B, S, Hkv, D); contiguous, one dtype
// (0 = float32, 1 = bfloat16); 0 <= pos < S; G <= 8; D in {16, 32, 64,
// 128}; scores are scaled by `scale` (the caller's float32 D^-0.5).
// Scratch: part_m, part_l (B * Hkv, ceil(S / 64), G) and part_acc
// (B * Hkv, ceil(S / 64), G, D), float32.
extern "C" int flash_decode_launch(const void* q, const void* kc,
                                   const void* vc, int B, int S, int Hkv,
                                   int G, int D, int pos, int dtype,
                                   float scale, void* part_m, void* part_l,
                                   void* part_acc, void* out, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > MAX_G || pos < 0 || pos >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kc, vc, B, S, Hkv, G, D, pos, scale, part_m,
                         part_l, part_acc, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, B, S, Hkv, G, D, pos, scale,
                                 part_m, part_l, part_acc, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
