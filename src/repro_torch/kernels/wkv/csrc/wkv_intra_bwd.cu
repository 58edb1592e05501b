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
// Replaces no Pallas kernel: the reference differentiates its jnp term
// (`src/repro/models/rwkv6.py:117-120`) by `jax.grad`, which saves the
// (B, H, c, c, N) float32 exponentials for every chunk.
//
// The algebra is the forward's: sub-chunks of 16 rows, and for a row
// sub-chunk T after a column sub-chunk I the exponent split at
// L_I = l[last row of I] into E_TI[t, n] = exp(l_prev[t, n] - L_I[n]) and
// f_I[i, n] = exp(L_I[n] - l[i, n]), both <= 0 in the exponent (l falls
// monotonically; see `wkv_intra.cu`), with k~_I = k o f_I:
//
//   dr_T += E_TI o (dA_TI . k~_I)
//   dk_I += f_I o (dA_TI^T . (r o E_TI)_T)
//
// Every sum runs over t or i, never over n. The 16 x 16 diagonal
// sub-blocks stay direct: e for i < t only, nothing on or above the
// diagonal evaluated. Each factor is evaluated once: 97,280 exponentials
// a chunk at c = 128 and N 64, as in the forward.
//
// Bound: the bytes. At rwkv6-1.6b's training microbatch (2 x 32 heads x
// 4,096 tokens, N 64, c 128) it reads 402 MB (r, k, l_prev, l, dA) and
// writes 268 MB: 0.200 ms at 3.35 TB/s, against 0.048 ms for the
// exponentials and 0.056 ms for the 1.9 G fused adds.
//
// The design: one block a (chunk, 32 n), four warps; a lane is one n, so
// every lane of a warp reads the same dA (a broadcast), and the two
// blocks of a chunk are neighbours, which read its dA while it is in the
// L2. Warp g owns the row sub-chunks g and 7 - g: g + 1 and 8 - g
// sub-blocks (the diagonal ones included), nine for every warp. It keeps
// r, l_prev and dr of the row sub-chunk in hand in registers and writes
// dr and dl_prev when it moves on. First each warp puts k, f_I and L_I
// of its column sub-chunks g and 7 - g into shared memory (the other
// warps read them), with the r and l_prev of its first row sub-chunk
// already on their way. Then nine steps, a barrier after each: at each
// step the four warps take four sub-blocks of four distinct column
// sub-chunks (the schedule in `task`), so each adds its sub-block's dk
// into the column's running sum in shared memory with no other writer,
// and the sums run in step order: no atomics, the same bits in every
// run. Each warp's 16 x 16 tiles of dA come into shared memory by
// cp.async three steps ahead, through a ring of four. At the end dk and
// dl = -k dk are written from the sums. k stays in shared memory for the
// diagonal and the end (k~ = k o f is formed where it is used). Shared
// memory: 63 KB a block, three blocks (12 warps) an SM.
//
// Where it stands: see PERF.md (H100 80GB HBM3, 700 W). Its loads and
// stores alone take ~0.2 ms of the ~0.40 at that microbatch
// (`tools/wkv_variants.py`, variant `no_compute`), and the products of
// the off-diagonal sub-blocks ~0.1 ms more that the 12 warps of an SM
// do not hide.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "wkv.cuh"

namespace {

using wkv::kMaxChunk;
using wkv::kMaxSub;
using wkv::kSub;

// n values a block (a warp's lanes), warps a block, steps a warp
constexpr int kLanes = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kLanes;
constexpr int kSteps = kMaxSub + 1;
constexpr int kBlocksPerSM = 3;
// each warp's dA tiles in flight: those of the next three steps
constexpr int kRing = 4;
// shared memory, in floats: f [I][i][lane], k [t][lane], L [I][lane],
// the dk sums [t][lane], and each warp's ring of dA tiles
constexpr int kFactors = (kMaxSub - 1) * kSub * kLanes;
constexpr int kTile = kSub * kSub;
constexpr int kSmemFloats = kFactors + (kMaxSub - 1) * kLanes +
                            2 * kMaxChunk * kLanes + kWarps * kRing * kTile;

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

// Warp g's sub-block (T, I) at step s: first its row sub-chunk g (the
// diagonal, then I = g - 1 down to 0), then 7 - g (I = 3, 2, 1, 0, then
// 4 up to 7 - g, the diagonal last). At every step the four warps' I
// differ (checked by enumeration; the diagonals fall on steps 0 and 8).
__device__ __forceinline__ void task(int g, int s, int& T, int& I) {
  if (s <= g) {
    T = g;
    I = g - s;
  } else {
    T = kMaxSub - 1 - g;
    const int x = s - g - 1;
    I = x < 4 ? 3 - x : x;
  }
}

// dA's sub-block (T, I) into `dst` (16 x 16, row-major), zeros past c;
// by cp.async where dA's rows are 16-byte aligned, else by plain loads.
__device__ __forceinline__ void stage_dA(float* dst, const float* dA, int c,
                                         int T, int I, bool vec, int lane) {
#pragma unroll
  for (int e = lane; e < kTile / 4; e += kLanes) {
    const int t = T * kSub + (e >> 2), i = I * kSub + 4 * (e & 3);
    if (vec) {
      // c % 4 == 0: a float4 lies wholly inside the chunk or outside it
      const bool ok = t < c && i < c;
      wkv::cp_async16(dst + 4 * e, dA + (ok ? int64_t(t) * c + i : 0), ok);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        dst[4 * e + w] = t < c && i + w < c ? dA[int64_t(t) * c + i + w] : 0.f;
    }
  }
}

__device__ __forceinline__ void load_row(float (&d)[kSub], const float* D) {
  const float4* D4 = reinterpret_cast<const float4*>(D);
#pragma unroll
  for (int b = 0; b < kSub / 4; ++b) {
    const float4 v = D4[b];
    d[4 * b] = v.x, d[4 * b + 1] = v.y, d[4 * b + 2] = v.z,
    d[4 * b + 3] = v.w;
  }
}

// dr and dl_prev = r dr of row sub-chunk T's rows inside the chunk
__device__ __forceinline__ void flush(const Args& p, int64_t in0, int T,
                                      bool writes, const float (&rT)[kSub],
                                      const float (&dr)[kSub]) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int t = T * kSub + j;
    if (writes && t < p.c) {
      const int64_t at = in0 + int64_t(t) * p.N;
      p.dr[at] = dr[j];
      p.dlp[at] = rT[j] * dr[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
wkv_intra_bwd_kernel(Args p) {
  extern __shared__ float smem[];
  float* const fs = smem;                           // [I][i][lane]
  float* const ks = fs + kFactors;                  // [t][lane]
  float* const Ls = ks + kMaxChunk * kLanes;        // [I][lane]
  float* const dks = Ls + (kMaxSub - 1) * kLanes;   // [t][lane]
  float* const tiles = dks + kMaxChunk * kLanes;    // [warp][ring][16][16]
  const int c = p.c, N = p.N;
  const int ns = N < kLanes ? N : kLanes;
  const int lane = threadIdx.x & (kLanes - 1), g = threadIdx.x / kLanes;
  // lanes past N (N 16) read column n0 and write nothing
  const bool writes = lane < ns;
  // the n slices of one chunk are neighbouring blocks, which read its dA
  // while it is in the L2
  const int halves = N / ns;
  const int chunk = blockIdx.x / halves, n0 = blockIdx.x % halves * ns;
  const int64_t in0 = int64_t(chunk) * c * N + n0 + (writes ? lane : 0);
  const float* dA = p.dA + int64_t(chunk) * c * c;
  const int nsub = (c + kSub - 1) / kSub;
  const bool vec = (c & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.dA) & 15) == 0;
  float* const mine = tiles + g * kRing * kTile;
  // step s's dA tile into ring slot s % kRing (an empty group when the
  // step has nothing to do)
  auto stage = [=](int s) {
    int T, I;
    task(g, s, T, I);
    if (s < kSteps && T < nsub)
      stage_dA(mine + s % kRing * kTile, dA, c, T, I, vec, lane);
    wkv::cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) stage(s);

  // r and l_prev of the first row sub-chunk g, in flight during the
  // factors below
  float rT[kSub], pT[kSub], dr[kSub];
  int cur = g < nsub ? g : -1;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int t = g * kSub + j;
    const int64_t at = in0 + int64_t(t < c ? t : 0) * N;
    rT[j] = t < c ? p.r[at] : 0.f;
    pT[j] = t < c ? p.lp[at] : 0.f;
    dr[j] = 0.f;
  }
  // k of the sub-chunks g and 7 - g (zeros past c), and their f and L
  // where a later row sub-chunk reads them (then all 16 rows are inside
  // the chunk)
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int I = o ? kMaxSub - 1 - g : g;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int t = I * kSub + i;
      ks[t * kLanes + lane] = t < c ? p.k[in0 + int64_t(t) * N] : 0.f;
    }
    if (I > nsub - 2) continue;
    const float L = p.l[in0 + int64_t(I * kSub + kSub - 1) * N];
    Ls[I * kLanes + lane] = L;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int64_t at = in0 + int64_t(I * kSub + i) * N;
      fs[(I * kSub + i) * kLanes + lane] = __expf(L - p.l[at]);
    }
  }
  for (int e = threadIdx.x; e < kMaxChunk * kLanes; e += kThreads)
    dks[e] = 0.f;
  __syncthreads();

  for (int s = 0; s < kSteps; ++s) {
    int T, I;
    task(g, s, T, I);
    // the tile of step s + 3 into the slot step s - 1 used; step s's
    // tile has landed once at most three groups are in flight
    stage(s + kRing - 1);
    wkv::cp_async_wait<kRing - 1>();
    __syncwarp();
    if (T < nsub) {
      if (T != cur) {
        if (cur >= 0) flush(p, in0, cur, writes, rT, dr);
        cur = T;
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int t = T * kSub + j;
          const int64_t at = in0 + int64_t(t < c ? t : 0) * N;
          rT[j] = t < c ? p.r[at] : 0.f;
          pT[j] = t < c ? p.lp[at] : 0.f;
          dr[j] = 0.f;
        }
      }
      const float* D = mine + s % kRing * kTile;
      float* dk = dks + I * kSub * kLanes + lane;
      if (T != I) {
        const float L = Ls[I * kLanes + lane];
        float kk[kSub], dkp[kSub];
        // k~ = k o f
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          kk[i] = ks[(I * kSub + i) * kLanes + lane] *
                  fs[(I * kSub + i) * kLanes + lane];
          dkp[i] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const float E = T * kSub + j < c ? __expf(pT[j] - L) : 0.f;
          const float u = rT[j] * E;
          float d[kSub];
          load_row(d, D + j * kSub);
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < kSub; ++i) a = fmaf(d[i], kk[i], a);
          dr[j] = fmaf(E, a, dr[j]);
#pragma unroll
          for (int i = 0; i < kSub; ++i) dkp[i] = fmaf(d[i], u, dkp[i]);
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          dk[i * kLanes] =
              fmaf(fs[(I * kSub + i) * kLanes + lane], dkp[i], dk[i * kLanes]);
      } else {
        // the diagonal sub-block: e[t, i] direct for i < t
        float kb[kSub], lb[kSub], dkd[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = T * kSub + i;
          kb[i] = ks[t * kLanes + lane];
          lb[i] = t < c ? p.l[in0 + int64_t(t) * N] : 0.f;
          dkd[i] = 0.f;
        }
#pragma unroll
        for (int j = 1; j < kSub; ++j) {
          if (T * kSub + j >= c) break;
          float d[kSub];
          load_row(d, D + j * kSub);
#pragma unroll
          for (int i = 0; i < j; ++i) {
            const float m = d[i] * __expf(pT[j] - lb[i]);
            dr[j] = fmaf(m, kb[i], dr[j]);
            dkd[i] = fmaf(m, rT[j], dkd[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) dk[i * kLanes] += dkd[i];
      }
    }
    __syncthreads();
  }
  if (cur >= 0) flush(p, in0, cur, writes, rT, dr);

  // every row's loads in flight at once
#pragma unroll
  for (int q = 0; q < kMaxChunk / kWarps; ++q) {
    const int t = g + q * kWarps;
    if (writes && t < c) {
      const int64_t at = in0 + int64_t(t) * N;
      const float v = dks[t * kLanes + lane];
      p.dk[at] = v;
      p.dl[at] = -ks[t * kLanes + lane] * v;
    }
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
  if (c < 1 || c > kMaxChunk || !(N == 16 || N % kLanes == 0) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 0) return 0;
  const size_t bytes = kSmemFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{static_cast<const float*>(r),  static_cast<const float*>(k),
         static_cast<const float*>(l_prev), static_cast<const float*>(l),
         static_cast<const float*>(dA), c, N,
         static_cast<float*>(dr), static_cast<float*>(dk),
         static_cast<float*>(dl_prev), static_cast<float*>(dl)};
  const int ns = N < kLanes ? N : kLanes;
  wkv_intra_bwd_kernel<<<chunks * (N / ns), kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv_intra_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
