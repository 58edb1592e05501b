// The intra-chunk term of RWKV6's chunked WKV, written by hand for
// Hopper (sm_90a): for every chunk of every (batch, head) at once,
//
//   A[t, i] = sum_n r[t, n] k[i, n] exp(l_prev[t, n] - l[i, n]),  i < t,
//   A[t, i] = 0,                                                  i >= t,
//
// with t and i the rows of one chunk of c tokens and l the cumulative
// log-decay inside the chunk (l_prev = l - log w, the sum before token t).
//
// Replaces no Pallas kernel: the reference builds this term with jnp ops
// inside its `lax.scan` (`src/repro/models/rwkv6.py:117-120`, the
// (B, H, c, c, N) float32 tensor `where(tri, exp(expo), 0) * r * k`
// summed over N). This kernel writes A (B, H, S/c, c, c) and nothing
// else.
//
// The algebra. The chunk is cut into sub-chunks of 16 rows (the last may
// be short). For a row sub-chunk T after a column sub-chunk I, take the
// reference L_I[n] = l[last row of I, n] and split the exponent there:
//
//   exp(l_prev[t] - l[i]) = exp(l_prev[t] - L_I) * exp(L_I - l[i]),
//   A_TI = (r o exp(l_prev - L_I))_T . (k o exp(L_I - l))_I^T,
//
// a plain float32 product over n with no exponential inside. Every
// exponent evaluated is <= 0: the log-decay log w = -exp(.) is <= 0, so
// l falls monotonically (a float sum of terms <= 0 cannot rise), which
// makes L_I - l[i] <= 0 for i in I, and l_prev[t] = l[t-1] (up to one
// rounding of l - log w) <= L_I for t after I. Neither factor can
// overflow, and one underflows only where the true product is smaller
// still. The reference is never the chunk's start and no exponent is
// clamped: l falls to about -385 in a chunk of 128 with steep decays,
// and exp(-l) overflows float32 past 88. The 16 x 16 diagonal
// sub-blocks keep the direct exponent l_prev[t] - l[i] for i < t (<= 0),
// and nothing on or above the diagonal is evaluated. At c = 128 that is
// 97,280 exponentials a chunk at N 64 (61,440 on the diagonal, 7,168
// for the column factors, 28,672 for the row factors) instead of
// 540,672, and 0.94 G fused adds a layer at rwkv6-1.6b's training
// microbatch (2 x 32 heads x 4,096 tokens).
//
// Bound: the bytes. That microbatch reads 268 MB (r, k, l_prev, l) and
// writes 134 MB of A: 0.120 ms at 3.35 TB/s, against 0.048 ms for the
// exponentials on the SFUs and 0.028 ms for the fused adds.
//
// The design: one block a chunk, 352 threads, two blocks an SM (103 KB
// of shared memory each). Each warp takes one of two roles, on a code
// path of its own, so each role holds only its own registers. 224
// threads take the off-diagonal sub-blocks: a thread owns two adjacent
// rows of T against the 16 columns of one I (32 sums in registers) and
// forms its own row factors (two exponentials an n); the threads are
// grouped by I, so the column factors k~_I they read are broadcasts.
// They also write each slice's k~_I (7 x 16 x 16 values, one
// exponential each) and meet at a barrier of their own before reading
// them. 128 threads take the diagonal: a thread owns the rows p and
// 15 - p of one sub-chunk for half of the n values, p + (15 - p) = 15
// pairs below the diagonal walked as 15 slots (no lane idle), and the
// two halves are added by a shuffle. The chunk's r, l_prev, k and l come
// in 16 n at a time (32 KB) by cp.async through a ring of three stages:
// two slices in flight while one is used. A staged row's four float4s
// and its neighbour's fill one 128-byte line whose eight slots are
// permuted by the line index, so the threads' reads of their rows are
// free of bank conflicts. At the end the sums go through shared memory
// (64 KB over the stages, slots permuted the same way) and the block
// writes A row by row with coalesced 16-byte stores, zeros on and above
// the diagonal included.
//
// Where it stands: see PERF.md (H100 80GB HBM3, 700 W). The loads and
// stores alone take ~0.15 ms of the ~0.24 at that microbatch
// (`tools/wkv_variants.py`, variant `no_compute`); the off-diagonal
// threads, at 80 registers (two blocks an SM), still spill a little.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "wkv.cuh"

namespace {

using wkv::kMaxChunk;
using wkv::kMaxSub;
using wkv::kSub;

// n values a stage holds, and its float4s a row
constexpr int kSlice = 16;
constexpr int kQ = kSlice / 4;
// threads: a row pair against a column sub-chunk below the diagonal
// (8 pairs x 28 sub-blocks), and a row pair of a diagonal sub-block and
// half of the n values (8 x 8 x 2)
constexpr int kOff = 8 * kMaxSub * (kMaxSub - 1) / 2;
constexpr int kDiag = kMaxSub * 8 * 2;
constexpr int kThreads = kOff + kDiag;
// the staged arrays r, l_prev, k, l, each kMaxChunk rows of kQ float4s
constexpr int kArrays = 4;
constexpr int kArrayF4 = kMaxChunk * kQ;
constexpr int kStageF4 = kArrays * kArrayF4;
// a ring of three stages: two slices in flight while one is used
constexpr int kStages = 3;
// k~_I [I][n][i] of one slice
constexpr int kFactors = (kMaxSub - 1) * kSlice * kSub;
constexpr size_t kSmemBytes =
    kStages * kStageF4 * sizeof(float4) + kFactors * sizeof(float);
// the A tile of the epilogue (c x c floats, rows of 32 float4 slots)
// lies over the stages
static_assert(kMaxChunk * kMaxChunk / 4 <= kStages * kStageF4, "tile");

// The float4 slot of (row t, float4 q) in a staged array: rows t and
// t ^ 1 share a 128-byte line of eight slots, permuted by the line.
__device__ __forceinline__ int slot(int t, int q) {
  const int line = t >> 1;
  return line * 8 + ((((t & 1) << 2) | q) ^ (line & 7));
}

// The float4 slot of A's (row t, float4 column col4) in the tile.
__device__ __forceinline__ int tile_slot(int t, int col4) {
  return t * (kMaxChunk / 4) + (col4 ^ ((t >> 1) & 7));
}

// acc + sum over four n of r k exp(l_prev - l), in n order
__device__ __forceinline__ float term4(float4 r, float4 p, float4 k,
                                       float4 l, float acc) {
  acc = fmaf(r.x * k.x, __expf(p.x - l.x), acc);
  acc = fmaf(r.y * k.y, __expf(p.y - l.y), acc);
  acc = fmaf(r.z * k.z, __expf(p.z - l.z), acc);
  return fmaf(r.w * k.w, __expf(p.w - l.w), acc);
}

// A barrier of the whole block, for the roles' own code paths (each warp
// takes one role, so every warp arrives at one of them)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// A barrier of the off-diagonal threads alone (warps 0..6)
__device__ __forceinline__ void off_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kOff) : "memory");
}

// k~_I[n][i] = k[16 I + i, n] exp(L_I[n] - l[16 I + i, n]) of a staged
// slice, for each column sub-chunk that a later row sub-chunk reads, by
// the off-diagonal threads
__device__ __forceinline__ void column_factors(const float4* K,
                                               const float4* L, float* kt,
                                               int nsub) {
  const float* Lf = reinterpret_cast<const float*>(L);
  const float* Kf = reinterpret_cast<const float*>(K);
  for (int e = threadIdx.x; e < (nsub - 1) * kSlice * kSub; e += kOff) {
    const int ie = e / (kSlice * kSub), n = (e / kSub) % kSlice;
    const int t = ie * kSub + e % kSub, q = n >> 2, w = n & 3;
    const float ref = Lf[slot(ie * kSub + kSub - 1, q) * 4 + w];
    kt[e] = Kf[slot(t, q) * 4 + w] * __expf(ref - Lf[slot(t, q) * 4 + w]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
wkv_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ lp, const float* __restrict__ l,
                 int c, int N, float* __restrict__ A) {
  extern __shared__ float4 smem[];
  float* const kt = reinterpret_cast<float*>(smem + kStages * kStageF4);
  float4* const tile = smem;
  float* const tilef = reinterpret_cast<float*>(smem);
  const int64_t in0 = int64_t(blockIdx.x) * c * N;
  const int tid = threadIdx.x;
  const int nsub = (c + kSub - 1) / kSub;
  const int slices = N / kSlice;

  // slice s of the four arrays into stage s % 3 (an empty group past
  // the last); rows past c are zeros
  auto load = [=](int s) {
    if (s < slices) {
      float4* dst = smem + (s % kStages) * kStageF4;
      for (int e = tid; e < kStageF4; e += kThreads) {
        const int arr = e / kArrayF4, t = (e / kQ) % kMaxChunk, q = e % kQ;
        const float* src = arr == 0 ? r : arr == 1 ? lp : arr == 2 ? k : l;
        const bool valid = t < c;
        const int64_t at =
            in0 + (valid ? int64_t(t) * N + s * kSlice + 4 * q : 0);
        wkv::cp_async16(dst + arr * kArrayF4 + slot(t, q), src + at, valid);
      }
    }
    wkv::cp_async_commit();
  };
  // the slice loop's head, the same on both roles' paths: slice s has
  // landed (s + 1 may be in flight); every thread is past slice s - 1,
  // whose stage takes slice s + 2
  auto next_slice = [&](int s) {
    wkv::cp_async_wait<1>();
    block_sync();
    load(s + 2);
    return smem + (s % kStages) * kStageF4;
  };

  load(0);
  load(1);
  if (tid < kOff) {
    // an off-diagonal thread, grouped by I: rows 16 T + 2 m, + 1 against
    // the columns of sub-chunk I < T
    int I = 0, rem = tid;
    while (rem >= 8 * (kMaxSub - 1 - I)) {
      rem -= 8 * (kMaxSub - 1 - I);
      ++I;
    }
    const int T = I + 1 + (rem >> 3), m = rem & 7;
    const bool live = T < nsub;
    const int t0 = T * kSub + 2 * m, last_i = I * kSub + kSub - 1;
    float acc0[kSub], acc1[kSub];
#pragma unroll
    for (int b = 0; b < kSub; ++b) acc0[b] = acc1[b] = 0.f;
    for (int s = 0; s < slices; ++s) {
      const float4* R = next_slice(s);
      const float4* P = R + kArrayF4;
      const float4* L = P + 2 * kArrayF4;
      const float* Lf = reinterpret_cast<const float*>(L);
      // the column factors, by the off-diagonal threads alone (the
      // diagonal threads read none, and go on meanwhile)
      column_factors(P + kArrayF4, L, kt, nsub);
      off_sync();
      if (!live) continue;
      const float4* ktI = reinterpret_cast<const float4*>(kt) +
                          I * kSlice * (kSub / 4);
#pragma unroll 1
      for (int q = 0; q < kQ; ++q) {
        // r, l_prev and L read an n at a time: fewer registers held
        // beside the 32 sums
        const float* Rf = reinterpret_cast<const float*>(R);
        const float* Pf = reinterpret_cast<const float*>(P);
        const int sa = slot(t0, q) * 4, sb = slot(t0 + 1, q) * 4;
        const int sl = slot(last_i, q) * 4;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float lr = Lf[sl + w];
          const float ea = Rf[sa + w] * __expf(Pf[sa + w] - lr);
          const float eb = Rf[sb + w] * __expf(Pf[sb + w] - lr);
          const float4* kn = ktI + (4 * q + w) * (kSub / 4);
#pragma unroll
          for (int b = 0; b < kSub / 4; ++b) {
            const float4 kv = kn[b];
            acc0[4 * b + 0] = fmaf(ea, kv.x, acc0[4 * b + 0]);
            acc0[4 * b + 1] = fmaf(ea, kv.y, acc0[4 * b + 1]);
            acc0[4 * b + 2] = fmaf(ea, kv.z, acc0[4 * b + 2]);
            acc0[4 * b + 3] = fmaf(ea, kv.w, acc0[4 * b + 3]);
            acc1[4 * b + 0] = fmaf(eb, kv.x, acc1[4 * b + 0]);
            acc1[4 * b + 1] = fmaf(eb, kv.y, acc1[4 * b + 1]);
            acc1[4 * b + 2] = fmaf(eb, kv.z, acc1[4 * b + 2]);
            acc1[4 * b + 3] = fmaf(eb, kv.w, acc1[4 * b + 3]);
          }
        }
      }
    }
    // every thread past its last read of the stages: the sums into the
    // tile over them
    block_sync();
    if (live) {
#pragma unroll
      for (int b = 0; b < kSub / 4; ++b) {
        tile[tile_slot(t0, 4 * I + b)] =
            make_float4(acc0[4 * b], acc0[4 * b + 1], acc0[4 * b + 2],
                        acc0[4 * b + 3]);
        tile[tile_slot(t0 + 1, 4 * I + b)] =
            make_float4(acc1[4 * b], acc1[4 * b + 1], acc1[4 * b + 2],
                        acc1[4 * b + 3]);
      }
    }
  } else {
    // a diagonal thread: sub-chunk j, rows p and 15 - p, n half h; its
    // pair jj is row rp's column jj for jj < p, then row rq's column
    // jj - p (15 pairs, no lane idle)
    const int d = tid - kOff;
    const int j = d >> 4, h = (d >> 3) & 1, p = d & 7;
    const bool live = j < nsub;
    const int rp = j * kSub + p, rq = j * kSub + kSub - 1 - p;
    float acc[kSub - 1];
#pragma unroll
    for (int jj = 0; jj < kSub - 1; ++jj) acc[jj] = 0.f;
    for (int s = 0; s < slices; ++s) {
      const float4* R = next_slice(s);
      const float4* P = R + kArrayF4;
      const float4* K = P + kArrayF4;
      const float4* L = K + kArrayF4;
      if (!live) continue;
#pragma unroll 1
      for (int qq = 0; qq < 2; ++qq) {
        const int q = 2 * h + qq;
        const float4 rP = R[slot(rp, q)], pP = P[slot(rp, q)];
        const float4 rQ = R[slot(rq, q)], pQ = P[slot(rq, q)];
#pragma unroll
        for (int jj = 0; jj < kSub - 1; ++jj) {
          const bool onP = jj < p;
          const int i = j * kSub + (onP ? jj : jj - p);
          const float4 kv = K[slot(i, q)], lv = L[slot(i, q)];
          acc[jj] = term4(onP ? rP : rQ, onP ? pP : pQ, kv, lv, acc[jj]);
        }
      }
    }
    block_sync();
    // both n halves hold each sum: add them (the same bits on both lanes)
#pragma unroll
    for (int jj = 0; jj < kSub - 1; ++jj)
      acc[jj] += __shfl_xor_sync(0xffffffffu, acc[jj], 8);
    if (live && h == 0) {
#pragma unroll
      for (int jj = 0; jj < kSub - 1; ++jj) {
        const int t = jj < p ? rp : rq;
        const int col = j * kSub + (jj < p ? jj : jj - p);
        tilef[tile_slot(t, col >> 2) * 4 + (col & 3)] = acc[jj];
      }
    }
  }
  __syncthreads();

  // A row by row; every element, zeros on and above the diagonal
  float* out = A + int64_t(blockIdx.x) * c * c;
  if ((c & 3) == 0) {
    const int c4 = c >> 2;
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int e = tid; e < c * c4; e += kThreads) {
      const int t = e / c4, col4 = e - t * c4, i = 4 * col4;
      float4 v = tile[tile_slot(t, col4)];
      if (i >= t) v.x = 0.f;
      if (i + 1 >= t) v.y = 0.f;
      if (i + 2 >= t) v.z = 0.f;
      if (i + 3 >= t) v.w = 0.f;
      out4[e] = v;
    }
  } else {
    for (int e = tid; e < c * c; e += kThreads) {
      const int t = e / c, i = e - t * c;
      out[e] = i < t ? tilef[tile_slot(t, i >> 2) * 4 + (i & 3)] : 0.f;
    }
  }
}

}  // namespace

// r, k, l_prev, l: (B, H, S, N) float32, contiguous; A: (B, H, S/c, c, c)
// float32. `chunks` is B H S / c. N a multiple of 16, 1 <= c <= 128.
extern "C" int wkv_intra_launch(const void* r, const void* k,
                                const void* l_prev, const void* l,
                                int chunks, int c, int N, void* A,
                                void* stream) {
  if (c < 1 || c > kMaxChunk || N < kSlice || N % kSlice)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      wkv_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_intra_kernel<<<chunks, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(l_prev), static_cast<const float*>(l), c, N,
      static_cast<float*>(A));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv_intra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
