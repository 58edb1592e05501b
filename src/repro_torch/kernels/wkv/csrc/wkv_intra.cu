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
// summed over N), and the port's first version did the same in torch,
// one chunk at a time: ~1 s of rwkv6-1.6b's 16 x 512 prefill went to
// float32 elementwise passes over that tensor. This kernel writes A
// (B, H, S/c, c, c) and nothing else: the (c, c, N) intermediate never
// leaves registers.
//
// The exponent is never factored into exp(l_prev) exp(-l): l falls by
// up to exp(w) a token and passes -80 inside a chunk once the decay base
// has trained above 0, where exp(-l) overflows float32. Each (t, i, n)
// exponent is formed as a difference, which is <= 0 below the diagonal;
// pairs on or above it take -inf, whose exponential is 0, so no positive
// exponent is ever evaluated.
//
// The design: one block a chunk. Each thread owns one 4 x 4 (t, i) tile
// of the lower triangle (its diagonal tile included: 528 tiles at
// c = 128, so 544 threads) and keeps its 16 sums in registers. The
// chunk's r, l_prev, k and l are staged 16 values of n at a time into
// shared memory (32 KB), transposed so that a tile's four rows are one
// float4, with the float4 slot XOR-swizzled by n so that both the
// transposing stores and the threads' float4 reads are free of bank
// conflicts. Per (t, i, n): one subtraction, one exponential (ex2 on the
// SFU), one product and one fused add. The strictly upper tiles are
// written as zeros, so the output needs no memset.
//
// Bound: the exponentials. At rwkv6-1.6b's training microbatch
// (2 x 32 heads x 4,096 tokens, N 64, c 128) a layer takes
// 1.07 G of them; the SFUs' 16 a clock an SM give ~0.26 ms on an H100,
// against ~0.04 ms for the bytes (134 MB of A) and ~0.06 ms for the
// float32 operations. Making it fast is later work: sub-chunk reference
// points (fewer exponentials) and tensor cores for the r.k products.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 128;
// a thread's (t, i) tile is kTile x kTile
constexpr int kTile = 4;
constexpr int kMaxTileRows = kMaxChunk / kTile;
// n values a stage holds
constexpr int kSlice = 16;
// the lower tiles at c = 128 (32 x 33 / 2 = 528), rounded up to warps
constexpr int kMaxThreads = 544;
// the staged arrays: r and l_prev (the t side), k and l (the i side)
constexpr int kArrays = 4;

// The float4 slot of tile row `tb` in stage row n: swizzled within each
// group of eight slots, so that eight consecutive n (the lanes of one
// transposing store) and eight consecutive slots (the lanes of one read)
// both fall on distinct banks.
__device__ __forceinline__ int slot(int tb, int n) { return tb ^ (n & 7); }

__global__ void __launch_bounds__(kMaxThreads)
wkv_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ lp, const float* __restrict__ l,
                 int c, int N, float* __restrict__ A) {
  __shared__ float4 stage[kArrays][kSlice][kMaxTileRows];
  const int64_t in0 = int64_t(blockIdx.x) * c * N;
  float* out = A + int64_t(blockIdx.x) * c * c;
  const int ntb = (c + kTile - 1) / kTile;
  const int tiles = ntb * (ntb + 1) / 2;
  const int tid = threadIdx.x;

  // this thread's tile: p -> (tb, ib) with ib <= tb, row by row
  const bool active = tid < tiles;
  int tb = 0;
  if (active) {
    tb = int((sqrtf(8.f * float(tid) + 1.f) - 1.f) * 0.5f);
    while (tb * (tb + 1) / 2 > tid) --tb;
    while ((tb + 1) * (tb + 2) / 2 <= tid) ++tb;
  }
  const int ib = tid - tb * (tb + 1) / 2;
  const bool diag = tb == ib;

  float acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0.f;

  const float* const src[kArrays] = {r, lp, k, l};
  float* const flat = reinterpret_cast<float*>(stage);
  // staged elements a slice: kArrays x kSlice x (ntb * kTile) rows
  const int per_slice = kArrays * kSlice * ntb * kTile;
  for (int n0 = 0; n0 < N; n0 += kSlice) {
    // a warp stores 8 n x 4 t: lanes (n & 7, t & 3); the rest of the
    // index walks (array, tile row, n / 8). Rows past c are zeros.
    for (int e = tid; e < per_slice; e += blockDim.x) {
      const int n_lo = e & 7, t_lo = (e >> 3) & 3, rest = e >> 5;
      const int n = ((rest & 1) << 3) | n_lo;
      const int rest2 = rest >> 1;
      const int t0 = rest2 % ntb, arr = rest2 / ntb;
      const int t = t0 * kTile + t_lo;
      const float v = t < c ? src[arr][in0 + int64_t(t) * N + n0 + n] : 0.f;
      flat[((arr * kSlice + n) * kMaxTileRows + slot(t0, n)) * 4 + t_lo] = v;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int n = 0; n < kSlice; ++n) {
        const float4 rt = stage[0][n][slot(tb, n)];
        const float4 pt = stage[1][n][slot(tb, n)];
        const float4 ki = stage[2][n][slot(ib, n)];
        const float4 li = stage[3][n][slot(ib, n)];
        const float ra[kTile] = {rt.x, rt.y, rt.z, rt.w};
        const float pa[kTile] = {pt.x, pt.y, pt.z, pt.w};
        const float kb[kTile] = {ki.x, ki.y, ki.z, ki.w};
        const float lb[kTile] = {li.x, li.y, li.z, li.w};
#pragma unroll
        for (int a = 0; a < kTile; ++a)
#pragma unroll
          for (int b = 0; b < kTile; ++b) {
            // on the diagonal tile, i >= t takes -inf: exp gives 0
            const float x = (diag && b >= a) ? -INFINITY : pa[a] - lb[b];
            acc[a][b] = fmaf(ra[a] * kb[b], __expf(x), acc[a][b]);
          }
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int t = tb * kTile + a;
      if (t >= c) break;
      float* row = out + int64_t(t) * c + ib * kTile;
      if ((c & 3) == 0) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      } else {
#pragma unroll
        for (int b = 0; b < kTile; ++b)
          if (ib * kTile + b < c) row[b] = acc[a][b];
      }
    }
  }
  // the strictly upper tiles: a warp a row
  const int lane = tid & 31, warps = blockDim.x >> 5;
  for (int t = tid >> 5; t < c; t += warps)
    for (int i = (t / kTile + 1) * kTile + lane; i < c; i += 32)
      out[int64_t(t) * c + i] = 0.f;
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
  const int ntb = (c + kTile - 1) / kTile;
  const int tiles = ntb * (ntb + 1) / 2;
  const int threads = (tiles + 31) / 32 * 32;
  wkv_intra_kernel<<<chunks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(l_prev), static_cast<const float*>(l), c, N,
      static_cast<float*>(A));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv_intra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
