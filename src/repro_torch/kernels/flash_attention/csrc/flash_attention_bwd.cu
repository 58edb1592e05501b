// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in flash_attention.cu, causal (top-left aligned, Skv != S
// allowed) or not, with GQA, from the forward's output O and the row
// log-sum-exp it wrote (`lse`).
//
// The TPU kernel it stands beside is `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:67, pallas_call
// at :79), which has no backward: the reference trains through the jnp
// `attention.flash_heads` and autodiff. The port's training path runs
// the forward kernel, so its gradient is this kernel (the
// torch.autograd.Function in ../ops.py).
//
// No float atomics anywhere: each output element is written once, its
// sums taken in a fixed order, so a run's gradients are the same bits in
// every run, which a bit-exact crash restart needs.
//
// Bound: at tinyllama-1.1b's shape (B 2, H 32, Hkv 4, S 4,096, D 64,
// bf16, causal) the function must read q, k, v, O, dO and write dq, dk,
// dv (~134 MB, 40 us at 3.35 TB/s) and do 5 matrix products over the
// causal pairs (S = QK^T, dP = dO V^T, dV, dK, dQ: 10 D flops a pair,
// 344 GFLOP, 348 us at 989 TFLOP/s): operations bound it. A design in
// two passes (dK/dV by key tile, dQ by query tile) computes S and dP in
// both, 14 D flops a pair: its floor is 487 us.
//
// bfloat16, D 64 and 128 (every training shape: tinyllama, the Yi and
// Qwen families, qwen3-moe): four kernels a call.
//   1. prep: lse log2(e) and delta = rowsum(dO * O) in float32, one warp
//      a row, into workspace rows padded to a multiple of 64 with zeros,
//      so that a tile of either is one 16-byte aligned bulk copy.
//   2. dK/dV: one block per (b, query head, 128-key tile): two consumer
//      warpgroups own 64 keys each; one lane of a producer warpgroup
//      streams the head's query tiles (BQ = 64 queries at D 64, 32 at
//      D 128) by TMA into a ring of 4 stages behind full / empty mbarrier
//      pairs, with each tile's lse and delta rows beside them
//      (cp.async.bulk). K and V of the block arrive once, first. Per tile
//      a warpgroup issues S^T = K Q^T and dP^T = V dO^T on wgmma (ss
//      form, both operands K-major from 128-byte-swizzled tiles, as the
//      forward's QK^T), forms P^T = 2^(s scale log2(e) - lse log2(e))
//      and dS^T = P^T (dP^T - delta) in registers, rounds both to bf16 as
//      register A operands and issues dV += P^T dO and dK += dS^T Q (rs
//      form, dO and Q under the transpose bit, as the forward's PV). The
//      serial chain is one head's query tiles, at most 64 at tinyllama
//      (a design that loops over the group's 8 heads in one block takes
//      1,024); blocks run heaviest first (key tile 0 sees every
//      query), and a warpgroup skips the tiles none of whose queries see
//      its keys.
//   3. the group sum: where a KV head serves G > 1 query heads, each
//      block writes its head's float32 partial dK and dV to a (B, H,
//      Skv, D) workspace and this pass adds the G partials of each KV
//      head in head order (then scales dK and rounds to bf16): ~134 MB
//      written and read again at tinyllama (~80 us at 3.35 TB/s, ~50 on
//      the card, where part stays in L2). It was chosen over summing in a
//      thread-block cluster through distributed shared memory because a
//      cluster of G = 7 or 8 blocks of ~100-130 KB each must be
//      co-resident on one GPC, which the scheduler cannot always place,
//      and because the pass keeps one fixed order whatever G. At G = 1
//      the block writes bf16 dK and dV itself.
//   4. dQ: one block per (b, head, 128-query tile): two consumer
//      warpgroups own 64 queries each, whose Q and dO arrive once by
//      TMA; the producer streams 64-key K and V tiles through a ring of
//      4 stages, up to the causal bound, heaviest query tile first.
//      S = Q K^T and dP = dO V^T on the ss form, dS rounded to bf16 as
//      the register A operand of dQ += dS K (K under the transpose bit).
//      dQ is its own pass, so no two blocks add to one dQ element.
// Overlap: a tile's last products (dV and dK, or dQ) stay in flight
// while the next tile's S and dP are issued behind them, and the
// exponentials run while dP is computed; a stage is released when the
// products that read it are waited for. Between an issue and its wait
// the consumers run no branch that may diverge (masks are per-thread
// column limits with selects; every consumer thread arrives on the
// empty barriers, a sink barrier standing in for "no tile yet"):
// otherwise ptxas serialises every wgmma (its C7518 note).
// Registers: 384 threads (the producer warpgroup included) leave 168 a
// thread; the producer hands all but 24 back (setmaxnreg) and each
// consumer takes 240, which holds, at D 128, the dK and dV accumulators
// of 64 keys x 128 columns (64 floats each a thread) beside S^T and
// dP^T of 32-query tiles without a spill. The launch refuses a build
// whose pool falls short, which would otherwise never start.
//
// bfloat16, D 16 and 32 (the smoke configs' heads only) and MLA's
// (Dk 192, Dv 128): the wgmma tiling wants 64-column swizzled boxes and
// one head dim, so these keep mma.sync m16n8k16 with synchronously
// staged tiles, templated on <DK, DV>: delta = rowsum(dO * O) over Dv by
// one warp a row; dK (DK columns), dV (DV columns) by one block per (b,
// KV head, 64-key tile) looping over the group's heads and the 32-query
// tiles that see the keys (the group summed in registers), S^T over DK
// and dP^T over DV; dQ (DK columns) by one block per (b, head, 64-query
// tile). At (192, 128) a thread holds 160 dK/dV accumulators, and dQ's
// block reads its Q and dO fragments from shared memory each key tile
// instead of keeping them in registers. MLA's query and key heads are
// equal in number (128 and 128), so no group sum arises there. This
// path is simple and right, not fast: PERF.md times it against its
// bound.
//
// float32: mma would round the inputs to tf32, so the float32 kernels
// stay on scalar FMAs from shared memory (32-key and 32-query tiles,
// four threads a row), in the same three kernels.
//
// P and dS are rounded to bf16 as the A operands of the dV / dK / dQ
// products on both bf16 paths, as FlashAttention-2 does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;  // four warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps
  const T* a = o + row * D;
  const T* b = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(a[d]), to_f(b[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs, 32 x 32 tiles, four threads a row
// ---------------------------------------------------------------------------

constexpr int FT = 32;  // rows of a float32 tile

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * FT * (D + 1) + 2 * FT * (FT + 1) + 2 * FT) *
         static_cast<int>(sizeof(float));
}

// rows [row0, row0 + FT) of a (rows, D) matrix into dst (stride D + 1),
// zero past `rows`
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int rows) {
  for (int i = threadIdx.x; i < FT * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < rows ? src[static_cast<int64_t>(row0 + r) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int Hkv, int S, int Skv,
                int causal, float scale) {
  constexpr int DP = D + 1, J = D / 4;
  extern __shared__ float fsm[];
  float* k_s = fsm;
  float* v_s = k_s + FT * DP;
  float* q_s = v_s + FT * DP;
  float* do_s = q_s + FT * DP;
  float* p_s = do_s + FT * DP;      // P^T: (key, query)
  float* ds_s = p_s + FT * (FT + 1);
  float* lse_s = ds_s + FT * (FT + 1);
  float* dl_s = lse_s + FT;

  const int kt = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv % Hkv, G = H / Hkv;
  const int kr = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int kpos = kt * FT + kr;
  stage_f32<D>(k_s, k + static_cast<int64_t>(bkv) * Skv * D, kt * FT, Skv);
  stage_f32<D>(v_s, v + static_cast<int64_t>(bkv) * Skv * D, kt * FT, Skv);
  float dka[J], dva[J];
#pragma unroll
  for (int j = 0; j < J; ++j) dka[j] = dva[j] = 0.f;

  const int n_qt = (S + FT - 1) / FT;
  const int q0 = causal ? kt : 0;  // query tiles that can see these keys
  for (int gi = 0; gi < G; ++gi) {
    const int bh = b * H + hkv * G + gi;
    for (int qt = q0; qt < n_qt; ++qt) {
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage_f32<D>(q_s, q + static_cast<int64_t>(bh) * S * D, qt * FT, S);
      stage_f32<D>(do_s, dout + static_cast<int64_t>(bh) * S * D, qt * FT, S);
      if (threadIdx.x < FT) {
        const int qp = qt * FT + threadIdx.x;
        lse_s[threadIdx.x] = qp < S ? lse[static_cast<int64_t>(bh) * S + qp]
                                    : 0.f;
        dl_s[threadIdx.x] = qp < S ? delta[static_cast<int64_t>(bh) * S + qp]
                                   : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < FT / 4; ++i) {
        const int qi = c4 + 4 * i, qpos = qt * FT + qi;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(q_s[qi * DP + d], k_s[kr * DP + d], s);
          dp = fmaf(do_s[qi * DP + d], v_s[kr * DP + d], dp);
        }
        const bool ok = qpos < S && kpos < Skv && (!causal || qpos >= kpos);
        const float p = ok ? expf(s * scale - lse_s[qi]) : 0.f;
        p_s[kr * (FT + 1) + qi] = p;
        ds_s[kr * (FT + 1) + qi] = p * (dp - dl_s[qi]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d = c4 + 4 * j;
        float a = dva[j], c = dka[j];
        for (int qi = 0; qi < FT; ++qi) {
          a = fmaf(p_s[kr * (FT + 1) + qi], do_s[qi * DP + d], a);
          c = fmaf(ds_s[kr * (FT + 1) + qi], q_s[qi * DP + d], c);
        }
        dva[j] = a;
        dka[j] = c;
      }
    }
  }
  if (kpos < Skv) {
    const int64_t o = (static_cast<int64_t>(bkv) * Skv + kpos) * D;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      dk[o + c4 + 4 * j] = dka[j] * scale;
      dv[o + c4 + 4 * j] = dva[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Hkv, int S, int Skv,
              int causal, float scale) {
  constexpr int DP = D + 1, J = D / 4;
  extern __shared__ float fsm[];
  float* q_s = fsm;
  float* do_s = q_s + FT * DP;
  float* k_s = do_s + FT * DP;
  float* v_s = k_s + FT * DP;
  float* ds_s = v_s + FT * DP;  // (query, key)

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int qr = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int qpos = qt * FT + qr;
  stage_f32<D>(q_s, q + static_cast<int64_t>(bh) * S * D, qt * FT, S);
  stage_f32<D>(do_s, dout + static_cast<int64_t>(bh) * S * D, qt * FT, S);
  const float my_lse = qpos < S ? lse[static_cast<int64_t>(bh) * S + qpos]
                                : 0.f;
  const float my_dl = qpos < S ? delta[static_cast<int64_t>(bh) * S + qpos]
                               : 0.f;
  float dqa[J];
#pragma unroll
  for (int j = 0; j < J; ++j) dqa[j] = 0.f;

  int n_kt = (Skv + FT - 1) / FT;
  if (causal) n_kt = min(n_kt, qt + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    stage_f32<D>(k_s, k + static_cast<int64_t>(bkv) * Skv * D, kt * FT, Skv);
    stage_f32<D>(v_s, v + static_cast<int64_t>(bkv) * Skv * D, kt * FT, Skv);
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < FT / 4; ++i) {
      const int ki = c4 + 4 * i, kpos = kt * FT + ki;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[qr * DP + d], k_s[ki * DP + d], s);
        dp = fmaf(do_s[qr * DP + d], v_s[ki * DP + d], dp);
      }
      const bool ok = qpos < S && kpos < Skv && (!causal || qpos >= kpos);
      const float p = ok ? expf(s * scale - my_lse) : 0.f;
      ds_s[qr * (FT + 1) + ki] = p * (dp - my_dl);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = c4 + 4 * j;
      float a = dqa[j];
      for (int ki = 0; ki < FT; ++ki)
        a = fmaf(ds_s[qr * (FT + 1) + ki], k_s[ki * DP + d], a);
      dqa[j] = a;
    }
  }
  if (qpos < S) {
    const int64_t o = (static_cast<int64_t>(bh) * S + qpos) * D;
#pragma unroll
    for (int j = 0; j < J; ++j) dq[o + c4 + 4 * j] = dqa[j] * scale;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int Hkv, int S, int Skv, int causal,
               float scale, cudaStream_t s) {
  constexpr int SM = f32_smem_bytes<D>();
  auto kv = dkdv_f32_kernel<D>;
  auto kq = dq_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  kv<<<dim3((Skv + FT - 1) / FT, B * Hkv), THREADS, SM, s>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Hkv, S, Skv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3((S + FT - 1) / FT, B * H), THREADS, SM, s>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dq), H, Hkv, S, Skv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------
//
// Fragments (g = lane / 4, t = lane % 4): A (16 x 16, row-major) a0 =
// A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 =
// A[g+8][2t+8, 2t+9]; B (16 x 8) b0 = B[2t, 2t+1][g], b1 = B[2t+8,
// 2t+9][g]; C (16 x 8) c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t,
// 2t+1].

constexpr int KT = 64;  // keys of a dK/dV block, queries of a dQ block
constexpr int QT = 32;  // the inner tiles: queries (dK/dV), keys (dQ)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of rows (r0, r0 + 8), columns [c0, c0 + 16) of a
// shared tile with row stride DS
template <int DS>
__device__ __forceinline__ void frag_a(uint32_t a[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0, int t) {
  const __nv_bfloat16* p = tile + r0 * DS + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * DS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * DS + 8);
}

// rows [row0, row0 + n) of a (rows, D) bf16 matrix into shared memory
// with row stride D + 8, zero past `rows`; 16 bytes a thread a step
template <int D, int N>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int rows) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < N * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// K (or Q) and V (or dO) tiles of KT rows, and the inner tiles of QT
// rows, at head dims DK and DV
template <int DK, int DV>
constexpr int mma_smem_bytes() {
  return (KT + QT) * (DK + 8 + DV + 8) *
             static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * KT * static_cast<int>(sizeof(float));
}

// P (or dS) of four 8-column chunks as the A fragments of two 16-column
// k-chunks of the next product
__device__ __forceinline__ void pack_a(uint32_t pa[2][4], const float x[4][4]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    pa[c][0] = pack_bf16(x[2 * c][0], x[2 * c][1]);
    pa[c][1] = pack_bf16(x[2 * c][2], x[2 * c][3]);
    pa[c][2] = pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
    pa[c][3] = pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
  }
}

// acc (16 x D) += pa (16 x 32) * M[rows 0..31 of the tile][0..D), M a
// shared tile (row stride DS) read as the B operand, row-major in k
template <int D>
__device__ __forceinline__ void mma_pv(float acc[D / 8][4],
                                       const uint32_t pa[2][4],
                                       const __nv_bfloat16* m, int g,
                                       int t) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const __nv_bfloat16* mp = m + (c * 16 + 2 * t) * DS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* x = mp + n * 8;
      mma_bf16(acc[n], pa[c], pack_bf16(x[0], x[DS]),
               pack_bf16(x[8 * DS], x[9 * DS]));
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S,
                int Skv, int causal, float scale) {
  constexpr int DSK = DK + 8, DSV = DV + 8;
  constexpr int KCK = DK / 16, KCV = DV / 16, NDK = DK / 8, NDV = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + KT * DSK;
  __nv_bfloat16* q_s = v_s + KT * DSV;
  __nv_bfloat16* do_s = q_s + QT * DSK;
  float* lse_s = reinterpret_cast<float*>(do_s + QT * DSV);
  float* dl_s = lse_s + QT;

  const int kt = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv % Hkv, G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's keys: r0, r0 + 8
  const int kpos0 = kt * KT + r0, kpos1 = kpos0 + 8;
  stage_bf16<DK, KT>(k_s, k + static_cast<int64_t>(bkv) * Skv * DK,
                     kt * KT, Skv);
  stage_bf16<DV, KT>(v_s, v + static_cast<int64_t>(bkv) * Skv * DV,
                     kt * KT, Skv);
  float dka[NDK][4], dva[NDV][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < NDV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;

  const int n_qt = (S + QT - 1) / QT;
  const int q0 = causal ? kt * KT / QT : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int bh = b * H + hkv * G + gi;
    for (int qt = q0; qt < n_qt; ++qt) {
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage_bf16<DK, QT>(q_s, q + static_cast<int64_t>(bh) * S * DK,
                         qt * QT, S);
      stage_bf16<DV, QT>(do_s, dout + static_cast<int64_t>(bh) * S * DV,
                         qt * QT, S);
      if (threadIdx.x < QT) {
        const int qp = qt * QT + threadIdx.x;
        lse_s[threadIdx.x] = qp < S ? lse[static_cast<int64_t>(bh) * S + qp]
                                    : 0.f;
        dl_s[threadIdx.x] = qp < S ? delta[static_cast<int64_t>(bh) * S + qp]
                                   : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T (over DK) and dP^T = V dO^T (over DV): 16 keys x 32
      // queries a warp
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nc = 0; nc < 4; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nc][e] = dpt[nc][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KCK; ++kc) {
        uint32_t ka[4];
        frag_a<DSK>(ka, k_s, r0, kc * 16, t);
#pragma unroll
        for (int nc = 0; nc < 4; ++nc) {
          const __nv_bfloat16* qp = q_s + (nc * 8 + g) * DSK + kc * 16 + 2 * t;
          mma_bf16(st[nc], ka, ld32(qp), ld32(qp + 8));
        }
      }
#pragma unroll
      for (int kc = 0; kc < KCV; ++kc) {
        uint32_t va[4];
        frag_a<DSV>(va, v_s, r0, kc * 16, t);
#pragma unroll
        for (int nc = 0; nc < 4; ++nc) {
          const __nv_bfloat16* dp = do_s + (nc * 8 + g) * DSV + kc * 16 + 2 * t;
          mma_bf16(dpt[nc], va, ld32(dp), ld32(dp + 8));
        }
      }
      // P^T = exp(s scale - lse) masked, dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int nc = 0; nc < 4; ++nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nc * 8 + 2 * t + (e & 1);
          const int qpos = qt * QT + qi;
          const int kpos = e < 2 ? kpos0 : kpos1;
          const bool ok = qpos < S && kpos < Skv &&
                          (!causal || qpos >= kpos);
          const float p = ok ? expf(st[nc][e] * scale - lse_s[qi]) : 0.f;
          st[nc][e] = p;
          dpt[nc][e] = p * (dpt[nc][e] - dl_s[qi]);
        }
      }
      uint32_t pa[2][4];
      pack_a(pa, st);
      mma_pv<DV>(dva, pa, do_s, g, t);  // dV += P^T dO
      pack_a(pa, dpt);
      mma_pv<DK>(dka, pa, q_s, g, t);   // dK += dS^T Q
    }
  }
  const int64_t base = static_cast<int64_t>(bkv) * Skv;
#pragma unroll
  for (int n = 0; n < NDK; ++n) {
    const int col = n * 8 + 2 * t;
    if (kpos0 < Skv)
      *reinterpret_cast<uint32_t*>(dk + (base + kpos0) * DK + col) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
    if (kpos1 < Skv)
      *reinterpret_cast<uint32_t*>(dk + (base + kpos1) * DK + col) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
  }
#pragma unroll
  for (int n = 0; n < NDV; ++n) {
    const int col = n * 8 + 2 * t;
    if (kpos0 < Skv)
      *reinterpret_cast<uint32_t*>(dv + (base + kpos0) * DV + col) =
          pack_bf16(dva[n][0], dva[n][1]);
    if (kpos1 < Skv)
      *reinterpret_cast<uint32_t*>(dv + (base + kpos1) * DV + col) =
          pack_bf16(dva[n][2], dva[n][3]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S, int Skv,
              int causal, float scale) {
  constexpr int DSK = DK + 8, DSV = DV + 8;
  constexpr int KCK = DK / 16, KCV = DV / 16, NDK = DK / 8;
  // the small heads keep their Q and dO fragments in registers; MLA's
  // (192, 128) reads them from shared memory each key tile, beside dQ's
  // 96 accumulators a thread
  constexpr bool HOIST = DK + DV <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + KT * DSK;
  __nv_bfloat16* k_s = do_s + KT * DSV;
  __nv_bfloat16* v_s = k_s + QT * DSK;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's queries: r0, r0 + 8
  const int qpos0 = qt * KT + r0, qpos1 = qpos0 + 8;
  stage_bf16<DK, KT>(q_s, q + static_cast<int64_t>(bh) * S * DK, qt * KT,
                     S);
  stage_bf16<DV, KT>(do_s, dout + static_cast<int64_t>(bh) * S * DV,
                     qt * KT, S);
  const int64_t rb = static_cast<int64_t>(bh) * S;
  const float lse0 = qpos0 < S ? lse[rb + qpos0] : 0.f;
  const float lse1 = qpos1 < S ? lse[rb + qpos1] : 0.f;
  const float dl0 = qpos0 < S ? delta[rb + qpos0] : 0.f;
  const float dl1 = qpos1 < S ? delta[rb + qpos1] : 0.f;
  __syncthreads();
  uint32_t qa[HOIST ? KCK : 1][4], da[HOIST ? KCV : 1][4];
  if constexpr (HOIST) {
#pragma unroll
    for (int kc = 0; kc < KCK; ++kc) frag_a<DSK>(qa[kc], q_s, r0, kc * 16, t);
#pragma unroll
    for (int kc = 0; kc < KCV; ++kc)
      frag_a<DSV>(da[kc], do_s, r0, kc * 16, t);
  }
  float dqa[NDK][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int n_kt = (Skv + QT - 1) / QT;
  if (causal) n_kt = min(n_kt, (qt * KT + KT - 1) / QT + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile is consumed
    stage_bf16<DK, QT>(k_s, k + static_cast<int64_t>(bkv) * Skv * DK,
                       kt * QT, Skv);
    stage_bf16<DV, QT>(v_s, v + static_cast<int64_t>(bkv) * Skv * DV,
                       kt * QT, Skv);
    __syncthreads();
    // S = Q K^T (over DK) and dP = dO V^T (over DV): 16 queries x 32
    // keys a warp
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int nc = 0; nc < 4; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nc][e] = dp[nc][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KCK; ++kc) {
      uint32_t a[4];
      if constexpr (HOIST) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kc][i];
      } else {
        frag_a<DSK>(a, q_s, r0, kc * 16, t);
      }
#pragma unroll
      for (int nc = 0; nc < 4; ++nc) {
        const __nv_bfloat16* kp = k_s + (nc * 8 + g) * DSK + kc * 16 + 2 * t;
        mma_bf16(sc[nc], a, ld32(kp), ld32(kp + 8));
      }
    }
#pragma unroll
    for (int kc = 0; kc < KCV; ++kc) {
      uint32_t a[4];
      if constexpr (HOIST) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = da[kc][i];
      } else {
        frag_a<DSV>(a, do_s, r0, kc * 16, t);
      }
#pragma unroll
      for (int nc = 0; nc < 4; ++nc) {
        const __nv_bfloat16* vp = v_s + (nc * 8 + g) * DSV + kc * 16 + 2 * t;
        mma_bf16(dp[nc], a, ld32(vp), ld32(vp + 8));
      }
    }
#pragma unroll
    for (int nc = 0; nc < 4; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kt * QT + nc * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const bool ok = qpos < S && kpos < Skv && (!causal || qpos >= kpos);
        const float p =
            ok ? expf(sc[nc][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        sc[nc][e] = p * (dp[nc][e] - (e < 2 ? dl0 : dl1));  // dS
      }
    }
    uint32_t pa[2][4];
    pack_a(pa, sc);
    mma_pv<DK>(dqa, pa, k_s, g, t);  // dQ += dS K
  }
#pragma unroll
  for (int n = 0; n < NDK; ++n) {
    const int col = n * 8 + 2 * t;
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(dq + (rb + qpos0) * DK + col) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(dq + (rb + qpos1) * DK + col) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int B, int H, int Hkv, int S,
                int Skv, int causal, float scale, cudaStream_t s) {
  constexpr int SM = mma_smem_bytes<DK, DV>();
  auto kv = dkdv_mma_kernel<DK, DV>;
  auto kq = dq_mma_kernel<DK, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, SM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM);
  if (e != cudaSuccess) return static_cast<int>(e);
  using T = __nv_bfloat16;
  const T* bq = static_cast<const T*>(q);
  const T* bk = static_cast<const T*>(k);
  const T* bv = static_cast<const T*>(v);
  const T* bdo = static_cast<const T*>(dout);
  kv<<<dim3((Skv + KT - 1) / KT, B * Hkv), THREADS, SM, s>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, S, Skv, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3((S + KT - 1) / KT, B * H), THREADS, SM, s>>>(
      bq, bk, bv, bdo, lse, delta, static_cast<T*>(dq), H, Hkv, S, Skv,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16, D 64 and 128: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BOX = 64 * 128;  // a (64 rows, 64 bf16) 128-byte-swizzled box
constexpr int NWG = 2;         // consumer warpgroups a block
// and a producer warpgroup: one lane of its first warp issues the loads
constexpr int WG_THREADS = (NWG + 1) * 128;
// registers a thread after setmaxnreg: the producer's and the
// consumers', from the pool of 168 a thread that 384 threads get
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int ST = 4;          // ring stages

// rows of a (b, h) row of the padded lse / delta workspace
inline int64_t pad64(int64_t n) { return (n + 63) / 64 * 64; }

// the dK/dV pass at head dim D with BQ-query tiles
template <int D, int BQ>
struct Kv {
  static constexpr int CB = D / 64;                // 64-column boxes a row
  static constexpr int QBOX = BQ * 128;            // a (BQ rows, 64) box
  static constexpr int KV_BYTES = NWG * CB * BOX;  // K (or V) of 128 keys
  static constexpr int Q_BYTES = CB * QBOX;        // Q (or dO) of a tile
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int VEC = 2 * BQ * 4;           // lse2 and delta rows
  // + 1024: the dynamic buffer is aligned up to the swizzle atom
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + ST * STAGE + ST * VEC +
                              8 * (2 * ST + 2);
};

// the dQ pass at head dim D
template <int D>
struct Dq {
  static constexpr int CB = D / 64;
  static constexpr int Q_BYTES = NWG * CB * BOX;  // Q (or dO) of 128 queries
  static constexpr int STAGE = 2 * CB * BOX;      // K and V of 64 keys
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + ST * STAGE +
                              8 * (2 * ST + 2);
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64)
    sm90::wgmma_ss_m64n64k16(d, a, b, scale_d);
  else
    sm90::wgmma_ss_m64n32k16(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (N == 64)
    sm90::wgmma_rs_m64n64k16_tb(d, a, b);
  else
    sm90::wgmma_rs_m64n128k16_tb(d, a, b);
}

// an accumulator tile (rows g + 8u, columns 8j + 2t + e: element
// 4j + 2u + e) rounded to bf16 as the register A fragments of the next
// product's k-chunks of 16 columns
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4],
                                           const float (&x)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j / 2][2 * (j % 2)] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][2 * (j % 2) + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// 1. lse2 = lse log2(e) and delta = rowsum(dO O) of each query row, in
// rows of s_pad (zeros past S); one warp a row
template <int D>
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ delta, int S, int64_t s_pad, int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps
  const int64_t bh = row / s_pad;
  const int q = static_cast<int>(row - bh * s_pad);
  float s = 0.f, l = 0.f;
  if (q < S) {
    const int64_t src = (bh * S + q) * D;
#pragma unroll
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + src + d));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + src + d));
      s = fmaf(a.y, b.y, fmaf(a.x, b.x, s));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    l = lse[bh * S + q] * LOG2E;
  }
  if (lane == 0) {
    lse2[row] = l;
    delta[row] = s;
  }
}

// 2. dK, dV of one (b, query head, 128-key tile): block w is key tile
// w / n_bh of head w % n_bh, so the heaviest causal tiles come first
template <int D, int BQ>
__global__ void __launch_bounds__(WG_THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ pk,
                  float* __restrict__ pv, int H, int Hkv, int S, int Skv,
                  int s_pad, int n_bh, int causal, float scale,
                  float scale_log2) {
  using C = Kv<D, BQ>;
  constexpr int CB = C::CB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + C::KV_BYTES;
  const uint32_t ring = base + 2 * C::KV_BYTES;
  const uint32_t vec = ring + ST * C::STAGE;
  const uint32_t bars = vec + ST * C::VEC;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const uint32_t kv_full = bars + 16 * ST;
  const uint32_t sink = kv_full + 8;  // arrived on, never waited for

  const int w = blockIdx.x;
  const int bh = w % n_bh, k0 = (w / n_bh) * 128;
  const int G = H / Hkv;
  const int bkv = (bh / H) * Hkv + (bh % H) / G;
  const int qt0 = causal ? k0 / BQ : 0;  // the first tile that sees k0
  const int n_it = max(0, (S + BQ - 1) / BQ - qt0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), NWG * 128);  // every consumer thread
    }
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(sink, NWG * 128);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {  // the producer warpgroup
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NWG * 4 && lane == 0) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tdo);
      sm90::mbar_arrive_tx(kv_full, 2 * C::KV_BYTES);
      for (int g = 0; g < NWG; ++g)
        for (int c = 0; c < CB; ++c) {
          const uint32_t off = (g * CB + c) * BOX;
          sm90::tma_load_3d(k_s + off, &tk, kv_full, c * 64, k0 + 64 * g,
                            bkv);
          sm90::tma_load_3d(v_s + off, &tv, kv_full, c * 64, k0 + 64 * g,
                            bkv);
        }
      const float* lr = lse2 + static_cast<int64_t>(bh) * s_pad;
      const float* dr = delta + static_cast<int64_t>(bh) * s_pad;
      for (int i = 0; i < n_it; ++i) {
        const int s = i % ST, q0 = (qt0 + i) * BQ;
        sm90::mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        sm90::mbar_arrive_tx(full(s), C::STAGE + C::VEC);
        const uint32_t st = ring + s * C::STAGE;
        for (int c = 0; c < CB; ++c) {
          sm90::tma_load_3d(st + c * C::QBOX, &tq, full(s), c * 64, q0, bh);
          sm90::tma_load_3d(st + C::Q_BYTES + c * C::QBOX, &tdo, full(s),
                            c * 64, q0, bh);
        }
        sm90::bulk_load(vec + s * C::VEC, lr + q0, BQ * 4, full(s));
        sm90::bulk_load(vec + s * C::VEC + BQ * 4, dr + q0, BQ * 4,
                        full(s));
      }
    }
    return;
  }

  // a consumer warpgroup: keys kw0 + r_lo and kw0 + r_lo + 8
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r_lo = (warp & 3) * 16 + g;
  const int kw0 = k0 + 64 * wg;
  const uint32_t ka = k_s + wg * CB * BOX, va = v_s + wg * CB * BOX;
  const float* vec_p = reinterpret_cast<const float*>(
      smem_raw + (vec - sm90::smem_addr(smem_raw)));
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  // Tiles before i0 hold no query that sees these keys. Between a
  // product's issue and its wait the code runs no branch that may
  // diverge (ptxas would serialise every wgmma): every consumer thread
  // arrives on the empty barriers, and a tile's dV / dK products stay in
  // flight until the next tile's S^T and dP^T are queued behind them, so
  // its stage is released then, through `prev` (the sink at first).
  const int i0 = kw0 >= Skv ? n_it
                            : (causal ? min(n_it, max(0, kw0 / BQ - qt0)) : 0);
  // query column 8j + e (+ 2t) of a tile at q0 is kept where it lies in
  // [lo_u, hi): at or after key row u, and before S
  const int r0 = kw0 + r_lo - 2 * t;

  sm90::mbar_wait(kv_full, 0);
  for (int i = 0; i < i0; ++i) {
    const int s = i % ST;
    sm90::mbar_wait(full(s), (i / ST) & 1);
    sm90::mbar_arrive(empty(s));
  }
  uint32_t prev = sink;
  for (int i = i0; i < n_it; ++i) {
    const int s = i % ST, q0 = (qt0 + i) * BQ;
    const uint32_t qs = ring + s * C::STAGE, dos = qs + C::Q_BYTES;
    sm90::mbar_wait(full(s), (i / ST) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {  // S^T = K Q^T
      const uint32_t oa = (k / 4) * BOX + (k % 4) * 32;
      const uint32_t ob = (k / 4) * C::QBOX + (k % 4) * 32;
      wgmma_ss<BQ>(st, sm90::desc_sw128(ka + oa, 16, 1024),
                   sm90::desc_sw128(qs + ob, 16, 1024), k > 0);
    }
    sm90::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {  // dP^T = V dO^T
      const uint32_t oa = (k / 4) * BOX + (k % 4) * 32;
      const uint32_t ob = (k / 4) * C::QBOX + (k % 4) * 32;
      wgmma_ss<BQ>(dpt, sm90::desc_sw128(va + oa, 16, 1024),
                   sm90::desc_sw128(dos + ob, 16, 1024), k > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<2>();  // the previous tile's dV, dK
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::mbar_arrive(prev);
    sm90::wgmma_wait<1>();  // S^T
    sm90::fence_regs(st);
    const float* lz = vec_p + s * (2 * BQ);
    const float* dz = lz + BQ;
    const int hi = S - q0 - 2 * t;
    const int lo0 = causal ? r0 - q0 : -BQ, lo1 = causal ? r0 + 8 - q0 : -BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lz + 8 * j + 2 * t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * u + e, col = 8 * j + e;
          const float p = sm90::exp2_ftz(
              fmaf(st[x], scale_log2, -(e ? l2.y : l2.x)));
          st[x] = col >= (u ? lo1 : lo0) && col < hi ? p : 0.f;
        }
      }
    }
    pack_frags<BQ>(pa, st);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)  // dV += P^T dO
      wgmma_rs_tb<D>(dva, pa[kc],
                     sm90::desc_sw128(dos + kc * 2048, C::QBOX, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // dP^T
    sm90::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dz + 8 * j + 2 * t);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * u + e;
          dpt[x] = st[x] * (dpt[x] - (e ? d2.y : d2.x));  // dS^T
        }
      }
    }
    pack_frags<BQ>(da, dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)  // dK += dS^T Q
      wgmma_rs_tb<D>(dka, da[kc],
                     sm90::desc_sw128(qs + kc * 2048, C::QBOX, 1024));
    sm90::wgmma_commit();
    prev = empty(s);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dva);
  sm90::fence_regs(dka);
  sm90::mbar_arrive(prev);

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = kw0 + r_lo + 8 * u;
    if (row >= Skv) continue;
    if (G == 1) {  // the head's sums are the gradients
      const int64_t o = (static_cast<int64_t>(bkv) * Skv + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + o + c) = pack_bf16(
            dka[4 * j + 2 * u] * scale, dka[4 * j + 2 * u + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o + c) =
            pack_bf16(dva[4 * j + 2 * u], dva[4 * j + 2 * u + 1]);
      }
    } else {  // this head's float32 partials, for the group sum
      const int64_t o = (static_cast<int64_t>(bh) * Skv + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(pk + o + c) =
            make_float2(dka[4 * j + 2 * u], dka[4 * j + 2 * u + 1]);
        *reinterpret_cast<float2*>(pv + o + c) =
            make_float2(dva[4 * j + 2 * u], dva[4 * j + 2 * u + 1]);
      }
    }
  }
}

// 3. dk, dv (B, Hkv, Skv, D) = the sums over each group's G heads of the
// float32 partials (B, H, Skv, D), in head order; four values a thread
__global__ void __launch_bounds__(256)
sum_heads_kernel(const float4* __restrict__ pk, const float4* __restrict__ pv,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int64_t n4, int64_t plane4,
                 int G, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n4) return;
  const int64_t bkv = i / plane4;
  const int64_t src = bkv * G * plane4 + (i - bkv * plane4);
  float4 a = pk[src], b = pv[src];
  for (int g = 1; g < G; ++g) {
    const float4 x = pk[src + g * plane4], y = pv[src + g * plane4];
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
    b.x += y.x, b.y += y.y, b.z += y.z, b.w += y.w;
  }
  *reinterpret_cast<uint2*>(dk + 4 * i) = make_uint2(
      pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
  *reinterpret_cast<uint2*>(dv + 4 * i) =
      make_uint2(pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// 4. dQ of one (b, head, 128-query tile): block w is query tile
// n_qb - 1 - w / n_bh (causal: the heaviest first) of head w % n_bh
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse2,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S,
                int Skv, int s_pad, int n_bh, int n_qb, int causal,
                float scale, float scale_log2) {
  using C = Dq<D>;
  constexpr int CB = C::CB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + C::Q_BYTES;
  const uint32_t ring = base + 2 * C::Q_BYTES;
  const uint32_t bars = ring + ST * C::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const uint32_t q_full = bars + 16 * ST;
  const uint32_t sink = q_full + 8;

  const int w = blockIdx.x;
  const int bh = w % n_bh;
  const int q0 = (causal ? n_qb - 1 - w / n_bh : w / n_bh) * 128;
  const int bkv = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int kv_tiles = (Skv + 63) / 64;
  // the key tiles the block's last query sees
  const int n_kt =
      causal ? min(kv_tiles, (min(q0 + 128, S) - 1) / 64 + 1) : kv_tiles;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), NWG * 128);
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(sink, NWG * 128);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {  // the producer warpgroup
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NWG * 4 && lane == 0) {
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_arrive_tx(q_full, 2 * C::Q_BYTES);
      for (int g = 0; g < NWG; ++g)
        for (int c = 0; c < CB; ++c) {
          const uint32_t off = (g * CB + c) * BOX;
          sm90::tma_load_3d(q_s + off, &tq, q_full, c * 64, q0 + 64 * g, bh);
          sm90::tma_load_3d(do_s + off, &tdo, q_full, c * 64, q0 + 64 * g,
                            bh);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % ST;
        sm90::mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        sm90::mbar_arrive_tx(full(s), C::STAGE);
        const uint32_t st = ring + s * C::STAGE;
        for (int c = 0; c < CB; ++c) {
          sm90::tma_load_3d(st + c * BOX, &tk, full(s), c * 64, kt * 64, bkv);
          sm90::tma_load_3d(st + (CB + c) * BOX, &tv, full(s), c * 64,
                            kt * 64, bkv);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: queries qw0 + r_lo and qw0 + r_lo + 8
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r_lo = (warp & 3) * 16 + g;
  const int qw0 = q0 + 64 * wg;
  const int n_kt_w =
      qw0 >= S ? 0
               : (causal ? min(kv_tiles, (min(qw0 + 64, S) - 1) / 64 + 1)
                         : kv_tiles);
  float l2[2], dl[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = qw0 + r_lo + 8 * u;
    const int64_t o = static_cast<int64_t>(bh) * s_pad + row;
    l2[u] = row < S ? lse2[o] : 0.f;
    dl[u] = row < S ? delta[o] : 0.f;
  }
  const uint32_t qa = q_s + wg * CB * BOX, doa = do_s + wg * CB * BOX;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];
  // as in the dK/dV pass: no divergent branch while a product is in
  // flight; a tile's dQ product is waited for (and its stage released)
  // once the next tile's S and dP are queued. Key column 8j + e (+ 2t)
  // of a tile at k0 is kept below lim_u: before Skv and, causal, at or
  // before query row u.
  const int row0 = qw0 + r_lo - 2 * t;

  sm90::mbar_wait(q_full, 0);
  uint32_t prev = sink;
  for (int kt = 0; kt < n_kt_w; ++kt) {
    const int s = kt % ST, k0 = kt * 64;
    const uint32_t ks = ring + s * C::STAGE, vs = ks + CB * BOX;
    sm90::mbar_wait(full(s), (kt / ST) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {  // S = Q K^T
      const uint32_t off = (k / 4) * BOX + (k % 4) * 32;
      sm90::wgmma_ss_m64n64k16(sc, sm90::desc_sw128(qa + off, 16, 1024),
                               sm90::desc_sw128(ks + off, 16, 1024), k > 0);
    }
    sm90::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {  // dP = dO V^T
      const uint32_t off = (k / 4) * BOX + (k % 4) * 32;
      sm90::wgmma_ss_m64n64k16(dp, sm90::desc_sw128(doa + off, 16, 1024),
                               sm90::desc_sw128(vs + off, 16, 1024), k > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<2>();  // the previous tile's dQ product
    sm90::fence_regs(dqa);
    sm90::mbar_arrive(prev);
    sm90::wgmma_wait<1>();  // S
    sm90::fence_regs(sc);
    const int kv_lim = Skv - k0 - 2 * t;
    const int lim0 = causal ? min(kv_lim, row0 - k0 + 1) : kv_lim;
    const int lim1 = causal ? min(kv_lim, row0 + 8 - k0 + 1) : kv_lim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * u + e;
          const float p = sm90::exp2_ftz(fmaf(sc[x], scale_log2, -l2[u]));
          sc[x] = 8 * j + e < (u ? lim1 : lim0) ? p : 0.f;
        }
      }
    }
    sm90::wgmma_wait<0>();  // dP
    sm90::fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= dp[x] - dl[(x >> 1) & 1];  // dS
    pack_frags<64>(da, sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // dQ += dS K
      wgmma_rs_tb<D>(dqa, da[kc], sm90::desc_sw128(ks + kc * 2048, BOX, 1024));
    sm90::wgmma_commit();
    prev = empty(s);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dqa);
  sm90::mbar_arrive(prev);
  for (int kt = n_kt_w; kt < n_kt; ++kt) {  // past this warpgroup's bound
    const int s = kt % ST;
    sm90::mbar_wait(full(s), (kt / ST) & 1);
    sm90::mbar_arrive(empty(s));
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = qw0 + r_lo + 8 * u;
    if (row >= S) continue;
    const int64_t o = (static_cast<int64_t>(bh) * S + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + o + 8 * j + 2 * t) = pack_bf16(
          dqa[4 * j + 2 * u] * scale, dqa[4 * j + 2 * u + 1] * scale);
  }
}

// float32 elements of the workspace the wgmma path needs
inline int64_t wgmma_workspace(int B, int H, int Hkv, int S, int Skv,
                               int D) {
  const int64_t n_bh = static_cast<int64_t>(B) * H;
  int64_t n = 2 * n_bh * pad64(S);
  if (H != Hkv) n += 2 * n_bh * Skv * D;
  return n;
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the consumers' setmaxnreg.inc waits for registers the pool lacks: a
// kernel built with fewer than 168 a thread would never start, so it is
// refused instead
template <typename K>
cudaError_t pool_fits(K kern) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  return a.numRegs * WG_THREADS >=
                 128 * PRODUCER_REGS + NWG * 128 * CONSUMER_REGS
             ? cudaSuccess
             : cudaErrorInvalidConfiguration;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* ws, void* dq,
                 void* dk, void* dv, int B, int H, int Hkv, int S, int Skv,
                 int causal, float scale, cudaStream_t s) {
  constexpr int BQ = D == 64 ? 64 : 32;
  using T = __nv_bfloat16;
  const int64_t n_bh = static_cast<int64_t>(B) * H;
  const int64_t s_pad = pad64(S);
  const int n_kb = (Skv + 127) / 128, n_qb = (S + 127) / 128;
  if (n_bh * n_kb > INT32_MAX || n_bh * n_qb > INT32_MAX ||
      s_pad > INT32_MAX || (n_bh * s_pad + 7) / 8 > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse2 = ws;
  float* delta = ws + n_bh * s_pad;
  float* pk = delta + n_bh * s_pad;  // partials (G > 1 only)
  float* pv = pk + n_bh * Skv * D;
  const uint64_t nkv = static_cast<uint64_t>(B) * Hkv;
  CUtensorMap mq, mdo, mq64, mdo64, mk, mv;
  int e = sm90::make_map_bf16_3d(&mq, q, D, S, n_bh, BQ);
  if (e == 0) e = sm90::make_map_bf16_3d(&mdo, dout, D, S, n_bh, BQ);
  if (e == 0) e = sm90::make_map_bf16_3d(&mq64, q, D, S, n_bh, 64);
  if (e == 0) e = sm90::make_map_bf16_3d(&mdo64, dout, D, S, n_bh, 64);
  if (e == 0) e = sm90::make_map_bf16_3d(&mk, k, D, Skv, nkv, 64);
  if (e == 0) e = sm90::make_map_bf16_3d(&mv, v, D, Skv, nkv, 64);
  if (e != 0) return e;
  auto kv = dkdv_wgmma_kernel<D, BQ>;
  auto kq = dq_wgmma_kernel<D>;
  cudaError_t ce = allow_smem(kv, Kv<D, BQ>::SMEM);
  if (ce == cudaSuccess) ce = allow_smem(kq, Dq<D>::SMEM);
  if (ce == cudaSuccess) ce = pool_fits(kv);
  if (ce == cudaSuccess) ce = pool_fits(kq);
  if (ce != cudaSuccess) return static_cast<int>(ce);

  const int64_t rows = n_bh * s_pad;
  prep_kernel<D><<<static_cast<int>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, lse2,
      delta, S, s_pad, rows);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const float scale_log2 = scale * LOG2E;
  kv<<<static_cast<int>(n_bh * n_kb), WG_THREADS, Kv<D, BQ>::SMEM, s>>>(
      mq, mk, mv, mdo, lse2, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      pk, pv, H, Hkv, S, Skv, static_cast<int>(s_pad),
      static_cast<int>(n_bh), causal, scale, scale_log2);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (H != Hkv) {
    const int64_t plane4 = static_cast<int64_t>(Skv) * D / 4;
    const int64_t n4 = nkv * plane4;
    const int64_t blocks = (n4 + 255) / 256;
    if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    sum_heads_kernel<<<static_cast<int>(blocks), 256, 0, s>>>(
        reinterpret_cast<const float4*>(pk),
        reinterpret_cast<const float4*>(pv), static_cast<T*>(dk),
        static_cast<T*>(dv), n4, plane4, H / Hkv, scale);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return static_cast<int>(ce);
  }
  kq<<<static_cast<int>(n_bh * n_qb), WG_THREADS, Dq<D>::SMEM, s>>>(
      mq64, mk, mv, mdo64, lse2, delta, static_cast<T*>(dq), H, Hkv, S, Skv,
      static_cast<int>(s_pad), static_cast<int>(n_bh), n_qb, causal, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// delta = rowsum(dO * O) into the first B H S floats of the workspace
template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int64_t rows,
                 int D, cudaStream_t s) {
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<int>(blocks), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return static_cast<int>(cudaGetLastError());
}

// the path of a call, by dtype and head dim: bf16 at D 64 and 128 on
// wgmma, bf16 at D 16 and 32 on mma.sync, float32 on scalar FMAs
template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* ws, int64_t ws_floats,
             void* dq, void* dk, void* dv, int B, int H, int Hkv, int S,
             int Skv, int causal, int dtype, float scale, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  if (dtype == 1) {
    if constexpr (D >= 64) {
      if (ws_floats < wgmma_workspace(B, H, Hkv, S, Skv, D))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_wgmma<D>(q, k, v, o, dout, lse, ws, dq, dk, dv, B, H,
                             Hkv, S, Skv, causal, scale, s);
    } else {
      if (ws_floats < rows) return static_cast<int>(cudaErrorInvalidValue);
      const int e = launch_delta<__nv_bfloat16>(o, dout, ws, rows, D, s);
      if (e != 0) return e;
      return launch_bf16<D, D>(q, k, v, dout, lse, ws, dq, dk, dv, B, H,
                               Hkv, S, Skv, causal, scale, s);
    }
  }
  if (ws_floats < rows) return static_cast<int>(cudaErrorInvalidValue);
  const int e = launch_delta<float>(o, dout, ws, rows, D, s);
  if (e != 0) return e;
  return launch_f32<D>(q, k, v, dout, lse, ws, dq, dk, dv, B, H, Hkv, S,
                       Skv, causal, scale, s);
}

}  // namespace

// q, dq: (B, H, S, D); o, dout: (B, H, S, Dv); k, dk: (B, Hkv, Skv, D);
// v, dv: (B, Hkv, Skv, Dv); lse: float32 (B, H, S); ws: float32 scratch
// of ws_floats elements that the launch fills (bf16 at D = Dv 64 / 128:
// 2 B H S' with S' = S rounded up to 64, and 2 B H Skv D more when H !=
// Hkv; else B H S); all contiguous, one dtype (0 = float32, 1 =
// bfloat16; bf16 pointers 16-byte aligned). (D, Dv) is (d, d) for d in
// {16, 32, 64, 128}, or MLA's (192, 128) in bfloat16; `scale` is the
// forward's.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, int64_t ws_floats,
    void* dq, void* dk, void* dv, int B, int H, int Hkv, int S, int Skv,
    int D, int Dv, int causal, int dtype, float scale, void* stream) {
  if (B < 0 || Hkv <= 0 || H % Hkv || S < 0 || Skv <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mla = D == 192 && Dv == 128;
  if (D != Dv && !(mla && dtype == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 0) {  // no query sees a key: dk = dv = 0, dq is empty
    const size_t n = static_cast<size_t>(B) * Hkv * Skv *
                     (dtype == 1 ? 2 : 4);
    cudaError_t e = cudaMemsetAsync(dk, 0, n * D, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, n * Dv, s);
    return static_cast<int>(e);
  }
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(ws);
  if (mla) {  // MLA's pair on the mma.sync kernels: delta over Dv
    const int64_t rows = static_cast<int64_t>(B) * H * S;
    if (ws_floats < rows) return static_cast<int>(cudaErrorInvalidValue);
    const int e = launch_delta<__nv_bfloat16>(o, dout, w, rows, Dv, s);
    if (e != 0) return e;
    return launch_bf16<192, 128>(q, k, v, dout, l, w, dq, dk, dv, B, H, Hkv,
                                 S, Skv, causal, scale, s);
  }
#define FAB_CASE(DD)                                                         \
  case DD:                                                                   \
    return launch_d<DD>(q, k, v, o, dout, l, w, ws_floats, dq, dk, dv, B, H, \
                        Hkv, S, Skv, causal, dtype, scale, s)
  switch (D) {
    FAB_CASE(16);
    FAB_CASE(32);
    FAB_CASE(64);
    FAB_CASE(128);
#undef FAB_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
