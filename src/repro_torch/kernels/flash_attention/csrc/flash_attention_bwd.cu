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
// Three kernels, one launch entry, no atomics (each output element is
// written once by one thread, its sums in a fixed order, so a run's
// gradients are the same in every run, which a bit-exact crash restart
// needs):
//   1. delta = rowsum(dO * O) in float32, one warp a row;
//   2. dK, dV: one block per (b, KV head, 64-key tile), looping over the
//      group's G query heads and over the 32-query tiles that can see
//      the keys; P = exp(s * scale - lse) and dS = P (dP - delta) are
//      recomputed, and dV += P^T dO, dK += dS^T Q accumulate in
//      registers, so the group's heads are summed inside the kernel and
//      dK, dV land at (B, Hkv, Skv, D) directly;
//   3. dQ: one block per (b, head, 64-query tile), looping over the
//      32-key tiles up to the causal bound; dQ += dS K.
//
// Bound: at tinyllama-1.1b's shape (B 2, H 32, Hkv 4, S 4,096, D 64,
// bf16, causal) the function must read q, k, v, O, dO and write dq, dk,
// dv (~134 MB, 40 us at 3.35 TB/s) and do 5 matrix products over the
// causal pairs (S = QK^T, dP = dO V^T, dV, dK, dQ: 10 D flops a pair,
// 344 GFLOP, 348 us at 989 TFLOP/s): operations bound it. This design
// recomputes S and dP in both passes (14 D flops a pair) and runs its
// products on mma.sync m16n8k16 (bf16 in, float32 accumulate) with
// synchronously staged tiles; P and dS are rounded to bf16 as the A
// operands of the dV / dK / dQ products, as FlashAttention-2 does.
// `wgmma` and TMA, as in the forward, are later work.
//
// float32: mma would round the inputs to tf32, so the float32 kernels
// stay on scalar FMAs from shared memory (32-key and 32-query tiles,
// four threads a row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int D>
constexpr int mma_smem_bytes() {
  return (2 * KT + 2 * QT) * (D + 8) *
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

template <int D>
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
  constexpr int DS = D + 8, KC = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + KT * DS;
  __nv_bfloat16* q_s = v_s + KT * DS;
  __nv_bfloat16* do_s = q_s + QT * DS;
  float* lse_s = reinterpret_cast<float*>(do_s + QT * DS);
  float* dl_s = lse_s + QT;

  const int kt = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv % Hkv, G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's keys: r0, r0 + 8
  const int kpos0 = kt * KT + r0, kpos1 = kpos0 + 8;
  stage_bf16<D, KT>(k_s, k + static_cast<int64_t>(bkv) * Skv * D, kt * KT,
                    Skv);
  stage_bf16<D, KT>(v_s, v + static_cast<int64_t>(bkv) * Skv * D, kt * KT,
                    Skv);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_qt = (S + QT - 1) / QT;
  const int q0 = causal ? kt * KT / QT : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int bh = b * H + hkv * G + gi;
    for (int qt = q0; qt < n_qt; ++qt) {
      __syncthreads();  // the previous tile is consumed (and K, V staged)
      stage_bf16<D, QT>(q_s, q + static_cast<int64_t>(bh) * S * D, qt * QT,
                        S);
      stage_bf16<D, QT>(do_s, dout + static_cast<int64_t>(bh) * S * D,
                        qt * QT, S);
      if (threadIdx.x < QT) {
        const int qp = qt * QT + threadIdx.x;
        lse_s[threadIdx.x] = qp < S ? lse[static_cast<int64_t>(bh) * S + qp]
                                    : 0.f;
        dl_s[threadIdx.x] = qp < S ? delta[static_cast<int64_t>(bh) * S + qp]
                                   : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int nc = 0; nc < 4; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nc][e] = dpt[nc][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        frag_a<DS>(ka, k_s, r0, kc * 16, t);
        frag_a<DS>(va, v_s, r0, kc * 16, t);
#pragma unroll
        for (int nc = 0; nc < 4; ++nc) {
          const __nv_bfloat16* qp = q_s + (nc * 8 + g) * DS + kc * 16 + 2 * t;
          const __nv_bfloat16* dp = do_s + (nc * 8 + g) * DS + kc * 16 + 2 * t;
          mma_bf16(st[nc], ka, ld32(qp), ld32(qp + 8));
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
      mma_pv<D>(dva, pa, do_s, g, t);   // dV += P^T dO
      pack_a(pa, dpt);
      mma_pv<D>(dka, pa, q_s, g, t);    // dK += dS^T Q
    }
  }
  const int64_t base = static_cast<int64_t>(bkv) * Skv;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (kpos0 < Skv) {
      const int64_t o = (base + kpos0) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][0], dva[n][1]);
    }
    if (kpos1 < Skv) {
      const int64_t o = (base + kpos1) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S, int Skv,
              int causal, float scale) {
  constexpr int DS = D + 8, KC = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + KT * DS;
  __nv_bfloat16* k_s = do_s + KT * DS;
  __nv_bfloat16* v_s = k_s + QT * DS;

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's queries: r0, r0 + 8
  const int qpos0 = qt * KT + r0, qpos1 = qpos0 + 8;
  stage_bf16<D, KT>(q_s, q + static_cast<int64_t>(bh) * S * D, qt * KT, S);
  stage_bf16<D, KT>(do_s, dout + static_cast<int64_t>(bh) * S * D, qt * KT,
                    S);
  const int64_t rb = static_cast<int64_t>(bh) * S;
  const float lse0 = qpos0 < S ? lse[rb + qpos0] : 0.f;
  const float lse1 = qpos1 < S ? lse[rb + qpos1] : 0.f;
  const float dl0 = qpos0 < S ? delta[rb + qpos0] : 0.f;
  const float dl1 = qpos1 < S ? delta[rb + qpos1] : 0.f;
  __syncthreads();
  uint32_t qa[KC][4], da[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    frag_a<DS>(qa[kc], q_s, r0, kc * 16, t);
    frag_a<DS>(da[kc], do_s, r0, kc * 16, t);
  }
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int n_kt = (Skv + QT - 1) / QT;
  if (causal) n_kt = min(n_kt, (qt * KT + KT - 1) / QT + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile is consumed
    stage_bf16<D, QT>(k_s, k + static_cast<int64_t>(bkv) * Skv * D,
                      kt * QT, Skv);
    stage_bf16<D, QT>(v_s, v + static_cast<int64_t>(bkv) * Skv * D,
                      kt * QT, Skv);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: 16 queries x 32 keys a warp
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int nc = 0; nc < 4; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nc][e] = dp[nc][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int nc = 0; nc < 4; ++nc) {
        const __nv_bfloat16* kp = k_s + (nc * 8 + g) * DS + kc * 16 + 2 * t;
        const __nv_bfloat16* vp = v_s + (nc * 8 + g) * DS + kc * 16 + 2 * t;
        mma_bf16(sc[nc], qa[kc], ld32(kp), ld32(kp + 8));
        mma_bf16(dp[nc], da[kc], ld32(vp), ld32(vp + 8));
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
    mma_pv<D>(dqa, pa, k_s, g, t);  // dQ += dS K
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(dq + (rb + qpos0) * D + col) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(dq + (rb + qpos1) * D + col) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int B, int H, int Hkv, int S,
                int Skv, int causal, float scale, cudaStream_t s) {
  constexpr int SM = mma_smem_bytes<D>();
  auto kv = dkdv_mma_kernel<D>;
  auto kq = dq_mma_kernel<D>;
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

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int S, int Skv,
             int causal, int dtype, float scale, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(B) * H * S;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    delta_kernel<__nv_bfloat16><<<static_cast<int>(blocks), 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, rows, D);
  } else {
    delta_kernel<float><<<static_cast<int>(blocks), 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        rows, D);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                          S, Skv, causal, scale, s);
  return launch_f32<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, S,
                       Skv, causal, scale, s);
}

}  // namespace

// q, o, dout, dq: (B, H, S, D); k, v, dk, dv: (B, Hkv, Skv, D); lse,
// delta: float32 (B, H, S) (delta is scratch the launch fills); all
// contiguous, one dtype (0 = float32, 1 = bfloat16; bf16 pointers
// 16-byte aligned). D in {16, 32, 64, 128}; `scale` is the forward's.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int S, int Skv, int D, int causal,
    int dtype, float scale, void* stream) {
  if (B < 0 || Hkv <= 0 || H % Hkv || S < 0 || Skv <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 0) {  // no query sees a key: dk = dv = 0, dq is empty
    const size_t n = static_cast<size_t>(B) * Hkv * Skv * D *
                     (dtype == 1 ? 2 : 4);
    cudaError_t e = cudaMemsetAsync(dk, 0, n, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, n, s);
    return static_cast<int>(e);
  }
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FAB_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch_d<DD>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Hkv, S, \
                        Skv, causal, dtype, scale, s)
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
