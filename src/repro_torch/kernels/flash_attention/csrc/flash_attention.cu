// Flash-attention forward for Hopper (sm_90a): online softmax over K/V
// tiles, f32 accumulation, causal tile skip, GQA read in place.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash_attention.py:67, pallas_call
// at :79), whose grid walks (BH, q block, kv block) in order with the
// accumulator and running max / denominator in VMEM scratch, and skips
// fully masked causal blocks with pl.when.
//
// Bound: at the prefill shape (B 16, H 32, Hkv 4, S 512, D 64, bf16,
// causal) the function must move q, k, v and out once, ~75.5 MB (22.5 us
// at 3.35 TB/s), against 17.2 GFLOP of causal QK^T and PV (17.4 us at
// 989 TFLOP/s bf16): the bytes set it, but only a kernel that keeps the
// tensor cores busy gets near either.
//
// Design: one block of 128 threads per (64-row Q tile, batch x query
// head); grid (ceil(S / 64), B * H). A loop over 64-row K/V tiles takes
// the place of the TPU's sequential kv grid dimension, up to the causal
// bound: tiles wholly above the diagonal are never loaded (the Pallas
// kernel's pl.when). Query head h reads KV head h / (H / Hkv) directly,
// so the group-expanded K/V is never built. Ragged S and Skv are masked
// at the edge. Masked scores are -1e30 and the row is divided by
// max(l, 1e-30), as in the Pallas kernel.
//
// bfloat16 (the serving path): each warp owns 16 query rows and runs
// QK^T and PV on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate). The Q fragment stays in registers for the whole sweep;
// K and V tiles are staged in shared memory with 16-byte loads. The f32
// score accumulator of QK^T is laid out as the A operand of PV, so P
// never leaves registers: it is rounded to bf16 there, which is the
// Pallas kernel's `p.astype(v_ref.dtype)`. Row max and sum are shared
// by the four lanes of a row with two shuffles.
//
// float32: mma.sync would round the inputs to tf32, so the f32 kernel
// stays on scalar FMAs from shared memory: two threads a query row, each
// scoring 32 of the tile's keys and keeping half of the row's D
// accumulators. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 2 * BQ;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr int smem_bytes() {
  return 3 * BQ * (D + 1) * static_cast<int>(sizeof(float));
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs from shared memory (P needs no rounding)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int H, int Hkv, int S, int Skv, int causal,
                       float scale) {
  constexpr int DP = D + 1;
  constexpr int HALF = D / 2;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * DP;
  float* v_s = k_s + BK * DP;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const float* qb = q + (static_cast<int64_t>(bh) * S + qt * BQ) * D;
  const float* kb = k + static_cast<int64_t>(b * Hkv + hkv) * Skv * D;
  const float* vb = v + static_cast<int64_t>(b * Hkv + hkv) * Skv * D;

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // query row in the tile
  const int half = tid & 1;  // which 32 keys and which D/2 columns
  const int qpos = qt * BQ + r;
  const int q_rows = min(BQ, S - qt * BQ);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i % D;
    q_s[rr * DP + dd] = rr < q_rows ? qb[i] : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) acc[c] = 0.f;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (qt * BQ + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    const int k_rows = min(BK, Skv - kt * BK);
    const float* kt_b = kb + static_cast<int64_t>(kt) * BK * D;
    const float* vt_b = vb + static_cast<int64_t>(kt) * BK * D;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, dd = i % D;
      const bool in = rr < k_rows;
      k_s[rr * DP + dd] = in ? kt_b[i] : 0.f;
      v_s[rr * DP + dd] = in ? vt_b[i] : 0.f;
    }
    __syncthreads();

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    const float* qr = q_s + r * DP;
    const float* kr = k_s + (half * 32) * DP;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = fmaf(qd, kr[j * DP + d], s[j]);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kpos = kt * BK + half * 32 + j;
      const bool ok = kpos < Skv && (!causal || qpos >= kpos);
      s[j] = ok ? s[j] * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < HALF; ++c) acc[c] *= corr;
    // P.V over all 64 keys: the partner's 32 probabilities by shuffle
    const float* v_mine = v_s + (half * 32) * DP + half * HALF;
    const float* v_other = v_s + ((1 - half) * 32) * DP + half * HALF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p_mine = s[j];
      const float p_other = __shfl_xor_sync(0xffffffffu, s[j], 1);
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        acc[c] = fmaf(p_mine, v_mine[j * DP + c], acc[c]);
        acc[c] = fmaf(p_other, v_other[j * DP + c], acc[c]);
      }
    }
  }
  if (r < q_rows) {
    const float den = fmaxf(l, 1e-30f);
    float* o = out + (static_cast<int64_t>(bh) * S + qpos) * D + half * HALF;
#pragma unroll
    for (int c = 0; c < HALF; ++c) o[c] = acc[c] / den;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int S, int Skv, int causal, float scale,
             cudaStream_t s) {
  auto kern = flash_attention_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<D>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, S, Skv,
      causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

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

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * BQ * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// rows [row0, row0 + 64) of a (rows, D) bf16 matrix into shared memory
// with row stride D + 8, zero past `rows`; 16 bytes a thread a step
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int rows) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int H, int Hkv,
                           int S, int Skv, int causal, float scale) {
  constexpr int DS = D + 8;  // shared row stride, in elements
  constexpr int KC = D / 16;  // k-chunks of QK^T
  constexpr int ND = D / 8;   // n-chunks of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * DS;
  __nv_bfloat16* v_s = k_s + BK * DS;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int hkv = h / (H / Hkv);
  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * S * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b * Hkv + hkv) * Skv * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b * Hkv + hkv) * Skv * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's rows in the tile: r0, r0 + 8
  const int qpos0 = qt * BQ + r0, qpos1 = qpos0 + 8;

  load_tile<D>(q_s, qb, qt * BQ, S);
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* a = q_s + r0 * DS + kc * 16 + 2 * t;
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(a);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(a + 8 * DS);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(a + 8 * DS + 8);
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (qt * BQ + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_s, kb, kt * BK, Skv);
    load_tile<D>(v_s, vb, kt * BK, Skv);
    __syncthreads();

    // S = Q K^T: 8 n-chunks of 8 keys; lane holds rows (r0, r0 + 8) x
    // keys (8 nc + 2t, + 1)
    float sc[8][4];
#pragma unroll
    for (int nc = 0; nc < 8; ++nc) {
      sc[nc][0] = sc[nc][1] = sc[nc][2] = sc[nc][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* bp = k_s + (nc * 8 + g) * DS + kc * 16 + 2 * t;
        mma_bf16(sc[nc], qa[kc], *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 8));
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nc = 0; nc < 8; ++nc) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kt * BK + nc * 8 + 2 * t + j;
        const bool in = kpos < Skv;
        sc[nc][j] = (in && (!causal || qpos0 >= kpos)) ? sc[nc][j] * scale
                                                       : NEG_INF;
        sc[nc][2 + j] = (in && (!causal || qpos1 >= kpos))
                            ? sc[nc][2 + j] * scale : NEG_INF;
        mx0 = fmaxf(mx0, sc[nc][j]);
        mx1 = fmaxf(mx1, sc[nc][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nc = 0; nc < 8; ++nc) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[nc][j] = expf(sc[nc][j] - mn0);
        sc[nc][2 + j] = expf(sc[nc][2 + j] - mn1);
        ps0 += sc[nc][j];
        ps1 += sc[nc][2 + j];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }
    // O += P V: P (rounded to bf16) is the A operand, 16 keys a chunk
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
      const __nv_bfloat16* vp = v_s + (kc * 16 + 2 * t) * DS + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* c = vp + n * 8;
        mma_bf16(o[n], pa, pack_bf16(c[0], c[DS]),
                 pack_bf16(c[8 * DS], c[9 * DS]));
      }
    }
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * S * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(qpos0) * D + col) =
          pack_bf16(o[n][0] / d0, o[n][1] / d0);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(ob + static_cast<int64_t>(qpos1) * D + col) =
          pack_bf16(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hkv, int S, int Skv, int causal, float scale,
               cudaStream_t s) {
  auto kern = flash_attention_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, mma_smem_bytes<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H,
      Hkv, S, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int Skv, int D, int causal, float scale,
           int dtype, cudaStream_t s) {
#define FA_CASE(DD)                                                     \
  case DD:                                                              \
    return dtype == 1 ? launch_mma<DD>(q, k, v, out, B, H, Hkv, S, Skv, \
                                       causal, scale, s)                \
                      : launch_d<DD>(q, k, v, out, B, H, Hkv, S, Skv,   \
                                     causal, scale, s)
  switch (D) {
    FA_CASE(16);
    FA_CASE(32);
    FA_CASE(64);
    FA_CASE(128);
#undef FA_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, H, S, D); k, v: (B, Hkv, Skv, D); all contiguous, one
// dtype (0 = float32, 1 = bfloat16). D in {16, 32, 64, 128}; scores
// are scaled by `scale` (the caller's float32 D^-0.5).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Hkv, int S, int Skv, int D,
                                      int causal, int dtype, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out, B, H, Hkv, S, Skv, D, causal, scale, dtype,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
