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
// tensor cores busy and the loads in flight gets near either.
//
// Training: with a non-null `lse` each path also writes the float32
// natural log-sum-exp of every query row's scaled, masked scores,
// (B, H, S), for the backward kernel (flash_attention_bwd.cu); with a
// null `lse` (the serve path) nothing else changes.
//
// Semantics of every path: scores scaled by the caller's float32
// D^-0.5, top-left causal alignment, Skv != S allowed with ragged S and
// Skv masked at the edge, masked scores at -1e30, each row divided by
// max(l, 1e-30). A loop over 64-row K/V tiles takes the place of the
// TPU's sequential kv grid dimension, up to the causal bound: tiles
// wholly above the diagonal are never loaded (the Pallas kernel's
// pl.when). Query head h reads KV head h / (H / Hkv) in place, so the
// group-expanded K/V is never built.
//
// bfloat16, D 64 and 128 (the serving path): persistent,
// warp-specialised blocks, one per resident slot (two an SM at D 64).
// One producer warp issues every load by TMA (cp.async.bulk.tensor,
// 128-byte swizzle): the Q tiles of a work item into one of two Q slots,
// and 64-row K and V tiles into a ring of 4 (D 64) or 3 (D 128) stages
// guarded by full / empty mbarrier pairs, running ahead across items.
// One or two consumer warpgroups each own 64 query rows: S = Q K^T by
// wgmma m64n64k16 with Q and K from shared memory; the online softmax in
// registers with one ex2.approx a score, the scale * log2(e) folded into
// its argument, masking only the diagonal and ragged tiles; P rounded to
// bf16 in registers (the Pallas kernel's `p.astype(v_ref.dtype)`) and
// fed as the register A operand of the PV wgmma, with V's (keys, D)
// row-major tile as the B operand under the transpose bit. The output
// tile goes through the warpgroup's finished Q slot and one TMA store.
// When the group G = H / Hkv is even the two warpgroups of a block take
// two query heads of one KV head at the same q tile, so each K/V tile
// reaches shared memory once for both. Work items run heaviest causal q
// tile first, dealt to the blocks in alternating order so that their
// total work evens out, and the head pairs of one KV head are adjacent,
// so their K/V tiles stay hot in L2. The tensor maps are encoded on the
// host per call (sm90.cuh).
//
// What bounds it at the prefill shape: latency, not a unit's rate. Each
// warpgroup runs QK^T, softmax and PV of a tile back to back; the two
// blocks of an SM overlap four such chains, which the registers (96 a
// thread at two blocks an SM) leave no room to deepen: issuing tile
// j + 1's QK^T with tile j's PV, or overlapping the softmax with the PV
// (FA3's pipelining), needs P, S and O live at once, and at 96 registers
// ptxas serialises the wgmmas and spills; at one block an SM the lost
// occupancy costs more. An FMA-pipe polynomial for part of the
// exponentials (the MUFU unit's rate equals the tensor cores' at D 64)
// made it slower, so the exponential's unit is not the limit either.
//
// bfloat16, D 16 and 32 (the smoke config's heads only): the wgmma
// tiling wants 64-column swizzled boxes, so these keep mma.sync m16n8k16
// per warp of 16 query rows with synchronously staged tiles; P stays in
// registers as PV's A operand.
//
// float32: mma and wgmma would round the inputs to tf32, so the f32
// kernel stays on scalar FMAs from shared memory: two threads a query
// row, each scoring 32 of the tile's keys and keeping half of the row's
// D accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"


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
                       float* __restrict__ lse, int H, int Hkv, int S,
                       int Skv, int causal, float scale) {
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
    if (lse && half == 0)
      lse[static_cast<int64_t>(bh) * S + qpos] = m + logf(l);
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int Hkv, int S, int Skv, int causal,
             float scale, cudaStream_t s) {
  auto kern = flash_attention_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<D>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Hkv,
      S, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16, D 16 and 32: tensor cores (mma.sync m16n8k16)
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
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int H, int Hkv, int S,
                           int Skv, int causal, float scale) {
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
  if (lse && t == 0) {  // m is in scaled units here
    if (qpos0 < S) lse[static_cast<int64_t>(bh) * S + qpos0] = m0 + logf(l0);
    if (qpos1 < S) lse[static_cast<int64_t>(bh) * S + qpos1] = m1 + logf(l1);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int Hkv, int S, int Skv, int causal,
               float scale, cudaStream_t s) {
  auto kern = flash_attention_mma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, mma_smem_bytes<D>(), s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, H, Hkv, S, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16, D 64 and 128: TMA ring, wgmma, one producer warp
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int TILE_BYTES = 64 * 128;  // one (64 rows, 64 bf16) swizzled box

template <int D, int NWG>
struct Wg {
  static constexpr int CB = D / 64;            // 64-column boxes a row
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q_BYTES = NWG * CB * TILE_BYTES;  // two Q slots
  static constexpr int KV_BYTES = 2 * CB * TILE_BYTES;   // a stage: K, V
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 4);
  // + 1024: the dynamic buffer is aligned up to the swizzle atom
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * KV_BYTES + BAR_BYTES;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
};

// Persistent: one block per resident slot walks the n_qt * n_hg work
// items in rounds of gridDim.x, item w being q tile n_qt - 1 - w / n_hg
// (heaviest causal tile first) of head group w % n_hg (NWG query heads
// of one KV head; neighbouring groups share KV heads). The producer runs
// ahead across items: the next item's Q goes to the other of two Q
// slots and its K/V into the same ring while the consumers finish the
// current one, whose output leaves through its own Q slot by TMA store.
template <int D, int NWG>
__global__ void __launch_bounds__(Wg<D, NWG>::THREADS,
                                  Wg<D, NWG>::MIN_BLOCKS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             float* __restrict__ lse, int H, int Hkv, int S,
                             int Skv, int causal, float scale_log2, int n_qt,
                             int n_hg) {
  using C = Wg<D, NWG>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;  // two slots of Q_BYTES
  const uint32_t ring = base + 2 * C::Q_BYTES;
  const uint32_t bars = ring + ST * C::KV_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  auto q_full = [&](int s) { return bars + 8 * (2 * ST + s); };
  auto q_empty = [&](int s) { return bars + 8 * (2 * ST + 2 + s); };
  const int total = n_qt * n_hg;
  const int kv_tiles = (Skv + 63) / 64;
  // this block's r-th item: rounds of gridDim.x items, every other round
  // dealt in reverse, so that the heavy and light causal tiles even out
  auto item = [&](int r) {
    const int b = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return r * static_cast<int>(gridDim.x) + b;
  };
  const int G = H / Hkv;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), NWG * 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(q_empty(s), NWG);  // one arrival a warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      int it = 0, qi = 0;  // K/V tiles and items so far
      for (int r = 0; item(r) < total; ++r, ++qi) {
        const int w = item(r);
        const int qt = n_qt - 1 - w / n_hg;
        const int bh0 = (w % n_hg) * NWG;  // b * H + first query head
        const int bkv = (bh0 / H) * Hkv + (bh0 % H) / G;
        const int n_kt = causal ? min(kv_tiles, qt + 1) : kv_tiles;
        const int qs = qi & 1;
        sm90::mbar_wait(q_empty(qs), ((qi >> 1) & 1) ^ 1);
        sm90::mbar_arrive_tx(q_full(qs), C::Q_BYTES);
        for (int h = 0; h < NWG; ++h)
          for (int c = 0; c < C::CB; ++c)
            sm90::tma_load_3d(q_s + qs * C::Q_BYTES +
                                  (h * C::CB + c) * TILE_BYTES,
                              &tq, q_full(qs), c * 64, qt * 64, bh0 + h);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % ST;
          sm90::mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          sm90::mbar_arrive_tx(full(s), C::KV_BYTES);
          const uint32_t st = ring + s * C::KV_BYTES;
          for (int c = 0; c < C::CB; ++c) {
            sm90::tma_load_3d(st + c * TILE_BYTES, &tk, full(s), c * 64,
                              kt * 64, bkv);
            sm90::tma_load_3d(st + (C::CB + c) * TILE_BYTES, &tv, full(s),
                              c * 64, kt * 64, bkv);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows of query head bh0 + wg of each item
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  int it = 0, qi = 0;
  for (int r = 0; item(r) < total; ++r, ++qi) {
    const int w = item(r);
    const int qt = n_qt - 1 - w / n_hg;
    const int bh0 = (w % n_hg) * NWG;
    const int n_kt = causal ? min(kv_tiles, qt + 1) : kv_tiles;
    const int qpos0 = qt * 64 + (warp & 3) * 16 + g, qpos1 = qpos0 + 8;
    const int qs = qi & 1;
    const uint32_t qa = q_s + qs * C::Q_BYTES + wg * C::CB * TILE_BYTES;

    // running max in raw score units (the scale is folded into exp2)
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // S = Q K^T, 64 x 64: sc[4j + 2u + e] is (row g + 8u, key 8j + 2t + e)
    float sc[32];
    uint32_t pa[4][4];  // P as the A fragments of PV's four key chunks

    // issue S = Q K^T for the K tile at `st` (not committed)
    auto issue_s = [&](uint32_t st) {
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const uint32_t off = (k / 4) * TILE_BYTES + (k % 4) * 32;
        sm90::wgmma_ss_m64n64k16(sc, sm90::desc_sw128(qa + off, 16, 1024),
                                 sm90::desc_sw128(st + off, 16, 1024), k > 0);
      }
    };
    // issue O += P V for the V tile of the stage at `st`: (keys, D) is
    // the MN-major B operand; 16 keys a step are 2 KB of the swizzled
    // tile, the second 64 columns 8 KB on
    auto issue_pv = [&](uint32_t st) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint64_t dv = sm90::desc_sw128(
            st + C::CB * TILE_BYTES + kc * 2048, TILE_BYTES, 1024);
        if constexpr (D == 64)
          sm90::wgmma_rs_m64n64k16_tb(o, pa[kc], dv);
        else
          sm90::wgmma_rs_m64n128k16_tb(o, pa[kc], dv);
      }
    };
    // tile kt's softmax on sc, in place: masked scores, the new running
    // max, P = 2^(scale_log2 (s - m)) and l; returns the rescale factors
    // of the rows' earlier sums in corr0, corr1
    float corr0, corr1;
    auto softmax = [&](int kt) {
      const int k0 = kt * 64;
      if (k0 + 64 > Skv || (causal && k0 + 63 > qt * 64)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + e;
            if (kpos >= Skv || (causal && kpos > qpos0))
              sc[4 * j + e] = NEG_INF;
            if (kpos >= Skv || (causal && kpos > qpos1))
              sc[4 * j + 2 + e] = NEG_INF;
          }
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      corr0 = sm90::exp2_ftz((m0 - mn0) * scale_log2);
      corr1 = sm90::exp2_ftz((m1 - mn1) * scale_log2);
      const float b0 = -mn0 * scale_log2, b1 = -mn1 * scale_log2;
      m0 = mn0;
      m1 = mn1;
      // l stays a per-lane partial sum (corr is the same on the row's
      // four lanes); the lanes are summed once, after the sweep
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(sc[4 * j + e], scale_log2, e < 2 ? b0 : b1);
          sc[4 * j + e] = sm90::exp2_ftz(x);
        }
        l0 += sc[4 * j] + sc[4 * j + 1];
        l1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
    };
    // O *= corr, then P rounded to bf16 into PV's A fragments: key chunk
    // j / 2, rows g, g + 8 by keys 2t, 2t + 8
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };
    auto stage = [&](int kt) { return (it + kt) % ST; };
    auto parity = [&](int kt) { return ((it + kt) / ST) & 1; };

    sm90::mbar_wait(q_full(qs), (qi >> 1) & 1);
    for (int kt = 0; kt < n_kt; ++kt) {
      const uint32_t st = ring + stage(kt) * C::KV_BYTES;
      sm90::mbar_wait(full(stage(kt)), parity(kt));
      sm90::wgmma_fence();
      issue_s(st);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax(kt);
      rescale_and_pack();
      sm90::wgmma_fence();
      issue_pv(st);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty(stage(kt)));  // warp done
    }
    it += n_kt;

    // O / l, rounded to bf16, into this warpgroup's (now free) part of
    // the Q slot in the swizzled layout of the output map, then out by
    // one TMA store (rows past S are not written)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (lse && t == 0) {  // P was 2^((s - m) scale_log2): lse in base e
      float* lr = lse + static_cast<int64_t>(bh0 + wg) * S;
      if (qpos0 < S) lr[qpos0] = (m0 * scale_log2 + log2f(l0)) * LN2;
      if (qpos1 < S) lr[qpos1] = (m1 * scale_log2 + log2f(l1)) * LN2;
    }
    const int r0 = (warp & 3) * 16 + g;  // rows r0, r0 + 8 of the tile
    unsigned char* qtile = smem_raw + (qa - sm90::smem_addr(smem_raw));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      // 16-byte chunk j % 8 of a 128-byte row, XOR-swizzled by row % 8
      unsigned char* cb = qtile + (j / 8) * TILE_BYTES + 4 * t;
      const int ch0 = ((j % 8) ^ (r0 % 8)) * 16;
      *reinterpret_cast<uint32_t*>(cb + r0 * 128 + ch0) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      *reinterpret_cast<uint32_t*>(cb + (r0 + 8) * 128 + ch0) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
    sm90::fence_async_smem();
    sm90::named_barrier(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int c = 0; c < C::CB; ++c)
        sm90::tma_store_3d(&to, qa + c * TILE_BYTES, c * 64, qt * 64,
                           bh0 + wg);
      sm90::tma_store_commit();
      sm90::tma_store_wait_read();
      sm90::mbar_arrive(q_empty(qs));  // this warpgroup is done with it
    }
  }
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int Hkv, int S, int Skv,
                 int causal, float scale, cudaStream_t s) {
  using C = Wg<D, NWG>;
  CUtensorMap mq, mk, mv, mo;
  int e = sm90::make_map_bf16_3d(&mq, q, D, S, static_cast<uint64_t>(B) * H,
                                 64);
  if (e == 0)
    e = sm90::make_map_bf16_3d(&mo, out, D, S, static_cast<uint64_t>(B) * H,
                               64);
  if (e == 0)
    e = sm90::make_map_bf16_3d(&mk, k, D, Skv,
                               static_cast<uint64_t>(B) * Hkv, 64);
  if (e == 0)
    e = sm90::make_map_bf16_3d(&mv, v, D, Skv,
                               static_cast<uint64_t>(B) * Hkv, 64);
  if (e != 0) return e;
  auto kern = flash_attention_wgmma_kernel<D, NWG>;
  // per device: the opt-in to the shared memory and the resident blocks
  static int slots[64] = {0};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (slots[dev] == 0) {
    ce = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    int sms = 0, per_sm = 0;
    if (ce == cudaSuccess)
      ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (ce == cudaSuccess)
      ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         C::THREADS, C::SMEM);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    slots[dev] = sms * per_sm;
  }
  const int n_qt = (S + 63) / 64;
  const int n_hg = B * H / NWG;
  const int64_t total = static_cast<int64_t>(n_qt) * n_hg;
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(
      total < slots[dev] ? total : static_cast<int64_t>(slots[dev]));
  kern<<<blocks, C::THREADS, C::SMEM, s>>>(mq, mk, mv, mo, lse, H, Hkv, S,
                                           Skv, causal, scale * LOG2E, n_qt,
                                           n_hg);
  return static_cast<int>(cudaGetLastError());
}

// D 64 and 128 on wgmma, two query heads a block when the group is
// even, else one; D 16 and 32 on mma.sync
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int H, int Hkv, int S, int Skv,
                int causal, float scale, cudaStream_t s) {
  if constexpr (D < 64) {
    return launch_mma<D>(q, k, v, out, lse, B, H, Hkv, S, Skv, causal, scale,
                         s);
  } else {
    if ((H / Hkv) % 2 == 0)
      return launch_wgmma<D, 2>(q, k, v, out, lse, B, H, Hkv, S, Skv, causal,
                                scale, s);
    return launch_wgmma<D, 1>(q, k, v, out, lse, B, H, Hkv, S, Skv, causal,
                              scale, s);
  }
}

int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Hkv, int S, int Skv, int D,
           int causal, float scale, int dtype, cudaStream_t s) {
#define FA_CASE(DD)                                                       \
  case DD:                                                                \
    return dtype == 1 ? launch_bf16<DD>(q, k, v, out, lse, B, H, Hkv, S,  \
                                        Skv, causal, scale, s)            \
                      : launch_d<DD>(q, k, v, out, lse, B, H, Hkv, S, Skv, \
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
// are scaled by `scale` (the caller's float32 D^-0.5). lse: null, or a
// float32 (B, H, S) that receives each row's log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int Hkv, int S, int Skv,
                                      int D, int causal, int dtype,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, out, static_cast<float*>(lse), B, H, Hkv, S, Skv,
                D, causal, scale, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
