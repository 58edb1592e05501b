// Flash-decode for Hopper (sm_90a): one query token per sequence against
// a (B, S, Hkv, D) KV cache, GQA kept grouped, split-K over S, one
// launch a call.
//
// Replaces the Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_decode/flash_decode.py:60, pallas_call at
// :76), whose grid (B * Hkv, kv block) carries a (G, D) query group per
// KV head through a sequential sweep of the cache, masks kpos > pos and
// skips blocks past pos.
//
// Bound: bytes. The cache rows up to pos are read once for all G query
// heads of their KV head: at B 16, Hkv 4, D 64, pos 543 in bf16 that is
// ~8.9 MB, ~2.7 us at 3.35 TB/s. The arithmetic (4 * G * D per key) is
// far below the card's rate, so the design is about bytes in flight and
// a short dependency chain, and about the host: one launch, no scratch
// allocated per call.
//
// Split plan (the wrapper's `split_plan`): the cache rows 0..pos are cut
// into 64-row tiles, and each (batch, KV head) pair gets up to
// 1,056 / (B * Hkv) splits of whole tiles (8 blocks of 128 threads an SM
// on 132 SMs), at most 128; at the decode shape that is 9 splits of one
// tile, 576 blocks, all resident at once. Grid (splits, B * Hkv). (3
// splits of 3 tiles and 5 of 2 measured within a few percent of it.)
//
// A block of 4 warps walks its tiles with a two-stage cp.async ring:
// every thread copies 16-byte vectors of K and V rows into padded
// shared rows (conflict-free ldmatrix), so a block has its next 16 KB
// (bf16, D 64) in flight while it scores the current tile. Rows past pos
// are never read (the copy zero-fills them) and are masked. Each warp
// takes 16 rows of a tile and keeps its own online-softmax state for the
// G query heads, once per 16-key slice: slice max, exp2f of the scores
// prescaled by scale * log2(e), slice sum, one rescale of the
// accumulator.
//
// bfloat16 (the serving path), on the tensor cores with mma.sync
// m16n8k16: S^T (16 keys x 8 heads) = K (16 keys x 16 d, by ldmatrix)
// times Q^T (16 d x 8 heads, in registers for the whole sweep; heads
// past G are zero); P is rounded to bf16 (the Pallas kernel's
// `p.astype(v.dtype)`), staged as a 256-byte (keys, heads) tile per warp
// and read back transposed by ldmatrix.trans as the B operand of
// O^T (D x 8 heads) += V^T (by ldmatrix.trans) . P^T. wgmma's 64-row
// minimum does not fit 8 heads, and the work is byte-bound.
//
// float32, on CUDA cores (mma would round to tf32): a lane scores one
// key of the slice for 4 of the 8 heads from shared memory (no per-key
// warp reduction), P goes through shared memory, and a lane accumulates
// D / 32 columns of all 8 heads.
//
// Combine in the same launch: the four warps merge in shared memory;
// with one split the block writes `out`; otherwise it writes its
// (m, l, acc) partial to the caller's float32 workspace, and the last
// block of its (batch, KV head), found by an atomic ticket, merges the
// splits, divides by max(l, 1e-30), writes `out` and resets the ticket
// to 0 for the next call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // cache rows a tile
constexpr int WARPS = 4;  // 16 rows of a tile each
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;
constexpr int STAGES = 2;
constexpr int MAX_SPLITS = 128;  // splits of one (batch, KV head)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct Dec {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int ROW = D + 16 / static_cast<int>(sizeof(T));  // +16 B
  static constexpr int VPR = D * static_cast<int>(sizeof(T)) / 16;  // vectors
  static constexpr int TILE_BYTES = TILE * ROW * static_cast<int>(sizeof(T));
  static constexpr int RING_BYTES = STAGES * 2 * TILE_BYTES;  // K, V
  static constexpr int Q_BYTES = BF16 ? 0 : MAX_G * D * 4;
  static constexpr int P_BYTES = WARPS * 16 * MAX_G * static_cast<int>(sizeof(T));
  static constexpr int SMEM = RING_BYTES + Q_BYTES + P_BYTES;
  // the warps' merge reuses the ring: (m, l, acc) of every warp
  static_assert(WARPS * MAX_G * (D + 2) * 4 <= RING_BYTES, "merge scratch");
  // and the last block's weights of up to MAX_SPLITS splits
  static_assert((2 * MAX_SPLITS + 1) * MAX_G * 4 <= RING_BYTES, "weights");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// issue the copies of tile rows [row0, row0 + 64) of one (b, kv head)
// into ring stage `st`; rows past `last` are zero-filled, never read
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint32_t st, const T* kbase,
                                          const T* vbase, int64_t row_stride,
                                          int row0, int last) {
  using C = Dec<T, D>;
  for (int i = threadIdx.x; i < TILE * C::VPR; i += THREADS) {
    const int r = i / C::VPR, c = i % C::VPR;
    const bool ok = row0 + r <= last;
    const int64_t off =
        ok ? (row0 + r) * row_stride + c * (16 / static_cast<int>(sizeof(T)))
           : 0;
    const uint32_t dst = st + r * C::ROW * static_cast<int>(sizeof(T)) + c * 16;
    cp_async16(dst, kbase + off, ok);
    cp_async16(dst + C::TILE_BYTES, vbase + off, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, int S, int Hkv, int G, int pos,
                    float scale_log2, int tiles_per_split,
                    float* __restrict__ ws, int* __restrict__ tickets,
                    T* __restrict__ out) {
  using C = Dec<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  float* q_s = reinterpret_cast<float*>(smem + C::RING_BYTES);  // f32 only
  unsigned char* p_raw = smem + C::RING_BYTES + C::Q_BYTES;
  __shared__ int is_last;

  const int sp = blockIdx.x, n_split = gridDim.x;
  const int bk = blockIdx.y;  // b * Hkv + kv head
  const int b = bk / Hkv, hk = bk % Hkv;
  const int H = Hkv * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = pos / TILE + 1;
  const int t0 = sp * tiles_per_split;
  const int nt = min(t0 + tiles_per_split, n_tiles) - t0;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * D;
  const T* kbase = kc + (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const T* vbase = vc + (static_cast<int64_t>(b) * S * Hkv + hk) * D;
  const T* qg = q + (static_cast<int64_t>(b) * H + hk * G) * D;

  // two tiles in flight before the first is scored
  load_tile<T, D>(ring, kbase, vbase, row_stride, t0 * TILE, pos);
  cp_async_commit();
  if (nt > 1)
    load_tile<T, D>(ring + 2 * C::TILE_BYTES, kbase, vbase, row_stride,
                    (t0 + 1) * TILE, pos);
  cp_async_commit();

  // per warp: m and l of the 8 heads, the accumulator
  float m[MAX_G], l[MAX_G];
#pragma unroll
  for (int h = 0; h < MAX_G; ++h) m[h] = NEG_INF, l[h] = 0.f;

  // bf16: lane (g, c) = (lane / 4, lane % 4); O^T[d][head] in o[mt]:
  // (16 mt + g + 8 u, 2c + e) at o[mt][2u + e]
  const int g = lane >> 2, c = lane & 3;
  constexpr int MT = D / 16;
  float o[C::BF16 ? MT : 1][4];
  uint32_t qb[C::BF16 ? MT : 1][2];
  // f32: lane (kk, hh) = (lane % 16, lane / 16) scores key kk for heads
  // 4 hh .. 4 hh + 3, and accumulates columns lane + 32 i of all heads
  constexpr int DPL = (D + 31) / 32;
  float acc[C::BF16 ? 1 : MAX_G][DPL];
  const int kk = lane & 15, hh = lane >> 4;

  if constexpr (C::BF16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(qg + g * D);
      qb[mt][0] = g < G ? qr[(16 * mt + 2 * c) / 2] : 0u;
      qb[mt][1] = g < G ? qr[(16 * mt + 8 + 2 * c) / 2] : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < MAX_G * D; i += THREADS)
      q_s[i] = i / D < G ? qg[i] : 0.f;  // float32 only
#pragma unroll
    for (int h = 0; h < MAX_G; ++h)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[h][i] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    const uint32_t kt_s = ring + (it % STAGES) * 2 * C::TILE_BYTES;
    const uint32_t vt_s = kt_s + C::TILE_BYTES;
    const int key0 = (t0 + it) * TILE + 16 * warp;  // this warp's slice

    if constexpr (C::BF16) {
      // S^T: sc[2u + e] is (key g + 8u, head 2c + e)
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc2 = 0; kc2 < MT; ++kc2) {
        const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int col = 16 * kc2 + 8 * (lane >> 4);
        uint32_t a[4];
        ldsm_x4(a, kt_s + (r * C::ROW + col) * 2);
        mma_bf16(sc, a, qb[kc2][0], qb[kc2][1]);
      }
      float x[4], mx[2];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x[2 * u + e] = key0 + g + 8 * u <= pos ? sc[2 * u + e] * scale_log2
                                                 : NEG_INF;
      mx[0] = fmaxf(x[0], x[2]);
      mx[1] = fmaxf(x[1], x[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
      }
      // this lane's heads 2c, 2c + 1 live in m[0], m[1] (l likewise; a
      // per-lane partial sum over its keys, summed over g at the end)
      float corr[2], p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mn = fmaxf(m[e], mx[e]);
        corr[e] = exp2f(m[e] - mn);
        m[e] = mn;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = x[i] > NEG_INF ? exp2f(x[i] - m[i & 1]) : 0.f;
      l[0] = l[0] * corr[0] + p[0] + p[2];
      l[1] = l[1] * corr[1] + p[1] + p[3];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        o[mt][0] *= corr[0];
        o[mt][2] *= corr[0];
        o[mt][1] *= corr[1];
        o[mt][3] *= corr[1];
      }
      // P (16 keys x 8 heads, bf16) through this warp's 256 bytes, read
      // back transposed as the B operand of O^T += V^T P^T
      uint32_t* pw = reinterpret_cast<uint32_t*>(p_raw + warp * 256);
      __syncwarp();
      pw[g * 4 + c] = pack_bf16(p[0], p[1]);
      pw[(g + 8) * 4 + c] = pack_bf16(p[2], p[3]);
      __syncwarp();
      uint32_t b0, b1;
      ldsm_x2_t(b0, b1, smem_addr(pw) + (lane & 15) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = 16 * warp + (lane & 7) + 8 * (lane >> 4);
        const int col = 16 * mt + 8 * ((lane >> 3) & 1);
        uint32_t a[4];
        ldsm_x4_t(a, vt_s + (r * C::ROW + col) * 2);
        mma_bf16(o[mt], a, b0, b1);
      }
    } else {
      const float* krow = reinterpret_cast<const float*>(smem + (kt_s - ring)) +
                          (16 * warp + kk) * C::ROW;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + (4 * hh + j) * D + d);
          s[j] = fmaf(kv.x, qv.x, s[j]);
          s[j] = fmaf(kv.y, qv.y, s[j]);
          s[j] = fmaf(kv.z, qv.z, s[j]);
          s[j] = fmaf(kv.w, qv.w, s[j]);
        }
      }
      const bool ok = key0 + kk <= pos;
      float mx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = ok ? s[j] * scale_log2 : NEG_INF;
        mx[j] = s[j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
      // every lane keeps m of all 8 heads; l[j] is this lane's partial
      // sum for head 4 hh + j
      float corr[MAX_G], mine_m[4], mine_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float other = __shfl_xor_sync(0xffffffffu, mx[j], 16);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = 4 * half + j;
          const float mn = fmaxf(m[h], half == hh ? mx[j] : other);
          corr[h] = exp2f(m[h] - mn);
          m[h] = mn;
        }
        mine_m[j] = hh ? m[4 + j] : m[j];
        mine_c[j] = hh ? corr[4 + j] : corr[j];
      }
      float* pw = reinterpret_cast<float*>(p_raw) + warp * 16 * MAX_G;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok ? exp2f(s[j] - mine_m[j]) : 0.f;
        l[j] = l[j] * mine_c[j] + pj;
        pw[kk * MAX_G + 4 * hh + j] = pj;
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < MAX_G; ++h)
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] *= corr[h];
      const float* vrow = reinterpret_cast<const float*>(smem + (vt_s - ring)) +
                          16 * warp * C::ROW;
#pragma unroll 4
      for (int r = 0; r < 16; ++r) {
        const float4 p0 = *reinterpret_cast<const float4*>(pw + r * MAX_G);
        const float4 p1 = *reinterpret_cast<const float4*>(pw + r * MAX_G + 4);
        const float pr[MAX_G] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          const float v = d < D ? vrow[r * C::ROW + d] : 0.f;
#pragma unroll
          for (int h = 0; h < MAX_G; ++h) acc[h][i] = fmaf(pr[h], v, acc[h][i]);
        }
      }
    }

    __syncthreads();  // the stage is consumed
    if (it + 2 < nt)
      load_tile<T, D>(kt_s, kbase, vbase, row_stride, (t0 + it + 2) * TILE,
                      pos);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states into the (now free) ring, as float32
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + WARPS * MAX_G;
  float* wo = wl + WARPS * MAX_G;  // [warp][head][D]
  if constexpr (C::BF16) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[e] += __shfl_xor_sync(0xffffffffu, l[e], off);
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        wm[warp * MAX_G + 2 * c + e] = m[e];
        wl[warp * MAX_G + 2 * c + e] = l[e];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wo[(warp * MAX_G + 2 * c + e) * D + 16 * mt + g + 8 * u] =
              o[mt][2 * u + e];
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < MAX_G; ++h) wm[warp * MAX_G + h] = m[h];
    }
    if (kk == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wl[warp * MAX_G + 4 * hh + j] = l[j];
    }
#pragma unroll
    for (int h = 0; h < MAX_G; ++h)
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) wo[(warp * MAX_G + h) * D + d] = acc[h][i];
      }
  }
  __syncthreads();

  // the block's (m, l, acc) for head h < G, column d
  float* part_m = ws;
  float* part_l = ws + static_cast<int64_t>(gridDim.y) * n_split * MAX_G;
  float* part_acc = part_l + static_cast<int64_t>(gridDim.y) * n_split * MAX_G;
  T* ob = out + (static_cast<int64_t>(b) * H + hk * G) * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * MAX_G + h]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(wm[w * MAX_G + h] - M);
      L += wl[w * MAX_G + h] * f;
      A += wo[(w * MAX_G + h) * D + d] * f;
    }
    if (n_split == 1) {
      ob[i] = from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      const int64_t pr = static_cast<int64_t>(bk) * n_split + sp;
      part_acc[(pr * MAX_G + h) * D + d] = A;
      if (d == 0) {
        part_m[pr * MAX_G + h] = M;
        part_l[pr * MAX_G + h] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (b, kv head) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(tickets + bk, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the splits' m and l into shared memory, all loads in flight at once;
  // then, per head, each split's weight exp2(m_s - M) and L
  const int64_t p0 = static_cast<int64_t>(bk) * n_split;
  float* sw = reinterpret_cast<float*>(smem);  // [split][head]
  float* sl = sw + n_split * MAX_G;             // [split][head]
  float* sL = sl + n_split * MAX_G;             // [head]
  for (int i = threadIdx.x; i < n_split * MAX_G; i += THREADS) {
    sw[i] = __ldcg(part_m + p0 * MAX_G + i);
    sl[i] = __ldcg(part_l + p0 * MAX_G + i);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, sw[s * MAX_G + h]);
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = exp2f(sw[s * MAX_G + h] - M);
      sw[s * MAX_G + h] = f;
      L += sl[s * MAX_G + h] * f;
    }
    sL[h] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int h = i / D, d = i % D;
    const float* pa = part_acc + (p0 * MAX_G + h) * D + d;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      A += __ldcg(pa + static_cast<int64_t>(s) * MAX_G * D) * sw[s * MAX_G + h];
    ob[i] = from_f<T>(A / sL[h]);
  }
  if (threadIdx.x == 0) tickets[bk] = 0;
}

template <typename T, int D>
int launch_d(const void* q, const void* kc, const void* vc, int B, int S,
             int Hkv, int G, int pos, float scale, int n_split, int tps,
             void* ws, void* tickets, void* out, cudaStream_t s) {
  using C = Dec<T, D>;
  auto kern = flash_decode_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(n_split, B * Hkv), THREADS, C::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), S, Hkv, G, pos, scale * LOG2E, tps,
      static_cast<float*>(ws), static_cast<int*>(tickets),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, int B, int S,
           int Hkv, int G, int D, int pos, float scale, int n_split, int tps,
           void* ws, void* tickets, void* out, cudaStream_t s) {
#define FD_CASE(DD)                                                       \
  case DD:                                                                \
    return launch_d<T, DD>(q, kc, vc, B, S, Hkv, G, pos, scale, n_split, \
                           tps, ws, tickets, out, s)
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
// The rows 0..pos are cut into n_split <= 128 splits of tiles_per_split
// 64-row tiles, none empty. With n_split > 1: ws holds B * Hkv * n_split
// * 8 * (D + 2) floats, tickets B * Hkv ints, all 0 on entry (each call
// leaves them 0); calls that share them must be ordered on one stream.
extern "C" int flash_decode_launch(const void* q, const void* kc,
                                   const void* vc, int B, int S, int Hkv,
                                   int G, int D, int pos, int dtype,
                                   float scale, int n_split,
                                   int tiles_per_split, void* ws,
                                   void* tickets, void* out, void* stream) {
  if (B <= 0) return 0;
  const int n_tiles = pos / TILE + 1;
  if (G < 1 || G > MAX_G || Hkv < 1 || pos < 0 || pos >= S || n_split < 1 ||
      tiles_per_split < 1 || n_split > MAX_SPLITS ||
      n_split * tiles_per_split < n_tiles ||
      (n_split - 1) * tiles_per_split >= n_tiles ||
      (n_split > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kc, vc, B, S, Hkv, G, D, pos, scale, n_split,
                         tiles_per_split, ws, tickets, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, B, S, Hkv, G, D, pos, scale,
                                 n_split, tiles_per_split, ws, tickets, out,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
