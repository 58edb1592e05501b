// The partitioners' greedy capacity-constrained assignment, written by
// hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the `lax.scan` of
// `src/repro/core/partition.py::capacity_assign`, which walks the
// N * L (SE, LP) pairs in ascending cost and gives an unplaced SE the
// first LP whose filled weight plus the SE's stays within the LP's
// capacity; an SE no LP fits takes the LP with the most capacity left,
// the first on ties (jnp.argmax). kmeans runs it 9 times a partition
// and bestresponse 8, on 40,000 pairs at 10k SEs and 4 LPs.
//
// One launch a call, one block of 1,024 threads. The wrapper sorts the
// flat costs on the device (stable, so ties go to the lower flat index
// i * L + l and -0.0 ties +0.0, as the reference's argsort) and hands
// the kernel the order. The block first decides, with no host read,
// which of two branches computes the map:
//
// Rounds, when every weight is exactly 0 or 1, every cap is >= 0 and not
// NaN (+inf: no quota), N < 2^24, and a pair's rank packed with an LP
// index fits 31 bits (N * L * 2^ceil(log2 L) <= 2^31: 10k x 4 and 50k x
// 8 do; every caller passes 0/1 weights: the engine its live mask or
// ones, the partitioners ones). Why they are exact:
//   * fills are then counts of unit SEs, exact in float32 below 2^24, so
//     `fill + 1 <= cap` is `count < q` with the quota q = floor(cap), and
//     a weight-0 SE fits at its first pair (fill <= cap always holds);
//   * the greedy scan admits pairs in one global order, which ranks the
//     LPs for each SE and the SEs for each LP: with such acyclic
//     preferences the stable matching of SEs to LPs with quotas q is
//     unique and is the greedy's, and deferred acceptance finds it;
//   * deferred acceptance in parallel rounds: each pair's rank is its
//     place in the sorted order (`rank[order[k]] = k`, inverted here);
//     every unit SE applies to its lowest-ranked LP whose threshold t_l
//     admits its rank (t_l starts above every rank); an LP with more
//     applicants than q_l sets t_l to the q_l-th smallest applicant rank
//     (a block-level radix select, 8 bits a pass from the ranks' top bit
//     down; -1 when q_l is 0); only the SEs it rejects apply again. t_l
//     only falls and each fall rejects a pair, so the loop ends within
//     N * L rounds; the partitioners' costs take 1-8 (10k x 4, 50k x 8);
//   * the unit SEs no LP admits take argmax(cap - count) in float32
//     (`__fsub_rn`), the first on ties, the greedy's fallback.
// Each SE is one int32 word (its rank and LP packed, or a code), counts
// are integer atomics in shared memory, and there are no float atomics.
// Shared memory holds the select's bins, the words and, while they fit,
// the ranks (10k x 4: all three; 50k x 8: the ranks in device memory).
// What bounds it (tools/kernel_phases.py, on an H100): the block's
// sweeps over the SEs each round, one to apply (~6.5 us at 10k SEs) and
// one a radix pass (~2.6 us), and inverting the order, N * L scattered
// 4-byte stores from one SM (~10 us into shared memory at 10k x 4, ~420
// us into device memory at 50k x 8). The bytes the function must move
// bound it far below that (PERF.md).
//
// Serial, for any other weights and caps: float32 fills then depend on
// the order of their sums, so thread 0 makes every decision in the
// sorted order, as the reference's scan. The whole block stages CHUNK
// entries of the order at a time into shared memory as 32-bit SE and
// LP indices, dropping SEs placed before the chunk; the SEs' LPs and
// weights live in shared memory when they fit. The scan stops as soon
// as every SE is placed. It is bound by thread 0's chain of dependent
// decisions, one a pair it reaches.
//
// The kernel writes the rounds it ran (0 for the serial branch) to
// `rounds`. float32 sums round as the reference's (`__fadd_rn`).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 2048;
constexpr int kMaxLp = 64;
constexpr int kBins = 256;
constexpr unsigned kAll = 0xffffffffu;
// a rounds SE word (int32): a placed unit SE packs (rank << lp_bits) | lp
// (>= 0); the rest are codes
constexpr int kNone = -1;  // a unit SE no LP admits
constexpr int kNew = -2;   // a unit SE before its first application
constexpr int kSkip = -3;  // a weight-0 SE, its LP written at once

// What the host found room for in dynamic shared memory; the rest lives
// in `scratch` (device memory).
enum : int { kWordsSmem = 1, kRankSmem = 2, kSerialSmem = 4 };

// The quota-th smallest applicant rank of every LP over its quota, on
// ranks of `nbits` bits: each pass takes the next (up to) 8 bits below
// the LP's prefix, counts its applicants that share the prefix into 256
// bins, and one warp an LP finds the bin that holds the kth.
__device__ void select_thresholds(const int* word, int* hist, int n,
                                  int n_lp, int lp_bits, int nbits,
                                  const int* quota, const int* over,
                                  int* thresh) {
  __shared__ int prefix[kMaxLp], kth[kMaxLp];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mask = (1 << lp_bits) - 1;
  if (tid < n_lp) {
    prefix[tid] = 0;
    kth[tid] = quota[tid];
  }
  for (int hi = nbits; hi > 0;) {
    const int shift = max(0, hi - 8), width = hi - shift;
    for (int x = tid; x < n_lp * kBins; x += kThreads)
      if (over[x / kBins]) hist[x] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int v = word[i];
      if (v < 0 || !over[v & mask]) continue;
      const int l = v & mask, r = v >> lp_bits;
      if ((r >> hi) == prefix[l])
        atomicAdd(&hist[l * kBins + ((r >> shift) & ((1 << width) - 1))], 1);
    }
    __syncthreads();
    for (int l = warp; l < n_lp; l += kThreads / 32) {
      if (!over[l] || quota[l] == 0) continue;
      const int* h = hist + l * kBins + lane * 8;
      int mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) mine += h[j];
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += up;
      }
      const int k = kth[l];
      const unsigned hit = __ballot_sync(kAll, incl >= k);
      if (lane == __ffs(hit) - 1) {
        int below = incl - mine, d = 0;
        while (below + h[d] < k) below += h[d++];
        prefix[l] = (prefix[l] << width) | (lane * 8 + d);
        kth[l] = k - below;
      }
    }
    __syncthreads();
    hi = shift;
  }
  if (tid < n_lp && over[tid]) thresh[tid] = quota[tid] ? prefix[tid] : -1;
}

// The lowest rank of SE i's pairs that `thresh` admits (INT_MAX: none)
// and its LP; the ranks are loaded 8 at a time.
__device__ __forceinline__ int first_admitted(const int* rank, int i,
                                              int n_lp, const int* thresh,
                                              int& to) {
  int best = INT_MAX;
  to = -1;
  for (int l0 = 0; l0 < n_lp; l0 += 8) {
    int r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[j] = l0 + j < n_lp ? rank[i * n_lp + l0 + j] : INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (r[j] <= thresh[l0 + j] && r[j] < best) best = r[j], to = l0 + j;
  }
  return best;
}

__device__ void rounds_branch(const int64_t* __restrict__ order,
                              const float* __restrict__ weights,
                              const float* __restrict__ caps, int n,
                              int n_lp, int flags, char* smem,
                              int32_t* scratch, int32_t* __restrict__ out,
                              int32_t* __restrict__ rounds_out) {
  // thresholds of the LPs past n_lp are INT_MIN: they admit no rank
  __shared__ int quota[kMaxLp], count[kMaxLp], thresh[kMaxLp];
  __shared__ int over[kMaxLp], fallback;
  const int tid = threadIdx.x;
  const int total = n * n_lp;  // the packed largest rank fits 31 bits
  int* hist = reinterpret_cast<int*>(smem);
  int* word = flags & kWordsSmem ? hist + n_lp * kBins : scratch + total;
  int* rank = flags & kRankSmem ? word + n : scratch;
  for (int base = 0; base < total; base += 8 * kThreads) {
    int64_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = base + j * kThreads + tid;
      o[j] = k < total ? order[k] : -1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (o[j] >= 0) rank[o[j]] = base + j * kThreads + tid;
  }
  if (tid < kMaxLp) thresh[tid] = tid < n_lp ? INT_MAX : INT_MIN;
  if (tid < n_lp) {
    const float c = caps[tid];
    quota[tid] = c >= float(n) ? n : int(floorf(c));
    count[tid] = 0;
  }
  const int lp_bits = 32 - __clz(n_lp - 1), mask = (1 << lp_bits) - 1;
  const int nbits = 32 - __clz(total - 1);  // bits of the largest rank
  __syncthreads();
  // weight-0 SEs take their lowest-ranked LP and hold no slot
#pragma unroll 4
  for (int i = tid; i < n; i += kThreads) {
    int v = kNew;
    if (weights[i] == 0.f) {
      int to;
      first_admitted(rank, i, n_lp, thresh, to);
      out[i] = to;
      v = kSkip;
    }
    word[i] = v;
  }
  __syncthreads();
  const int max_rounds = total + 1;
  int round = 0;
  while (round < max_rounds) {
    ++round;
    // new and rejected unit SEs apply to their next LP that admits them
    for (int i = tid; i < n; i += kThreads) {
      const int v = word[i];
      if (v == kNew || (v >= 0 && (v >> lp_bits) > thresh[v & mask])) {
        int to;
        const int r = first_admitted(rank, i, n_lp, thresh, to);
        word[i] = to >= 0 ? (r << lp_bits) | to : kNone;
        if (to >= 0) atomicAdd(&count[to], 1);
      }
    }
    __syncthreads();
    int o = 0;
    if (tid < n_lp) over[tid] = o = count[tid] > quota[tid];
    if (!__syncthreads_or(o)) break;
    select_thresholds(word, hist, n, n_lp, lp_bits, nbits, quota, over,
                      thresh);
    if (tid < n_lp && over[tid]) count[tid] = quota[tid];
    __syncthreads();
  }
  if (tid == 0) {
    int best = 0;
    float most = __fsub_rn(caps[0], float(count[0]));
    for (int l = 1; l < n_lp; ++l) {
      const float spare = __fsub_rn(caps[l], float(count[l]));
      if (spare > most) most = spare, best = l;
    }
    fallback = best;
    *rounds_out = round;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int v = word[i];
    if (v != kSkip) out[i] = v >= 0 ? v & mask : fallback;
  }
}

__device__ void serial_branch(const int64_t* __restrict__ order,
                              const float* __restrict__ weights,
                              const float* __restrict__ caps, int n,
                              int n_lp, bool smem_rows, char* smem,
                              int32_t* __restrict__ out,
                              int32_t* __restrict__ rounds_out) {
  __shared__ float fill[kMaxLp], cap[kMaxLp];
  __shared__ int left, fallback;
  int32_t* chunk_i = reinterpret_cast<int32_t*>(smem);
  int8_t* chunk_l = reinterpret_cast<int8_t*>(chunk_i + kChunk);
  float* w_s = reinterpret_cast<float*>(chunk_l + kChunk);  // n weights,
  int8_t* lp_s = reinterpret_cast<int8_t*>(w_s + n);        // n LP bytes
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += kThreads) {
    if (smem_rows) {
      w_s[i] = weights[i];
      lp_s[i] = -1;
    } else {
      out[i] = -1;
    }
  }
  if (tid < n_lp) {
    fill[tid] = 0.f;
    cap[tid] = caps[tid];
  }
  if (tid == 0) {
    left = n;
    *rounds_out = 0;
  }
  __syncthreads();
  const int64_t total = int64_t(n) * n_lp;
  for (int64_t base = 0; base < total && left > 0; base += kChunk) {
    const int m = int(min(int64_t(kChunk), total - base));
    for (int k = tid; k < m; k += kThreads) {
      const int64_t flat = order[base + k];
      const int i = int(flat / n_lp);
      const bool placed = (smem_rows ? int(lp_s[i]) : out[i]) >= 0;
      chunk_i[k] = placed ? -1 : i;
      chunk_l[k] = int8_t(flat - int64_t(i) * n_lp);
    }
    __syncthreads();
    if (tid == 0) {
      int remaining = left;
      for (int k = 0; k < m && remaining > 0; ++k) {
        const int i = chunk_i[k];
        if (i < 0 || (smem_rows ? int(lp_s[i]) : out[i]) >= 0) continue;
        const int l = chunk_l[k];
        const float s = __fadd_rn(fill[l], smem_rows ? w_s[i] : weights[i]);
        if (s <= cap[l]) {
          if (smem_rows) {
            lp_s[i] = int8_t(l);
          } else {
            out[i] = l;
          }
          fill[l] = s;
          --remaining;
        }
      }
      left = remaining;
    }
    __syncthreads();
  }
  if (left > 0 && tid == 0) {
    int best = 0;
    float most = __fsub_rn(cap[0], fill[0]);
    for (int l = 1; l < n_lp; ++l) {
      const float spare = __fsub_rn(cap[l], fill[l]);
      if (spare > most) most = spare, best = l;
    }
    fallback = best;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int l = smem_rows ? int(lp_s[i]) : out[i];
    out[i] = l >= 0 ? l : fallback;
  }
}

__global__ void __launch_bounds__(kThreads)
capacity_assign_kernel(const int64_t* __restrict__ order,
                       const float* __restrict__ weights,
                       const float* __restrict__ caps, int n, int n_lp,
                       int flags, int32_t* scratch,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) char smem[];
  const int lp_bits = 32 - __clz(n_lp - 1);
  int ok = n < (1 << 24) && (int64_t(n) * n_lp - 1) << lp_bits < INT_MAX;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float w = weights[i];
    ok &= w == 0.f || w == 1.f;
  }
  if (threadIdx.x < n_lp) ok &= caps[threadIdx.x] >= 0.f;  // NaN fails
  if (__syncthreads_and(ok)) {
    rounds_branch(order, weights, caps, n, n_lp, flags, smem, scratch, out,
                  rounds_out);
  } else {
    serial_branch(order, weights, caps, n, n_lp, flags & kSerialSmem, smem,
                  out, rounds_out);
  }
}

}  // namespace

// scratch: n * L + n int32 of device memory for what does not fit in
// shared memory; rounds: one int32.
extern "C" int capacity_assign_launch(const void* order, const void* weights,
                                      const void* caps, int n, int n_lp,
                                      void* scratch, void* out, void* rounds,
                                      void* stream) {
  if (n <= 0) return 0;
  if (n_lp < 1 || n_lp > kMaxLp)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, capacity_assign_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t budget = optin - int64_t(fa.sharedSizeBytes);
  const int64_t hist = int64_t(n_lp) * kBins * 4, words = int64_t(n) * 4;
  const int64_t ranks = int64_t(n) * n_lp * 4;
  const int64_t chunk = int64_t(kChunk) * 5, rows = int64_t(n) * 5;
  int flags = 0;
  int64_t bytes = hist;
  if (hist + words <= budget) {
    flags |= kWordsSmem;
    bytes += words;
    if (bytes + ranks <= budget) {
      flags |= kRankSmem;
      bytes += ranks;
    }
  }
  if (chunk + rows <= budget) flags |= kSerialSmem;
  const int64_t serial = chunk + (flags & kSerialSmem ? rows : 0);
  bytes = serial > bytes ? serial : bytes;
  err = cudaFuncSetAttribute(capacity_assign_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  capacity_assign_kernel<<<1, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(order), static_cast<const float*>(weights),
      static_cast<const float*>(caps), n, n_lp, flags,
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(out),
      static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* capacity_assign_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
