// Per-cell in-order sums for the flock's 3x3 block means, written by
// hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it ports the float scatter-add `bin2d` of
// `src/repro/core/neighbors.py::cell_block_mean`, which the compiled
// reference runs on the CPU as a loop over the SEs in id order, so each
// cell's float32 sum adds its members in id order, starting from 0.
// `index_add_` on CUDA adds through atomics in no fixed order and would
// round differently from run to run.
//
// The design: one warp a cell (of R stacked worlds' cells alike: the CSR
// order holds row ids across replicas). A cell's members are its segment
// of the stable cell sort (`order[starts[c] .. starts[c] + counts[c])`,
// in id order). The lanes read the segment coalesced and gather kBatch
// (256) members' positions and headings (float2 each) at a time into
// registers, and the next batch's gathers are issued before the current
// batch is summed, so their latency hides behind the sums. The current
// batch goes through shared memory, one row a quantity, where lanes 0-3
// each read their row four floats at a time and run that quantity's
// chain (x, y, heading x, heading y) in id order from +0.0,
// rounding each add (`__fadd_rn`, no contraction): the reference's
// 0 + (-0.0) is +0.0, so no chain is seeded with its first member. The
// count is written as float(min(count, 2^24)), which is the in-order
// float32 sum of ones exactly. Every cell is written, so the output
// needs no memset, and there are no atomics: the sums are bit-identical
// to the in-order CPU sum.
//
// Bound: latency, not bytes (those bound it far below). A cell's first
// batch lands after three dependent loads (the CSR offsets, the ids,
// the rows: ~1,900 cycles on an H100), and its chains then advance one
// add every ~9 cycles (tools/kernel_phases.py: 332 members end at
// ~5,500 cycles), which the next batch's gathers hide behind.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;
constexpr int kBatch = 32 * kPerLane;
// a quantity's row of the stage: room for the chain's reads eight values
// ahead, and lanes 0-3's float4 reads of their rows in distinct banks
constexpr int kRow = kBatch + 8;

// The member ids of a batch (int32: row ids of a world < 2^31), -1 past
// the cell's end.
__device__ __forceinline__ void load_ids(const int64_t* __restrict__ seg,
                                         int from, int m, int lane,
                                         int (&id)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = from + j * 32 + lane;
    id[j] = k < m ? int(seg[k]) : -1;
  }
}

__device__ __forceinline__ void gather(const float2* __restrict__ pos,
                                       const float2* __restrict__ vec,
                                       const int (&id)[kPerLane],
                                       float4 (&v)[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    if (id[j] >= 0) {
      const float2 p = pos[id[j]], h = vec[id[j]];
      v[j] = make_float4(p.x, p.y, h.x, h.y);
    }
  }
}

__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}

__global__ void __launch_bounds__(kThreads)
cell_sums_kernel(const float2* __restrict__ pos, const float2* __restrict__ vec,
                 const int64_t* __restrict__ order,
                 const int64_t* __restrict__ starts,
                 const int64_t* __restrict__ counts, int ncells,
                 float* __restrict__ out) {
  __shared__ __align__(16) float stage[kWarps][4][kRow];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * kWarps + w;
  if (c >= ncells) return;  // the whole warp
  const int64_t* seg = order + starts[c];
  const int m = int(counts[c]);
  float acc = 0.f;  // lane q < 4: quantity q's chain
  // ids two batches ahead, values one
  int id[kPerLane], ahead[kPerLane];
  float4 v[kPerLane] = {};
  load_ids(seg, 0, m, lane, id);
  load_ids(seg, kBatch, m, lane, ahead);
  gather(pos, vec, id, v);
  for (int b = 0; b < m; b += kBatch) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int k = j * 32 + lane;
      stage[w][0][k] = v[j].x;
      stage[w][1][k] = v[j].y;
      stage[w][2][k] = v[j].z;
      stage[w][3][k] = v[j].w;
    }
    __syncwarp();
    gather(pos, vec, ahead, v);
    load_ids(seg, b + 2 * kBatch, m, lane, ahead);
    if (lane < 4) {
      // eight values a step, the next eight loaded before they are added
      const float4* row = reinterpret_cast<const float4*>(stage[w][lane]);
      const int len = min(kBatch, m - b);
      float4 x0 = row[0], x1 = row[1];
      for (int g = 0; g < len >> 3; ++g) {
        const float4 y0 = row[2 * g + 2], y1 = row[2 * g + 3];
        acc = add4(add4(acc, x0), x1);
        x0 = y0;
        x1 = y1;
      }
      const float rest[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (t < (len & 7)) acc = __fadd_rn(acc, rest[t]);
    }
    __syncwarp();
  }
  if (lane < 4) out[(lane + 1) * ncells + c] = acc;
  if (lane == 4) out[c] = float(min(m, 1 << 24));
}

}  // namespace

extern "C" int cell_sums_launch(const void* pos, const void* vec,
                                const void* order, const void* starts,
                                const void* counts, int ncells, void* out,
                                void* stream) {
  if (ncells <= 0) return 0;
  const int blocks = (ncells + kWarps - 1) / kWarps;
  cell_sums_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(vec),
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(counts), ncells, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cell_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
