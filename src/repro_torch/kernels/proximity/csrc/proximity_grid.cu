// Cell-list proximity LP histogram, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/proximity/grid.py::proximity_lp_counts_grid
// which tiles a materialised (N, 9 * capacity) candidate table in
// 256 x 256 VMEM blocks and reduces it with n_lp masked VPU sums.
//
// What bounds it on this card: latency, not a rate. The bytes it must
// move once are O(N) (positions, LPs, sender flags, the sort
// permutation, the CSR offsets, the output) and its operations ~12
// float32 ones per candidate pair, so the roofline floor is ~0.012 ms
// at 1M SEs (bytes) and well under a microsecond at 10k. What it pays
// instead is chains of dependent loads (CSR offsets, then `order`, then
// a member's position and LP by id, every member read again by the
// warps of the up to 9 cells that see it) and, for each sender, a serial
// chain of shuffles, ballots and popcounts; the warps an SM can hold to
// hide both are set by the registers (48 a thread: five blocks an SM).
//
// What the design does about it:
//   * one warp per cell, a block WARPS consecutive cells of one grid row
//     (a 2-D launch: no division), so neighbouring warps share 6 of
//     their 9 segments in L1;
//   * the CSR grid is read in place: a member is `order[starts[c] + k]`
//     and its position, LP and sender flag are read by id, so the
//     wrapper gathers nothing and the call is this one launch;
//   * lanes 0..8 read the nine neighbour cells' offsets at once, and the
//     warp stages the concatenated candidate windows (each segment's
//     first min(count, capacity) members) into registers, CHUNK at a
//     time, consecutive lanes on consecutive members; the first chunk's
//     loads go out beside the rows' own, so a cell costs three dependent
//     load levels;
//   * a cell's rows are all counts[c] members (not clamped: a member past
//     capacity is a row, never a candidate, as in the reference's segment
//     window); its first HEAD rows are cut into items of 32 that its block
//     deals to its warps;
//   * the rows past HEAD of a crowded cell (clustered worlds, overflowed
//     grids) go to row blocks, launched first, a warp for each 32 rows of
//     the sorted order: a warp takes the rows whose row HEAD places back
//     is in the same cell (`cell_sorted`, one load level, no counter), so
//     a cell of hundreds of members spreads over as many warps of the
//     launch, and on a grid without such cells a row block reads two
//     words a row and leaves;
//   * the warp ballots an item's senders and sweeps the staged candidates
//     for each, a candidate a lane; the histogram is a bit-sliced ballot:
//     per 32 candidates one ballot of the hits and one per bit of the LP,
//     and lane l counts the hits whose LP bits spell l with one __popc
//     (and l + 32 for n_lp > 32), so no histogram lives in memory;
//   * candidates past one chunk (crowded cells, large capacities) are
//     swept chunk by chunk for a batch of senders at a time, each lane
//     keeping its own counts in shared memory: any capacity works;
//   * every row is written exactly once, by the warp that holds it
//     (non-senders get zeros), so the output needs no memset; the head
//     and the tail of a cell are disjoint and cover it;
//   * an open world's dead rows sit in no cell: the grid bins them to a
//     virtual cell R * ncell^2 that sorts after every real one, so they
//     form the sorted order's tail. The row block that holds a dead row
//     writes its zeros (it is nobody's candidate and never a sender) and
//     takes it for no crowded cell's tail, however long the dead tail
//     is; the row blocks read `cell_sorted` anyway, so this costs no
//     load and the call stays one launch with no host read;
//   * R replicas (independent worlds of the same geometry) are one
//     launch: the CSR grid spans R * ncell^2 cells, replica r's at
//     r * ncell^2, and `order` holds row ids across replicas (r * N + i),
//     so a member is read by its row id as before; the cell blocks'
//     grid rows run over R * ncell (replica r's grid row cx is
//     r * ncell + cx) and a cell's neighbours are taken within its own
//     replica; the row blocks cover every replica's crowded tails, as a
//     cell id names its replica.
//
// Per pair it evaluates exactly the reference's compiled expression:
//   d = |pi - pj|; d = min(d, area - d); fma(dx, dx, dy * dy) <= rng^2
// with the intrinsics written out, so nvcc's own contraction picks
// neither the operand order nor the rounding. The wrapper reports the
// grid's overflow flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // cells a block, of one grid row
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS = 4;           // candidates a lane holds
constexpr int CHUNK = 32 * SLOTS;  // candidates staged at a time
constexpr int HEAD = 64;           // rows of a cell its own block sweeps
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float wrapped(float a, float b, float area) {
  float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(area, d));
}

// A cell's candidates: candidate t of its concatenated neighbour windows
// lies in neighbour g, the first with t < end[g], at sorted position
// t + shift[g].
struct Windows {
  int end[9];
  int shift[9];
};

// The cell-list inputs, as the kernel receives them.
struct Grid {
  const float2* pos;      // (n,) id order
  const int32_t* lp;      // (n,)
  const uint8_t* sender;  // (n,) 0/1
  const int64_t* order;   // (n,) sorted row -> id
  const int64_t* starts;  // (ncell^2,)
  const int64_t* counts;  // (ncell^2,)
  int ncell, capacity, n_lp;
  float area, rng2;
  int32_t* out;           // (n, n_lp) id order
};

// Cell (cx, cy) of the replica whose cells start at `base`: its windows
// into `win`, lane g < 9 reading neighbour g (row-major 3x3, lane 4 the
// centre; each window the first min(count, capacity) members); returns
// the centre's (start, count) on every lane. Every lane calls it;
// `valid` false reads nothing.
__device__ __forceinline__ int2 read_windows(const Grid& G, Windows& win,
                                             int base, int cx, int cy,
                                             bool valid, int lane) {
  int seg_start = 0, seg_len = 0, cell_count = 0;
  if (valid && lane < 9) {
    const int ncell = G.ncell;
    int nx = cx + lane / 3 - 1, ny = cy + lane % 3 - 1;
    nx += nx < 0 ? ncell : 0;
    nx -= nx >= ncell ? ncell : 0;
    ny += ny < 0 ? ncell : 0;
    ny -= ny >= ncell ? ncell : 0;
    const int nc = base + nx * ncell + ny;
    seg_start = static_cast<int>(G.starts[nc]);
    cell_count = static_cast<int>(G.counts[nc]);
    seg_len = min(cell_count, G.capacity);
  }
  int incl = seg_len;  // inclusive prefix of the window lengths
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane < 9) {
    win.end[lane] = incl;
    win.shift[lane] = seg_start - (incl - seg_len);
  }
  return make_int2(__shfl_sync(FULL, seg_start, 4),
                   __shfl_sync(FULL, cell_count, 4));
}

// Row `id` of the output, all zeros.
__device__ __forceinline__ void zero_row(const Grid& G, int id) {
  int32_t* o = G.out + static_cast<int64_t>(id) * G.n_lp;
  if ((G.n_lp & 3) == 0) {
    for (int l = 0; l < G.n_lp; l += 4)
      *reinterpret_cast<int4*>(o + l) = make_int4(0, 0, 0, 0);
  } else {
    for (int l = 0; l < G.n_lp; ++l) o[l] = 0;
  }
}

// One warp, up to 32 rows of one cell (lane: sorted row `row` when `has`)
// against the cell's candidates `win`: the counts of its senders, zeros
// for its other rows. `partial` holds a batch's counts while the
// candidates span several chunks.
template <int LB, int BATCH>
__device__ __forceinline__ void sweep(const Grid& G, const Windows& win,
                                      bool has, int row,
                                      int (*partial)[1 << LB], int lane) {
  const int* end = win.end;
  const int* shift = win.shift;
  const int n_cand = end[8], n_lp = G.n_lp;

  // stage candidates base + lane + 32u: ids first (-1 past the end),
  // then positions and LPs (LP -1 past the end)
  int cid[SLOTS], clp[SLOTS];
  float cxs[SLOTS], cys[SLOTS];
  auto stage_ids = [&](int base) {
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int t = base + u * 32 + lane;
      cid[u] = -1;
      if (base + u * 32 < n_cand) {  // warp-uniform
        int sh = shift[0];
#pragma unroll
        for (int g = 0; g < 8; ++g) sh = t >= end[g] ? shift[g + 1] : sh;
        if (t < n_cand) cid[u] = static_cast<int>(G.order[t + sh]);
      }
    }
  };
  auto stage_rest = [&]() {
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      clp[u] = -1;
      cxs[u] = cys[u] = 0.f;
      if (cid[u] >= 0) {
        const float2 q = G.pos[cid[u]];
        cxs[u] = q.x;
        cys[u] = q.y;
        clp[u] = G.lp[cid[u]];
      }
    }
  };

  // the first chunk's loads go out beside the rows' own
  stage_ids(0);
  const int id = has ? static_cast<int>(G.order[row]) : 0;
  stage_rest();
  int staged = 0;
  const bool snd = has && G.sender[id];
  const float2 p = G.pos[id];
  if (has && !snd) zero_row(G, id);  // rows that do not send

  // the senders, BATCH at a time; one chunk of candidates (the common
  // case) writes its counts at once, more keep them in `partial` until
  // the last chunk
  const bool one_chunk = n_cand <= CHUNK;
  unsigned senders = __ballot_sync(FULL, snd);
  while (senders) {
    unsigned batch = senders;
    if (BATCH < 32 && __popc(senders) > BATCH) {
      unsigned rest = senders;
      for (int k = 0; k < BATCH; ++k) rest &= rest - 1;
      batch = senders & ~rest;
    }
    senders &= ~batch;
    for (int base = 0; base < n_cand; base += CHUNK) {
      if (base != staged) {
        stage_ids(base);
        stage_rest();
        staged = base;
      }
      unsigned todo = batch;
      for (int k = 0; todo; ++k) {
        const int r = __ffs(todo) - 1;
        todo &= todo - 1;
        const int sid = __shfl_sync(FULL, id, r);
        const float sx = __shfl_sync(FULL, p.x, r);
        const float sy = __shfl_sync(FULL, p.y, r);
        int c0 = 0, c1 = 0;  // hits on LP lane, and on LP lane + 32
#pragma unroll
        for (int u = 0; u < SLOTS; ++u) {
          if (base + u * 32 >= n_cand) break;  // warp-uniform
          const int l = clp[u];
          const float dx = wrapped(sx, cxs[u], G.area);
          const float dy = wrapped(sy, cys[u], G.area);
          const bool hit =
              static_cast<unsigned>(l) < static_cast<unsigned>(n_lp) &&
              cid[u] != sid && __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) <= G.rng2;
          unsigned m = __ballot_sync(FULL, hit);
#pragma unroll
          for (int b = 0; b < (LB < 5 ? LB : 5); ++b) {
            const unsigned bits = __ballot_sync(FULL, hit && (l >> b & 1));
            m &= (lane >> b & 1) ? bits : ~bits;
          }
          if (LB == 6) {
            const unsigned hi = __ballot_sync(FULL, hit && (l >> 5 & 1));
            c0 += __popc(m & ~hi);
            c1 += __popc(m & hi);
          } else {
            c0 += __popc(m);
          }
        }
        if (one_chunk) {
          int32_t* o = G.out + static_cast<int64_t>(sid) * n_lp;
          if (lane < n_lp) o[lane] = c0;
          if (LB == 6 && lane + 32 < n_lp) o[lane + 32] = c1;
          continue;
        }
        // each lane keeps its own counts: no exchange between lanes
        if (lane < (1 << LB))
          partial[k][lane] = c0 + (base ? partial[k][lane] : 0);
        if (LB == 6)
          partial[k][lane + 32] = c1 + (base ? partial[k][lane + 32] : 0);
      }
    }
    if (!one_chunk) {
      unsigned todo = batch;
      for (int k = 0; todo; ++k) {
        const int r = __ffs(todo) - 1;
        todo &= todo - 1;
        int32_t* o =
            G.out + static_cast<int64_t>(__shfl_sync(FULL, id, r)) * n_lp;
        if (lane < n_lp) o[lane] = partial[k][lane];
        if (LB == 6 && lane + 32 < n_lp) o[lane + 32] = partial[k][lane + 32];
      }
    }
  }
}

// LB bits of LP (n_lp <= 2^LB): lane l counts LP l, and l + 32 for LB 6.
// Blocks with blockIdx.y < row_y are row blocks, the rest cell blocks
// (grid row blockIdx.y - row_y of the R replicas' stacked grids).
// Five blocks an SM (48 registers) up to 16 LPs; four above, where 48
// registers would spill.
template <int LB>
__global__ void __launch_bounds__(THREADS, LB <= 4 ? 5 : 4)
    grid_lp_counts_kernel(
    const float2* __restrict__ pos, const int32_t* __restrict__ lp,
    const uint8_t* __restrict__ sender, const int64_t* __restrict__ order,
    const int32_t* __restrict__ cell_sorted,  // (n,) sorted row -> cell
    const int64_t* __restrict__ starts, const int64_t* __restrict__ counts,
    int n, int ncell, int capacity, int n_lp, float area, float rng2,
    int32_t* __restrict__ out, int row_y) {
  const Grid G{pos, lp, sender, order, starts, counts, ncell, capacity,
               n_lp, area, rng2, out};
  // a sender's counts while its candidates span several chunks: a warp
  // sweeps BATCH senders a chunk at a time
  constexpr int W = 1 << LB;
  constexpr int BATCH = 512 / W < 32 ? 512 / W : 32;
  __shared__ Windows win[WARPS];
  __shared__ int rows[WARPS], row_start[WARPS];
  __shared__ int partial[WARPS][BATCH][W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int cells = G.ncell * G.ncell;
  if (blockIdx.y < row_y) {
    // row block: a warp's 32 consecutive sorted rows. A dead row (in
    // the virtual cell past the R replicas' real ones) gets its zeros;
    // of the others the warp takes those at least HEAD rows into their
    // cell (the row HEAD before is in the same cell); they are one
    // cell's, as HEAD >= 32
    const int row =
        ((blockIdx.y * gridDim.x + blockIdx.x) * WARPS + warp) * 32 + lane;
    const int cell = row < n ? cell_sorted[row] : -1;
    // the R replicas' grid rows (R * ncell) times ncell: R * ncell^2
    const int n_cells = (static_cast<int>(gridDim.y) - row_y) * G.ncell;
    const bool dead = row < n && cell >= n_cells;
    if (dead) zero_row(G, static_cast<int>(G.order[row]));
    const bool tail = row < n && !dead && row >= HEAD &&
                      cell == cell_sorted[row - HEAD];
    const unsigned mine = __ballot_sync(FULL, tail);
    if (!mine) return;
    const int c = __shfl_sync(FULL, cell, __ffs(mine) - 1);
    const int base = c / cells * cells, local = c - base;
    read_windows(G, win[warp], base, local / G.ncell, local % G.ncell, true,
                 lane);
    __syncwarp();
    sweep<LB, BATCH>(G, win[warp], tail, row, partial[warp], lane);
    return;
  }

  // cell block, pass 1: a warp per cell reads its windows
  {
    const int gy = blockIdx.y - row_y;  // r * ncell + cx
    const int r = gy / G.ncell, cx = gy - r * G.ncell;
    const int cy = blockIdx.x * WARPS + warp;
    const int2 centre =
        read_windows(G, win[warp], r * cells, cx, cy, cy < G.ncell, lane);
    if (lane == 0) {
      row_start[warp] = centre.x;
      rows[warp] = min(centre.y, HEAD);
    }
  }
  __syncthreads();

  // pass 2: the block's items, (cell, 32 of its first HEAD rows), dealt
  // to its warps; a cell's rows are all its members (not clamped to
  // capacity: a member past it is a row, never a candidate, as in the
  // reference's segment window), those past HEAD the row blocks'
  int n_items = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n_items += (rows[w] + 31) / 32;
  for (int item = warp; item < n_items; item += WARPS) {
    int w = 0, rbase = item * 32;  // the item's cell and first row
#pragma unroll
    for (int v = 0, seen = 0; v < WARPS; ++v) {
      const int r = (rows[v] + 31) / 32 * 32;
      if (item * 32 >= seen + r) {
        w = v + 1;
        rbase = item * 32 - seen - r;
      }
      seen += r;
    }
    sweep<LB, BATCH>(G, win[w], rbase + lane < rows[w],
                     row_start[w] + rbase + lane, partial[warp], lane);
  }
}

template <int LB>
void launch(const void* pos, const void* lp, const void* sender,
            const void* order, const void* cell_sorted, const void* starts,
            const void* counts, int n, int ncell, int capacity, int n_lp,
            float area, float rng2, void* out, int n_rep,
            cudaStream_t stream) {
  // row blocks first (a crowded cell's tail starts early), a warp for
  // each 32 sorted rows of all replicas; then a block for each WARPS
  // cells of a grid row, over the R replicas' grid rows
  const int bx = (ncell + WARPS - 1) / WARPS;
  const int row_blocks = (n + THREADS - 1) / THREADS;
  const int row_y = (row_blocks + bx - 1) / bx;
  grid_lp_counts_kernel<LB>
      <<<dim3(bx, row_y + n_rep * ncell), THREADS, 0, stream>>>(
      static_cast<const float2*>(pos), static_cast<const int32_t*>(lp),
      static_cast<const uint8_t*>(sender),
      static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(cell_sorted),
      static_cast<const int64_t*>(starts),
      static_cast<const int64_t*>(counts), n, ncell, capacity, n_lp, area,
      rng2, static_cast<int32_t*>(out), row_y);
}

}  // namespace

// n: the rows of all n_rep replicas; the grid spans n_rep * ncell^2 cells.
extern "C" int grid_lp_counts_launch(
    const void* pos, const void* lp, const void* sender, const void* order,
    const void* cell_sorted, const void* starts, const void* counts, int n,
    int ncell, int capacity, int n_lp, float area, float rng2, void* out,
    int n_rep, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lp < 1 || n_lp > 64 || n_rep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // LB bits of LP: n_lp <= 2^LB
  auto* go = n_lp <= 4    ? launch<2>
             : n_lp <= 8  ? launch<3>
             : n_lp <= 16 ? launch<4>
             : n_lp <= 32 ? launch<5>
                          : launch<6>;
  go(pos, lp, sender, order, cell_sorted, starts, counts, n, ncell, capacity,
     n_lp, area, rng2, out, n_rep, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* proximity_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
