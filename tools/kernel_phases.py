"""Where a capacity-assign or cell-sum launch spends its cycles, on one
GPU (nsight does not run on the card's machine).

    python3 tools/kernel_phases.py

Builds copies of `capacity_assign.cu` and `cell_sums.cu` with `clock64()`
stamps inserted at their phase boundaries (with the port's nvcc flags,
into build/phases/), calls them through ctypes at `chip_smoke.py`'s
shapes (`compare_kernels.py`'s for the cell sums), holds each output to its plain version, and prints one JSON line
a shape, after the card's nvidia-smi line (its SM clock converts cycles
to time):

- capacity_assign: thread 0 stamps after the branch check, the order's
  inversion, the weight-0 pass, and each round's apply sweep and radix
  select (cycles a phase, in that order);
- cell_sums: lane 0 of each cell's warp stamps when its first batch has
  landed in shared memory, when that batch is summed, and at its end
  (cycles from the warp's start, for the three fullest cells, and the
  median end over all cells).

The stamps cost cycles of their own; time the kernels with
`tools/compare_kernels.py` or `chip_smoke.py`.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMPS = """
__device__ long long g_stamp[8 * 65536];
__device__ int g_next;
"""
READ = """
extern "C" int phase_stamps(void* dst, int count) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, count * 8);
}
extern "C" int phase_reset() {
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(g_next, &zero, 4);
}
"""
MARK = "  if (threadIdx.x == 0) g_stamp[atomicAdd(&g_next, 1)] = clock64();\n"


def insert(src: str, anchor: str, text: str, after=True) -> str:
    if anchor not in src:
        raise RuntimeError(f"anchor not found: {anchor[:60]!r}")
    return src.replace(anchor, anchor + text if after else text + anchor, 1)


def assign_source() -> str:
    s = (ROOT / "src/repro_torch/kernels/capacity_assign/csrc/"
         "capacity_assign.cu").read_text()
    s = insert(s, "namespace {\n", STAMPS)
    for anchor in ("  extern __shared__ __align__(16) char smem[];\n",
                   "  if (__syncthreads_and(ok)) {\n",
                   "// bits of the largest rank\n  __syncthreads();\n",
                   "    __syncthreads();\n    int o = 0;",
                   "                      thresh);\n"):
        s = insert(s, anchor, MARK)
    s = insert(s, "  const int max_rounds", "  __syncthreads();\n" + MARK,
               after=False)
    return insert(s, "}  // namespace\n", READ)


def cell_sums_source() -> str:
    s = (ROOT / "src/repro_torch/kernels/cell_sums/csrc/"
         "cell_sums.cu").read_text()
    s = insert(s, "namespace {\n", STAMPS)
    s = insert(s, "  if (c >= ncells) return;  // the whole warp\n",
               "  const long long t0 = clock64();\n")
    s = insert(s, "    __syncwarp();\n    gather(",
               "    if (b == 0 && lane == 0) g_stamp[c * 4 + 1] = "
               "clock64() - t0;\n", after=False)
    s = insert(s, "    __syncwarp();\n  }\n  if (lane < 4) out",
               "    if (b == 0 && lane == 0) g_stamp[c * 4 + 2] = "
               "clock64() - t0;\n", after=False)
    s = insert(s, "  if (lane == 4) out[c] = float(min(m, 1 << 24));\n",
               "  if (lane == 0) {\n    g_stamp[c * 4] = m;\n"
               "    g_stamp[c * 4 + 3] = clock64() - t0;\n  }\n")
    return insert(s, "}  // namespace\n", READ)


def build(name: str, src: str) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    out = ROOT / "build" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def stamps(lib, count: int) -> list:
    buf = (ctypes.c_longlong * count)()
    if lib.phase_stamps(buf, count):
        raise RuntimeError("reading the stamps failed")
    return list(buf)


def main():
    import torch
    import chip_smoke as cs
    from compare_kernels import CELL_SUMS
    from repro_torch.kernels.capacity_assign import ref as ca_ref
    from repro_torch.kernels.cell_sums import ref as cs_ref
    if not torch.cuda.is_available():
        sys.exit("kernel_phases.py needs a CUDA GPU; none is visible")
    dev, P = torch.device("cuda"), ctypes.c_void_p
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    lib = build("capacity_assign_phases", assign_source())
    fn = lib.capacity_assign_launch
    fn.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int, P, P, P, P]
    for kind, seed in cs.ASSIGN_SHAPES:
        cost, w, caps = cs.assign_inputs(kind, seed, dev)
        n, L = cost.shape
        order = torch.sort(cost.reshape(-1), stable=True).indices
        scratch = torch.empty(n * L + n, dtype=torch.int32, device=dev)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        rounds = torch.empty(1, dtype=torch.int32, device=dev)
        capt = torch.as_tensor(caps).to(dev)
        lib.phase_reset()
        if fn(order.data_ptr(), w.data_ptr(), capt.data_ptr(), n, L,
              scratch.data_ptr(), out.data_ptr(), rounds.data_ptr(),
              stream()):
            raise RuntimeError("capacity_assign did not launch")
        torch.cuda.synchronize()
        if not torch.equal(out.cpu(),
                           ca_ref.capacity_assign_plain(cost, w, caps).cpu()):
            raise AssertionError(f"capacity_assign ({kind}) differs")
        r = int(rounds)
        marks = 3 + 2 * r if r else 1  # serial: the start alone
        t = stamps(lib, marks)
        print(json.dumps({"kernel": "capacity_assign", "cost": kind, "n": n,
                          "n_lp": L, "rounds": r,
                          "phase_cycles": [b - a for a, b in zip(t, t[1:])]}),
              flush=True)

    lib = build("cell_sums_phases", cell_sums_source())
    fn = lib.cell_sums_launch
    fn.argtypes = [P] * 5 + [ctypes.c_int, P, P]
    for n, area, seed, mobility, replicas in CELL_SUMS:
        pos, vec, grid = cs.cell_sums_inputs(n, area, seed, dev, mobility,
                                             replicas)
        pos, vec = pos.reshape(-1, 2), vec.reshape(-1, 2)
        ncells = grid["starts"].shape[0]
        out = torch.empty((5, ncells), dtype=torch.float32, device=dev)
        if fn(pos.data_ptr(), vec.data_ptr(), grid["order"].data_ptr(),
              grid["starts"].data_ptr(), grid["counts"].data_ptr(), ncells,
              out.data_ptr(), stream()):
            raise RuntimeError("cell_sums did not launch")
        torch.cuda.synchronize()
        want = cs_ref.cell_sums_plain(pos, vec, grid)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"cell_sums ({mobility}) differs")
        t = stamps(lib, 4 * ncells)
        cells = [t[4 * c:4 * c + 4] for c in range(ncells)]
        full = sorted(cells, key=lambda x: -x[0])[:3]
        print(json.dumps({
            "kernel": "cell_sums", "layout": mobility, "replicas": replicas,
            "fullest[members, landed, summed, end]": full,
            "median_end": statistics.median(x[3] for x in cells)}),
            flush=True)


if __name__ == "__main__":
    main()
