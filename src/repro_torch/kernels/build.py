"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` source is compiled by `nvcc` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build dir>/<stem>-<hash>.so <stem>.cu

The library name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. All sources
that need a build are compiled in parallel, one `nvcc` each. The build
directory is `build/repro_torch/` at the root of the checkout (listed in
`.gitignore`), or `$REPRO_TORCH_BUILD_DIR` when set.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_PKG = Path(__file__).resolve().parent


def sources() -> list:
    """Every CUDA source of the port, as paths."""
    return sorted(_PKG.glob("*/csrc/*.cu"))


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _PKG.parents[2] / "build" / "repro_torch"


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns {stem: library path}; raises with nvcc's output if any
    build fails."""
    libs = {src.stem: (src, library_path(src)) for src in sources()}
    todo = {stem: v for stem, v in libs.items() if not v[1].exists()}
    if todo:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = []
        for stem, (src, lib) in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs.append((stem, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for stem, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, lib)
            else:
                os.unlink(tmp)
                failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: lib for stem, (_, lib) in libs.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from `<stem>.cu` (built first if
    needed)."""
    return ctypes.CDLL(str(build_all()[stem]))
