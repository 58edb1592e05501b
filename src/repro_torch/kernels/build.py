"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/*.cu` source is compiled by `nvcc` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build dir>/<stem>-<hash>.so <stem>.cu

`CudaKernel` binds one entry point of such a library and counts its
launches; `reset_launches()` / `launches()` read every kernel of the
port at once.

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

import torch

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


#: every CudaKernel constructed, in construction order
_KERNELS = []


class CudaKernel:
    """One entry point of a ctypes library: built and bound at first
    launch, with a count of its launches.

    `entry` takes `argtypes` followed by the CUDA stream and returns a
    cudaError_t as int; `errors` names the library's
    `const char* f(int)` that spells such a code."""

    def __init__(self, stem: str, entry: str, argtypes, errors: str):
        self.stem, self.entry, self.argtypes = stem, entry, argtypes
        self.errors = errors
        self.launches = 0
        self._lib = self._fn = self._err = None
        _KERNELS.append(self)

    def _bind(self):
        if self._fn is None:
            self._lib = load(self.stem)
            fn = getattr(self._lib, self.entry)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = getattr(self._lib, self.errors)
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args):
        code = self._bind()(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{self.entry} failed to launch: "
                               f"{self._err(code).decode()} "
                               f"(cudaError {code})")
        self.launches += 1


def reset_launches(kernels=None) -> None:
    """Set the launch count of `kernels` (default: every kernel) to 0."""
    for k in _KERNELS if kernels is None else kernels:
        k.launches = 0


def launches(kernels=None) -> dict:
    """{library stem: launches since the last reset} over `kernels`
    (default: every kernel constructed so far)."""
    return {k.stem: k.launches
            for k in (_KERNELS if kernels is None else kernels)}
