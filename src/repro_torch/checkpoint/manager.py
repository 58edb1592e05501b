"""Fault-tolerant checkpointing — the port of
`repro.checkpoint.manager`.

* atomic commit: write to ``step_N.tmp/``, fsync the manifest, then
  rename — a crash mid-save never corrupts the latest checkpoint;
  restore picks the newest *committed* step.
* integrity: every leaf file carries a sha256 in the manifest; restore
  verifies before handing the tensors back.
* async save: ``save(..., blocking=False)`` copies to host memory now
  and writes in a background thread, overlapping the next steps; a
  second save waits for the first, and `wait` raises what failed a
  save in the background.
* device-independent files: leaves are stored as numpy arrays, flattened
  in the reference's order (sorted dict keys), so a checkpoint written
  on the card restores on the CPU and the other way round
  (``restore(..., device=...)``). A bfloat16 leaf is stored as its
  uint16 bits with ``"dtype": "bfloat16"`` in the manifest, so no numpy
  bfloat16 type is needed to read or write it.
* retention: keep the last `keep` checkpoints.

The manifest also records the tree's containers, so `restore` rebuilds
the tree without a template; given one (`like`), it checks the leaf
count as the reference does.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

#: leaves written or read at once (hashing and file I/O release the
#: GIL); a few, so that an async save leaves the training loop's thread
#: its cores
IO_THREADS = 4


def _to_host(t) -> tuple:
    """(numpy array, manifest dtype) of a tensor, bf16 as uint16 bits."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr, dtype: str, device):
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class _HashingWriter:
    """A file object that hashes what passes through it."""

    def __init__(self, f):
        self.f, self.h = f, hashlib.sha256()

    def write(self, b):
        self.h.update(b)
        return self.f.write(b)


def _write_leaf(path: str, arr) -> str:
    """`arr` to `path` in np.save's format; the sha256 of the file's
    bytes. The data goes out as one view of the array's buffer (no
    copies by chunk), so writing and hashing run without the interpreter
    lock and an async save leaves the training loop's thread alone."""
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        np.lib.format.write_array_header_1_0(
            w, np.lib.format.header_data_from_array_1_0(arr))
        w.write(memoryview(np.ascontiguousarray(arr).reshape(-1).view(
            np.uint8)))
    return w.h.hexdigest()


def _read_leaf(path: str, sha: str):
    with open(path, "rb") as f:
        raw = f.read()
    if hashlib.sha256(raw).hexdigest() != sha:
        raise IOError(f"checksum mismatch in {path}")
    return np.load(path, allow_pickle=False)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _steps(self) -> list:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _path(self, step: int, tmp=False):
        return os.path.join(self.dir, f"step_{step}" + (".tmp" if tmp else ""))

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True):
        """Checkpoint `state` at `step`. With blocking=False the device ->
        host copy happens now, the files are written in the
        background."""
        host = [_to_host(t) for t in tree.leaves(state)]
        struct = tree.structure(state)
        self.wait()  # one async save in flight at a time

        def write():
            tmp = self._path(step, tmp=True)
            final = self._path(step)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with ThreadPoolExecutor(IO_THREADS) as ex:
                shas = list(ex.map(
                    lambda ia: _write_leaf(
                        os.path.join(tmp, f"leaf_{ia[0]}.npy"), ia[1][0]),
                    enumerate(host)))
            manifest = {"step": step, "n": len(host), "tree": struct,
                        "files": [{"i": i, "sha256": sha, "dtype": dt,
                                   "shape": list(arr.shape)}
                                  for i, (sha, (arr, dt))
                                  in enumerate(zip(shas, host))]}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic commit
            self._gc()

        def write_async():
            try:
                write()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()

    def wait(self):
        """Wait for the save in flight; raise what failed it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of `step` (default: the newest committed)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, like: Any = None, step: Optional[int] = None,
                device="cpu") -> tuple:
        """(tree, step): the checkpoint of `step` (default: the newest
        committed) as tensors on `device`, every leaf's sha256 checked.
        `like`, when given, must have the checkpoint's leaf count."""
        manifest = self.manifest(step)
        step = manifest["step"]
        if like is not None and len(tree.leaves(like)) != manifest["n"]:
            raise ValueError(
                f"checkpoint has {manifest['n']} leaves, expected "
                f"{len(tree.leaves(like))} — architecture mismatch?")
        path = self._path(step)
        metas = manifest["files"]
        with ThreadPoolExecutor(IO_THREADS) as ex:
            arrays = list(ex.map(
                lambda m: _read_leaf(
                    os.path.join(path, f"leaf_{m['i']}.npy"), m["sha256"]),
                metas))
        leaves = [_from_host(a, m["dtype"], device)
                  for a, m in zip(arrays, metas)]
        return tree.unflatten(manifest["tree"], leaves), step
