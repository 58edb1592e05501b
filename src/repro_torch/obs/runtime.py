"""Telemetry session routing and the ledger ring's drain to the host
(the port of `repro.obs.runtime`).

The engine's window runner does not know which `Engine` it serves, so
it reports to whichever :class:`~repro_torch.obs.ledger.Telemetry`
session is *current*. `core.service.Engine` marks its session current
before every `run` and `step`; one-shot runners and tests scope one with
:func:`use`. One thread, one active engine at a time: "current" is a
module global, the last setter wins, and interleaving the steps of two
telemetry-enabled engines works because each re-asserts its session at
every call. Blocks that arrive with no session are counted, not filed.

The drain. The step loop never waits on the card, so where the
reference ships a full ring through `jax.debug.callback`, :func:`drain`
copies it with ``non_blocking=True`` into a pinned host buffer and
records a CUDA event. The session files a block once its event has
completed: it asks (`Event.query`, which does not block) at each later
wrap, and waits for all of them in :func:`flush_tail` at the window's
end, so rows file in step order. Each copy in flight has a buffer of its
own, from a small pool the session allocates once; a later copy never
overwrites a block the host has not filed. When every buffer is in
flight, the wrap waits for the oldest copy and counts a stall. On the
CPU the same code runs with plain copies.
"""
from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import torch

#: host buffers a session keeps for copies in flight
POOL_SIZE = 8

_CURRENT = None
dropped_blocks = 0


def set_current(tele) -> None:
    """Make `tele` (a Telemetry or None) the routing target."""
    global _CURRENT
    _CURRENT = tele


def get_current():
    return _CURRENT


@contextlib.contextmanager
def use(tele):
    """Scope a Telemetry as current (tests and one-shot runners)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tele
    try:
        yield tele
    finally:
        _CURRENT = prev


class DeviceDrain:
    """One session's ring copies in flight: a pool of POOL_SIZE host
    buffers (pinned when the ring is on the card), allocated at the
    first copy, and a queue of (buffer, event, t_last) in step order,
    each handed to `file_block(block, t_last)` once its copy is done.
    `stalls` counts the wraps that found no free buffer and waited."""

    def __init__(self, file_block):
        self.file_block = file_block
        self.free = None
        self.pending: deque = deque()
        self.stalls = 0

    def _buffer(self, ring):
        """A free (host tensor, event) pair shaped like `ring`."""
        if self.free is None:
            cuda = ring.is_cuda
            self.free = [(torch.empty(ring.shape, dtype=ring.dtype,
                                      pin_memory=cuda),
                          torch.cuda.Event() if cuda else None)
                         for _ in range(POOL_SIZE)]
        self.poll()
        if not self.free:
            self.stalls += 1
            self._file_oldest()
        return self.free.pop()

    def copy(self, ring):
        """Start copying `ring` into a free host buffer without blocking
        the host; returns (buffer, event), the event recorded after the
        copy (None on the CPU, where the copy is done on return)."""
        buf, ev = self._buffer(ring)
        buf.copy_(ring, non_blocking=ev is not None)
        if ev is not None:
            ev.record()
        return buf, ev

    def start(self, ring, t_last: int) -> None:
        """Copy a full ring; the block files once the copy is done."""
        self.pending.append((*self.copy(ring), int(t_last)))

    def _file_oldest(self) -> None:
        buf, ev, t_last = self.pending.popleft()
        if ev is not None:
            ev.synchronize()
        self.file_block(buf.numpy(), t_last)
        self.free.append((buf, ev))

    def poll(self) -> None:
        """File every leading block whose copy has completed."""
        while self.pending and (self.pending[0][1] is None or
                                self.pending[0][1].query()):
            self._file_oldest()

    def wait(self) -> None:
        """File every block in flight, waiting for its copy."""
        while self.pending:
            self._file_oldest()


def on_block(ring, t_last) -> None:
    """File a full (drain_every, K) host block flushed at step `t_last`
    into the current session (counted as dropped without one)."""
    global dropped_blocks
    tele = _CURRENT
    if tele is None:
        dropped_blocks += 1
        return
    tele.on_block(np.asarray(ring), int(t_last))


def drain(ring, t_last: int) -> None:
    """The ring (a device tensor) wrapped at step `t_last`: start its
    copy to the current session's host buffers (counted as dropped
    without a session)."""
    global dropped_blocks
    tele = _CURRENT
    if tele is None:
        dropped_blocks += 1
        return
    tele.drain.start(ring, t_last)


def flush_tail(ring, t_start, t_end) -> None:
    """At a window's end: wait for every drain still in flight and file
    it, then file the partial ring's steps that never reached a wrap
    (window length not a multiple of drain_every), so rows file in step
    order."""
    tele = _CURRENT
    if tele is None:
        return
    buf, ev = tele.drain.copy(ring)
    tele.drain.wait()
    if ev is not None:
        ev.synchronize()
    tele.on_tail(buf.numpy(), int(t_start), int(t_end))
    tele.drain.free.append((buf, ev))


def emit_event(kind: str, step: int, **data) -> None:
    """Host-side event emission into the current session, if any (the
    MF self-tuner and other engine-agnostic call sites use this)."""
    tele = _CURRENT
    if tele is not None:
        tele.emit(kind, step, **data)
