"""Pipeline parallelism (GPipe schedule) over a mesh axis — the port of
`repro.parallel.pipeline`.

Each stage holds a contiguous slice of layers; microbatches stream down
the stages and the bubble fraction is (P-1)/(P-1+M). Where the
reference's `shard_map` body hands activations on with `ppermute`, the
port sends them to the next stage and receives from the previous one by
point-to-point calls over the axis's process group
(`torch.distributed.batch_isend_irecv`, a ring), and where it broadcasts
the last stage's outputs with a masked `psum`, the port broadcasts them
from the last stage. The schedule is a forward pass: no gradient flows
through the sends.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def gpipe(stage_fn: Callable, mesh, axis: str, n_micro: int):
    """Build a pipelined forward: y = stages(x), stages split over `axis`.

    stage_fn(stage_params, x) -> y applies ONE stage's layers.
    The returned fn(stage_params, xs) takes this rank's stage params
    (the stage block: a leading stage dim of 1) and xs (n_micro, B_m,
    ...), the same on every stage; it returns the stages' outputs for
    every microbatch, the same on every stage."""
    n_stage = mesh.shape[axis]
    group = mesh.group(axis)
    stage = mesh.index(axis) if mesh.live else 0

    def run(params, xs):
        from repro_torch import tree
        params = tree.tree_map(lambda p: p[0], params)  # this stage's
        if n_stage == 1:  # one stage: the sequential run
            return torch.stack([stage_fn(params, xs[t])
                                for t in range(n_micro)])
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(stage + 1) % n_stage], ranks[(stage - 1) % n_stage]
        buf = torch.zeros_like(xs[0])  # the activation holding slot
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stage - 1):
            # stage 0 ingests microbatch t (when valid)
            x_in = xs[min(t, n_micro - 1)] if (stage == 0
                                               and t < n_micro) else buf
            y = stage_fn(params, x_in).contiguous()
            # pass activations down the pipe
            recv = torch.empty_like(y)
            ops = [dist.P2POp(dist.isend, y, nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for r in dist.batch_isend_irecv(ops):
                r.wait()
            buf = recv
            # the last stage emits microbatch t - (n_stage - 1)
            if stage == n_stage - 1 and t >= n_stage - 1:
                outs[t - (n_stage - 1)] = y
        # the last stage's results to every stage
        dist.broadcast(outs, ranks[n_stage - 1], group=group)
        return outs

    return run
