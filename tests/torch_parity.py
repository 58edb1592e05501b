"""Helpers the scenario tests share: both packages' engine configs from
one dict of fields, a free-running run of each, and teacher-forced
steps that carry the reference's state into the port (imports JAX and
both packages; the card's tests do not import it)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.core as R
from repro.core import costmodel as rcm
from repro.core import engine as reng
import repro_torch.core as T
from repro_torch.core import engine as teng

CPU = torch.device("cpu")
# The suite runs in parallel worker processes (pytest-xdist), each with
# its own JAX thread pool; PyTorch's intra-op threads on top of them
# oversubscribe the cores, and these tests' many small CPU ops then run
# 10-30x slower (measured: a 40-step hotspot run, 3 s alone, took 346 s
# in the parallel suite). One PyTorch thread a worker.
torch.set_num_threads(1)
#: the per-step series every comparison holds exactly (integers, or
#: float32 copies of integers)
INT_SERIES = ("local_msgs", "remote_msgs", "migrations", "heu_evals",
              "lp_flows", "mig_flows", "repartitions", "grid_overflow",
              "infected")
#: small worlds: 16 x 16 cells (the default's shape at 1/25 the SEs)
SMALL = {"n_se": 400, "area": 1000.0, "interaction_range": 60.0}


def cfgs(abm=None, heuristic=None, env=None, **eng):
    """One dict of fields -> (reference config, port config). `env`
    names an execution-environment preset, built in each package."""
    abm = {**SMALL, **(abm or {})}
    heuristic = heuristic or {}
    renv = tenv = None
    if env is not None:
        renv, tenv = rcm.make_env(env, abm.get("n_lp", 4)), \
            T.make_env(env, abm.get("n_lp", 4))
    return (R.EngineConfig(abm=R.ABMConfig(**abm),
                           heuristic=R.HeuristicConfig(**heuristic),
                           env=renv, **eng),
            T.EngineConfig(abm=T.ABMConfig(**abm),
                           heuristic=T.HeuristicConfig(**heuristic),
                           env=tenv, **eng))


def ref_numpy(st):
    return {k: np.asarray(jax.random.key_data(v)) if k == "key"
            else np.asarray(v) for k, v in st.items()}


def bits_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), what


def run_both(rc, tc, seed):
    """Free-running runs of both packages: ((state, series, counters)
    of the reference as numpy, the same of the port)."""
    rst, rser, rcnt = R.Engine(rc).run(seed=seed)
    tst, tser, tcnt = T.Engine(tc, device=CPU).run(seed=seed)
    return ((ref_numpy(rst), {k: np.asarray(v) for k, v in rser.items()},
             rcnt),
            (teng.state_to_numpy(tst), {k: v.numpy() for k, v in
                                        tser.items()}, tcnt))


def assert_integer_series_equal(rser, tser):
    assert rser.keys() == tser.keys()
    for k in INT_SERIES:
        if k in rser:
            bits_equal(rser[k], tser[k], k)


def teacher_forced(rc, tc, seed, steps):
    """Each step, carry the reference's state into the port and step
    both from it (the reference jitted, as its compiled scan runs it).
    Yields (reference state, port state, reference metrics, port
    metrics) after each step, as numpy."""
    mf = jnp.float32(rc.heuristic.mf)
    ref_step = jax.jit(lambda st: reng.step(st, rc, mf=mf))
    rst = R.Engine(rc).init(seed=seed).state
    for _ in range(steps):
        carried = teng.state_from_numpy(ref_numpy(rst), CPU)
        tst, tm = teng.step(carried, tc, mf=tc.heuristic.mf)
        rst, rm = ref_step(rst)
        yield (ref_numpy(rst), teng.state_to_numpy(tst),
               {k: np.asarray(v) for k, v in rm.items()},
               {k: v.numpy() for k, v in tm.items()})
