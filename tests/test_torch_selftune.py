"""The §5.5 self-tuners: the port's `repro_torch.core.selftune` against
`repro.core.selftune`, on the CPU, at `tests/test_selftune.py`'s sizes.

A history row is (window, MF, window LCR, window TEC a step). MF and
TEC are held exactly (the TEC prices the window's integer counters);
the window LCR is a float32 mean whose summation order differs between
XLA and PyTorch, held to 1e-6. The batched tuner is held against the
reference's batched tuner and, bit for bit, against the port's solo
tuner. The reference's own `test_env_pricing_steers_mf_differently` is
red (its asserted directions are not what the reference computes), so
the port is held to the reference's actual output there.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference runs beside the port

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import selftune as rtune  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import selftune as ttune  # noqa: E402

from torch_parity import CPU  # noqa: E402

#: tests/test_selftune.py's CFG
ABM = dict(n_se=100, n_lp=4, area=1000.0, speed=4.0, interaction_range=90.0,
           p_interact=0.3)
TC = dict(window=30, mf0=8.0, setup="distributed", interaction_bytes=1024,
          migration_bytes=32)


def _cfgs(timesteps=180, env=None):
    renv = tenv = None
    if env is not None:
        renv, tenv = R.make_env(env, 4), T.make_env(env, 4)
    return (R.EngineConfig(abm=R.ABMConfig(**ABM),
                           heuristic=R.HeuristicConfig(mf=4.0, mt=5),
                           gaia_on=True, timesteps=timesteps, env=renv),
            T.EngineConfig(abm=T.ABMConfig(**ABM),
                           heuristic=T.HeuristicConfig(mf=4.0, mt=5),
                           gaia_on=True, timesteps=timesteps, env=tenv))


def _assert_history(want, got):
    assert len(want) == len(got)
    for (w0, mf0, lcr0, tec0), (w1, mf1, lcr1, tec1) in zip(want, got):
        assert (w0, mf0, tec0) == (w1, mf1, tec1)
        assert abs(lcr0 - lcr1) <= 1e-6


def test_config_shares_fields_and_defaults():
    rf = {f.name: f.default for f in dataclasses.fields(rtune.SelfTuneConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttune.SelfTuneConfig)}
    assert rf == tf


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, dict(mf0=1.1, step0=0.9))])
def test_intra_run_tune_equals_reference(seed, kw):
    rc, tc = _cfgs()
    _, want = rtune.intra_run_tune(jax.random.key(seed), rc,
                                   rtune.SelfTuneConfig(**{**TC, **kw}))
    _, got = ttune.intra_run_tune(trandom.key(seed), tc,
                                  ttune.SelfTuneConfig(**{**TC, **kw}),
                                  device=CPU)
    _assert_history(want, got)
    assert len(got) == 6
    assert all(1.05 <= mf <= 19.0 for _, mf, _, _ in got)
    if not kw:  # the descent the reference's test asserts
        assert got[-1][1] < got[0][1] * 0.7 and got[-1][3] < got[0][3]


def test_intra_run_tune_batch_equals_reference_and_solo():
    rc, tc = _cfgs(timesteps=90)
    _, want = rtune.intra_run_tune_batch(rc, rtune.SelfTuneConfig(**TC),
                                         seeds=(0, 4))
    states, got = ttune.intra_run_tune_batch(tc, ttune.SelfTuneConfig(**TC),
                                             seeds=(0, 4), device=CPU)
    assert states["key"].shape == (2, 2)
    for w, g, seed in zip(want, got, (0, 4)):
        _assert_history(w, g)
        _, solo = ttune.intra_run_tune(trandom.key(seed), tc,
                                       ttune.SelfTuneConfig(**TC),
                                       device=CPU)
        assert g == solo, seed
    assert got[0] != got[1]


def test_inter_run_tune_equals_reference():
    rc, tc = _cfgs(timesteps=90)
    best_r, trials_r = rtune.inter_run_tune(
        jax.random.key(2), rc, rtune.SelfTuneConfig(**TC), n_probes=4)
    best_t, trials_t = ttune.inter_run_tune(
        trandom.key(2), tc, ttune.SelfTuneConfig(**TC), n_probes=4,
        device=CPU)
    assert trials_t == trials_r
    assert best_t == best_r


def test_env_pricing_follows_the_reference():
    """2 KiB migrations priced on the homogeneous model and on shm:
    the port's histories are the reference's, whatever directions they
    take (the reference's own test of them is red)."""
    tc_kw = dict(TC, migration_bytes=2048)
    for env in (None, "shm"):
        rc, tc = _cfgs(env=env)
        _, want = rtune.intra_run_tune(jax.random.key(0), rc,
                                       rtune.SelfTuneConfig(**tc_kw))
        _, got = ttune.intra_run_tune(trandom.key(0), tc,
                                      ttune.SelfTuneConfig(**tc_kw),
                                      device=CPU)
        _assert_history(want, got)


def test_tuners_default_to_the_card():
    _, tc = _cfgs(timesteps=30)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    for call in (
            lambda: ttune.intra_run_tune(trandom.key(0), tc,
                                         ttune.SelfTuneConfig(window=30)),
            lambda: ttune.intra_run_tune_batch(
                tc, ttune.SelfTuneConfig(window=30), seeds=(0, 1)),
            lambda: ttune.inter_run_tune(trandom.key(0), tc,
                                         ttune.SelfTuneConfig(), 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
