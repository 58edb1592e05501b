"""The sharded engine across `torch.distributed` processes (gloo, on the
CPU): 2 processes x 2 shards give the unsharded state and counters of
1 process x 4 shards (and of the oracle), and the launcher's RESULT
line equals the in-process run of its config."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.parallel import multihost  # noqa: E402

CPU = torch.device("cpu")
torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CLUSTER = dict(n_groups=4, group_radius=120.0)
#: worlds through every collective: the sparse halo with migrations and
#: a repartition, the flock's gathers, the dense path with the epidemic
WORLDS = {
    "hotspot": dict(mobility="hotspot", partitioner="kmeans", **CLUSTER),
    "flock": dict(mobility="flock", **CLUSTER),
    "dense": dict(proximity_backend="dense", area=600.0,
                  interaction_range=150.0, workload="epidemic",
                  epi_beta=0.3),
}


def _cfg(world):
    return T.EngineConfig(
        abm=T.ABMConfig(**{"n_se": 400, "area": 1000.0,
                           "interaction_range": 60.0, **WORLDS[world]}),
        heuristic=T.HeuristicConfig(mf=1.2, mt=5), timesteps=12,
        repartition_every=6 if world == "hotspot" else 0,
        sharding="lp_device", n_devices=4)


#: one rank: init gloo, run every world, save rank 0's results
WORKER = """
import json, sys, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://" + addr,
                        world_size=2, rank=rank)
sys.path.insert(0, sys.argv[4])
from test_torch_multihost import WORLDS, _cfg
from repro_torch import random as trandom
from repro_torch.core import engine as teng
res = {}
for w in WORLDS:
    st, ser, cnt = teng._run(trandom.key(3), _cfg(w), torch.device("cpu"))
    res[w] = cnt
    if rank == 0:
        np.savez(out + w + ".npz", **teng.state_to_numpy(st))
if rank == 0:
    json.dump(res, open(out + "counters.json", "w"))
dist.destroy_process_group()
"""


def _spawn(cmds, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return outs


def test_two_processes_equal_one_process_and_the_oracle(tmp_path):
    addr = f"127.0.0.1:{multihost._free_port()}"
    out = str(tmp_path / "r0-")
    tests = os.path.dirname(os.path.abspath(__file__))
    _spawn([[sys.executable, "-c", WORKER, str(r), addr, out, tests]
            for r in range(2)])
    counters = json.load(open(out + "counters.json"))
    for w in WORLDS:
        cfg = _cfg(w)
        st, _, cnt = T.Engine(cfg, device=CPU).run(seed=3)
        ost, _, ocnt = T.Engine(dataclasses.replace(cfg, sharding="none"),
                                device=CPU).run(seed=3)
        got = np.load(out + w + ".npz")
        one = teng.state_to_numpy(st)
        oracle = teng.state_to_numpy(ost)
        for k in ("pos", "lp", "mob", "epi", "ring", "pending_dst",
                  "last_mig"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
            np.testing.assert_array_equal(got[k], oracle[k], err_msg=k)
        assert counters[w] == json.loads(json.dumps(cnt)), w
        assert cnt["migrations"] == ocnt["migrations"] > 0
        assert cnt["shard_overflow"] == 0


def test_launcher_result_equals_the_in_process_run():
    """`--spawn` of 2 gloo ranks x 2 shards: rank 0's RESULT is the
    warm-up-then-timed window of one process holding all 4 shards."""
    args = ["--processes", "2", "--local-shards", "2", "--backend", "gloo",
            "--n-se", "400", "--n-lp", "4", "--steps",
            "5", "--mobility", "hotspot"]
    out = _spawn([[sys.executable, "-m", "repro_torch.parallel.multihost",
                   "--spawn", *args]])[0]
    result = json.loads(next(line for line in out.splitlines()
                             if line.startswith("RESULT "))[7:])
    a = multihost.parser().parse_args(args)
    cfg = dataclasses.replace(multihost.build_config(a), n_devices=4)
    eng = T.Engine(cfg, device=CPU).init(seed=0)
    eng.step(5)
    c = eng.step(5)
    assert result["devices"] == 4 and result["processes"] == 2
    for k in ("bytes_on_wire", "migrations", "shard_overflow"):
        assert result[k] == c[k], k
    assert result["mean_lcr"] == round(c["mean_lcr"], 4)
    assert result["mean_halo_frac"] == round(c["mean_halo_frac"], 4)
    assert c["bytes_on_wire"] > 0 and c["shard_overflow"] == 0
