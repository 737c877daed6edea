"""Shared helpers of the port's runtime and chaos tests: the chaos suite's
cluster shape and step budget (``tests/chaos/_harness.py``) on the port's
``ClusterRuntime``, and bit-equality of canonical table dumps. Imports
nothing of JAX, so ``tests/test_torch_cuda.py`` can use it too."""

from __future__ import annotations

import numpy as np

from repro_torch.launch.runtime import ClusterRuntime, RuntimeConfig

STEPS = 14
MASTERS = ["master-0", "master-1"]
SLAVES = ["slave-0.0", "slave-1.0"]

# the reference chaos suite's shape: a run is only comparable to one that
# used the identical config
CLUSTER_KW = dict(num_master=2, num_slave=2, num_replicas=1,
                  num_partitions=4, ckpt_every=4)
# the port's engines on the CPU: its torch backends (the kernels' plain
# versions) and its numpy backends (the host paths)
ENGINES = {"torch": dict(device="cpu"),
           "numpy": dict(device="cpu", ps_backend="numpy",
                         codec_backend="numpy")}


def make_runtime(root, plan=None, **overrides) -> ClusterRuntime:
    kw = dict(CLUSTER_KW, **ENGINES["torch"])
    kw.update(overrides)
    return ClusterRuntime(RuntimeConfig(root=str(root), **kw), plan)


def summary(rt) -> dict:
    """End state of a run: what the trajectory tests compare."""
    return {"recoveries": rt.recoveries,
            "masters": rt.master_state(), "slaves": rt.slave_state(),
            "offsets": {n: rt.clients[n].call("offsets")
                        for n in rt.slave_names()},
            "metrics": rt.cluster_metrics(),
            "last_recovery": getattr(rt, "last_recovery", None)}


def run_cluster(root, plan=None, steps=STEPS, runtime=make_runtime,
                **overrides) -> dict:
    """Run a cluster to ``steps`` and return its end-state summary."""
    rt = runtime(root, plan, **overrides)
    try:
        rt.start()
        rt.run_to(steps)
        return summary(rt)
    finally:
        rt.shutdown()


def tables_equal(a: dict, b: dict) -> bool:
    """Bit-equality of two canonical table dumps (ids, w, slots)."""
    return (np.array_equal(a["ids"], b["ids"])
            and np.array_equal(a["w"], b["w"])
            and sorted(a["slots"]) == sorted(b["slots"])
            and all(np.array_equal(a["slots"][k], b["slots"][k])
                    for k in a["slots"]))


def assert_states_equal(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), \
        f"{what}: shard sets differ: {sorted(got)} vs {sorted(want)}"
    for name in want:
        assert len(want[name]["ids"]), f"{what}: {name} is empty"
        assert tables_equal(got[name], want[name]), \
            f"{what}: state of {name} is not bit-equal"


def assert_slaves_consistent(masters: dict, slaves: dict) -> None:
    """Every slave row holds exactly the master's current serve weight for
    that id (FTRL stores the derived serve weight in w)."""
    want = {}
    for st in masters.values():
        for i, wid in enumerate(st["ids"]):
            want[int(wid)] = st["w"][i]
    for name, st in slaves.items():
        assert len(st["ids"]), f"{name} is empty"
        for i, wid in enumerate(st["ids"]):
            assert int(wid) in want, f"{name} serves unknown id {wid}"
            assert np.array_equal(st["w"][i], want[int(wid)]), \
                f"{name} serves stale value for id {wid}"
