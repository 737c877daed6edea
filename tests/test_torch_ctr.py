"""The port's CTR predict functions against the JAX package's.

Same numpy rows and dense tensors into both; the reference's numbers
come out of XLA and the port's out of PyTorch, which sum in another
order, so the stated tolerance is fp32 ``rtol=1e-5, atol=1e-6`` (the
measured deviation is reported). The DNN's dense head comes from the
reference's ``init_dense`` as numpy."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import weips_ctr as ref_cfgs
from repro.models import ctr as ref_ctr
from repro_torch.configs import weips_ctr as port_cfgs
from repro_torch.models import ctr as port_ctr

CASES = [("LR_FTRL", 6), ("FM_FTRL", 6), ("DNN_ADAM", 6), ("FM_FTRL", 32)]


def _inputs(name, fields, b=16, seed=0):
    rcfg = dataclasses.replace(getattr(ref_cfgs, name), fields=fields)
    pcfg = dataclasses.replace(getattr(port_cfgs, name), fields=fields)
    rng = np.random.default_rng(seed)
    groups = ref_ctr.groups_for(rcfg)
    assert groups == port_ctr.groups_for(pcfg)
    offsets, lo = {}, 0
    for g, dim in groups.items():
        offsets[g] = (lo, lo + dim)
        lo += dim
    block = (0.3 * rng.standard_normal((b * fields, lo))).astype(np.float32)
    dense = {k: np.array(v) for k, v in
             ref_ctr.init_dense(rcfg, jax.random.PRNGKey(seed)).items()}
    return rcfg, pcfg, offsets, block, dense


@pytest.mark.parametrize("name,fields", CASES)
def test_predict_block_matches_reference(name, fields):
    rcfg, pcfg, offsets, block, dense = _inputs(name, fields)
    want = np.asarray(ref_ctr.predict_block_fn(rcfg, offsets)(block, dense))
    got = port_ctr.predict_block_fn(pcfg, offsets)(
        torch.from_numpy(block),
        {k: torch.from_numpy(v) for k, v in dense.items()}).numpy()
    dev = float(np.abs(got - want).max())
    print(f"{name} fields={fields}: max |port - reference| = {dev:.3g}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,fields", CASES[:3])
def test_predict_rows_matches_reference(name, fields):
    rcfg, pcfg, offsets, block, dense = _inputs(name, fields, seed=1)
    rows = {g: block[:, lo:hi].reshape(-1, fields, hi - lo)
            for g, (lo, hi) in offsets.items()}
    want = np.asarray(ref_ctr.predict_fn(rcfg)(rows, dense))
    got = port_ctr.predict_fn(pcfg)(
        {g: torch.from_numpy(np.ascontiguousarray(v))
         for g, v in rows.items()},
        {k: torch.from_numpy(v) for k, v in dense.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_scenario_groups_and_dense_shapes_match_reference():
    for name in ("LR_FTRL", "FM_FTRL", "FM_SGD", "DNN_ADAM"):
        rcfg, pcfg = getattr(ref_cfgs, name), getattr(port_cfgs, name)
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
        assert port_ctr.dense_shapes(pcfg) == ref_ctr.dense_shapes(rcfg)
    with pytest.raises(ValueError):
        port_ctr.check_scenario_groups({"v": 8}, {"w": 1})
    with pytest.raises(ValueError):
        port_ctr.check_scenario_groups({"w": 2}, {"w": 1})
    port_ctr.check_scenario_groups({"w": 1}, {"w": 1, "v": 8})
