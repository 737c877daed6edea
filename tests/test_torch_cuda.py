"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card (skipped without one — the fixture decides at
run time). The file imports nothing of JAX, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hashmap import IdHashMap
from repro_torch.kernels import embedding_lookup as port_el
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref


@pytest.fixture
def cuda():
    """The CUDA device; decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (nvcc builds the kernels on first "
                    "use)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["vmem", "hbm"])
def test_probe_kernels_match_plain_on_card(cuda, placement):
    rng = np.random.default_rng(11)
    m = IdHashMap(1 << 12)
    ids = rng.choice(1 << 40, size=900, replace=False).astype(np.int64)
    m.put(ids, np.arange(900))
    m.delete(ids[:100])
    qs = torch.from_numpy(np.concatenate(
        [ids, ids + 1, np.array([-2 ** 63, -2 ** 63 + 1])])).to(cuda)
    keys = torch.from_numpy(m.key_table.copy()).to(cuda)
    if placement == "hbm":
        keys = port_ref.wrap_pad(keys, cap=m.capacity)
    before = port_ops.launch_counts()
    pos, found = port_ops.hashmap_probe(keys, qs, shift=int(m.shift),
                                        placement=placement)
    name = "hashmap_probe" if placement == "vmem" else "hashmap_probe_hbm"
    assert port_ops.launch_counts()[name] == before[name] + 1
    plain = port_ref.hashmap_probe if placement == "vmem" \
        else port_ref.hashmap_probe_hbm
    ppos, pfound = plain(keys, qs, shift=int(m.shift))
    assert torch.equal(found, pfound)
    assert torch.equal(pos[found], ppos[pfound])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 9])
def test_copy_kernels_match_plain_on_card(cuda, d):
    table = torch.randn(1000, d, device=cuda)
    ids = torch.randint(0, 1000, (333,), device=cuda, dtype=torch.int32)
    assert torch.equal(port_el.embedding_lookup(table, ids),
                       port_ref.embedding_lookup(table, ids))
    uniq = torch.randperm(1000, device=cuda)[:333].to(torch.int32)
    upd = torch.randn(333, d, device=cuda)
    assert torch.equal(port_el.embedding_scatter(table.clone(), uniq, upd),
                       port_ref.embedding_scatter(table.clone(), uniq, upd))
