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


def _ftrl_inputs(b, d, seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(b, d)) * 1.5).astype(np.float32)
    n = rng.uniform(0, 4, size=(b, d)).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    z[0] = 0.0                                        # all-zero rows
    n[0] = 0.0
    g[0] = 0.0
    return z, n, g


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4097])
@pytest.mark.parametrize("d", [1, 8, 9])
def test_ftrl_kernel_matches_plain_on_card(cuda, b, d):
    from repro_torch.kernels import ftrl_row_update as port_ftrl
    z, n, g = (torch.from_numpy(a).to(cuda)
               for a in _ftrl_inputs(b, d, b + d))
    kw = dict(alpha=0.05, beta=1.0, l1=0.5, l2=1.0)
    before = port_ftrl.ftrl_row_update.launches
    got = port_ftrl.ftrl_row_update(z, n, g, **kw)
    assert port_ftrl.ftrl_row_update.launches == before + 1
    for a, w in zip(got, port_ref.ftrl_row_update(z, n, g, **kw)):
        assert torch.equal(a, w)
    # and the card's plain version equals the CPU's
    for a, w in zip(got, port_ref.ftrl_row_update(z.cpu(), n.cpu(), g.cpu(),
                                                  **kw)):
        assert torch.equal(a.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4097])
@pytest.mark.parametrize("d", [1, 8, 9])
def test_codec_kernels_match_plain_on_card(cuda, b, d):
    from repro_torch.kernels import delta_codec as port_dc
    rng = np.random.default_rng(b * d)
    x = (rng.normal(size=(b, d))
         * 10.0 ** rng.uniform(-4, 4, size=(b, 1))).astype(np.float32)
    x[0] = 0.0                                        # scale 1e-12, codes 0
    x = torch.from_numpy(x).to(cuda)
    q, s = port_dc.quantize_rows(x)
    pq, ps = port_ref.quantize_rows(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert bool((q[0] == 0).all()) and float(s[0, 0]) == float(
        np.float32(1e-12))
    cq, cs = port_ref.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
    assert torch.equal(port_dc.dequantize_rows(q, s),
                       port_ref.dequantize_rows(q, s))


@pytest.mark.cuda
def test_fused_ftrl_apply_on_card_matches_cpu_chain(cuda):
    """probe → gather → FTRL → scatter on the card: arenas and row
    outputs bit-equal to the same chain on the CPU (plain versions)."""
    rng = np.random.default_rng(21)
    m = IdHashMap(1 << 12)
    ids = rng.choice(1 << 40, size=1500, replace=False).astype(np.int64)
    m.put(ids, rng.permutation(2000)[:1500])
    z, n, _ = _ftrl_inputs(2000, 8, 3)
    w = np.zeros((2000, 8), np.float32)
    q = rng.permutation(ids)[:700]
    grads = rng.normal(size=(700, 8)).astype(np.float32)
    kw = dict(shift=int(m.shift), alpha=0.05, beta=1.0, l1=0.5, l2=1.0)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        t = [torch.from_numpy(a.copy()).to(dev) for a in
             (m.key_table, m.val_table.astype(np.int32), z, n, w, q, grads)]
        rows = port_ops.fused_ftrl_apply(*t, **kw)
        outs[dev.type] = [a.cpu() for a in (*t[2:5], *rows)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)
    assert bool(outs["cuda"][-1].all())               # every id found
