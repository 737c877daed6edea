"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card (skipped without one — the fixture decides at
run time). The file imports nothing of JAX, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402
from chip_smoke import zipf_ids  # noqa: E402
from repro_torch.core.hashmap import IdHashMap
from repro_torch.kernels import embedding_lookup as port_el
from repro_torch.kernels import hashmap_probe as port_hm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from test_torch_probe_tail import cases as probe_cases
from test_torch_probe_tail import full_case


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


def _probe_hbm(m, qs, dev):
    """``hashmap_probe_hbm`` on the card over ``m``'s wrap-padded table:
    one launch, ``pos`` and ``found`` equal to the plain version's
    everywhere (``pos`` the home slot where not found, 0 for sentinels).
    Returns them on the host."""
    keys = port_ref.wrap_pad(torch.from_numpy(m.key_table.copy()).to(dev),
                             cap=m.capacity)
    q = torch.from_numpy(qs).to(dev)
    before = port_hm.hashmap_probe_hbm.launches
    pos, found = port_hm.hashmap_probe_hbm(keys, q, shift=int(m.shift))
    assert port_hm.hashmap_probe_hbm.launches == before + 1
    ppos, pfound = port_ref.hashmap_probe_hbm(keys, q, shift=int(m.shift))
    assert torch.equal(found, pfound)
    assert torch.equal(pos, ppos)
    assert not found[q <= port_ref.TOMB].any()
    assert (pos[q <= port_ref.TOMB] == 0).all()
    return pos.cpu().numpy(), found.cpu().numpy()


def _same_as_host(m, qs, pos, found):
    h_pos, h_found = m._probe(qs)
    np.testing.assert_array_equal(found, h_found)
    np.testing.assert_array_equal(pos[found], h_pos[h_found])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(probe_cases()))
def test_probe_hbm_kernel_cases_on_card(cuda, name):
    """Every ``PROBE_CASES`` size (cap = 16: the wrap pad is shorter than
    a 32-slot read, so the kernel must fold), the chain case, and the gap
    case (an EMPTY before a hit in one group)."""
    m, qs = probe_cases()[name]
    _same_as_host(m, qs, *_probe_hbm(m, qs, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [16, 64, 4096])
def test_probe_hbm_kernel_full_table_on_card(cuda, cap):
    """No EMPTY slot (live and TOMB only): live keys found where the host
    finds them, other ids not found, and the call ends (the walk stops at
    the host's cap / 8 + 2 groups); a table of TOMBs finds nothing."""
    m, live, absent = full_case(cap, cap)
    pos, found = _probe_hbm(m, np.concatenate([live, absent]), cuda)
    assert found[:len(live)].all() and not found[len(live):].any()
    _same_as_host(m, live, pos[:len(live)], found[:len(live)])
    m._keys[:] = port_ref.TOMB
    _, found = _probe_hbm(m, live, cuda)
    assert not found.any()


@pytest.mark.cuda
def test_probe_hbm_kernel_crafted_cluster_on_card(cuda):
    """A collision cluster of 700 ids at one home (more than 256 slots
    long), every one of them queried, with ids that walk it to its end."""
    m, qs = smoke.probe_case(16, (1 << 16) // 5, 8192,
                             np.random.default_rng(3))
    _same_as_host(m, qs, *_probe_hbm(m, qs, cuda))


@pytest.mark.cuda
def test_probe_hbm_kernel_past_a_wave_on_card(cuda):
    """300,000 ids: more than one wave of the card holds (132 SMs x 2,048
    threads = 270,336 at most), so warps walk on past their first 32."""
    rng = np.random.default_rng(4)
    m = IdHashMap(1 << 18)
    ids = rng.choice(1 << 40, size=60_000, replace=False).astype(np.int64)
    m.put(ids, np.arange(len(ids)))
    m.delete(ids[:5_000])
    pool = np.concatenate([ids, rng.integers(-2 ** 62, 2 ** 62, 20_000),
                           np.array([-2 ** 63, -2 ** 63 + 1])])
    qs = pool[rng.integers(0, len(pool), size=300_000)]
    _same_as_host(m, qs, *_probe_hbm(m, qs, cuda))


@pytest.mark.cuda
def test_probe_hbm_kernel_in_a_cuda_graph_on_card(cuda):
    """Captured in a CUDA graph (no host sync, no allocation in the C
    entry) and replayed, it gives the eager call's outputs."""
    m, qs = probe_cases()["chain"]
    keys = port_ref.wrap_pad(torch.from_numpy(m.key_table.copy()).to(cuda),
                             cap=m.capacity)
    q = torch.from_numpy(qs).to(cuda)
    shift = int(m.shift)
    want = port_hm.hashmap_probe_hbm(keys, q, shift=shift)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = port_hm.hashmap_probe_hbm(keys, q, shift=shift)
    got[0].zero_()
    got[1].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (dtype, D) of the copy cases: every branch of copy_plan and of the C
# dispatch — narrow rows with the compile-time widths (1 and 9 4-byte
# words, 2 16-byte words) and with run-time widths (8-byte D = 2, 4-byte
# D = 3 and 17, 16-byte D = 64, 2-byte and 1-byte words), wide rows of
# 192 16-byte words (the LM's token rows) and of run-time widths (an odd
# bf16 width in 2-byte words, an odd uint8 width in 1-byte words)
COPY_CASES = [(torch.float32, d) for d in (1, 2, 3, 8, 9, 17, 64)] + [
    (torch.bfloat16, 1536), (torch.bfloat16, 1537), (torch.uint8, 7),
    (torch.uint8, 101)]
# more ids than one wave of tiles holds (132 SMs x 2,048 threads: 270,336
# narrow rows or 8,448 wide rows at full occupancy)
WAVE_N = {False: 300_000, True: 20_000}


def _rows(dtype, n, d, gen, device):
    if dtype == torch.uint8:
        return torch.randint(0, 256, (n, d), dtype=dtype, generator=gen,
                             device=device)
    return torch.randn(n, d, generator=gen, device=device).to(dtype)


def _copy_inputs(dtype, n, d, device, seed, offset=0):
    """A table of max(n, 1000) + 1 rows (a view ``offset`` elements into
    its storage), gather ids that hold the last row, unique scatter ids
    that hold it too, and updates."""
    gen = torch.Generator(device=device).manual_seed(seed)
    v = max(n, 1000) + 1
    flat = _rows(dtype, v * d + offset, 1, gen, device).reshape(-1)
    table = flat[offset:].view(v, d)
    ids = torch.randint(0, v, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    ids[-1] = v - 1
    perm = torch.randperm(v - 1, generator=gen, device=device)[:n - 1]
    uniq = torch.cat([perm, torch.tensor([v - 1], device=device)]).to(
        torch.int32)
    return table, ids, uniq, _rows(dtype, n, d, gen, device)


def _check_copies(table, ids, uniq, upd):
    """Both copy kernels bit-equal to their plain versions, one launch a
    call (the scatter-set writes into ``table`` itself, so that a view's
    alignment is what the kernel sees)."""
    before = port_ops.launch_counts()
    got = port_el.embedding_lookup(table, ids)
    assert port_ops.launch_counts()["embedding_lookup"] \
        == before["embedding_lookup"] + 1
    assert torch.equal(got, port_ref.embedding_lookup(table, ids))
    want = port_ref.embedding_scatter(table.clone(), uniq, upd)
    got = port_el.embedding_scatter(table, uniq, upd)   # in place
    assert got is table
    assert port_ops.launch_counts()["embedding_scatter"] \
        == before["embedding_scatter"] + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, "wave"])
@pytest.mark.parametrize("dtype,d", COPY_CASES,
                         ids=[f"{str(t)[6:]}-{d}" for t, d in COPY_CASES])
def test_copy_kernels_match_plain_on_card(cuda, dtype, d, n):
    if n == "wave":
        probe = torch.empty(1, d, dtype=dtype)
        n = WAVE_N[port_el.copy_plan(probe, probe)[2]]
    _check_copies(*_copy_inputs(dtype, n, d, cuda, seed=n * 7 + d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,word", [
    (torch.float32, 8, 4), (torch.float32, 9, 4), (torch.float32, 64, 4),
    (torch.bfloat16, 1536, 2), (torch.bfloat16, 8, 2)])
def test_copy_kernels_on_a_misaligned_table_on_card(cuda, dtype, d, word):
    """A table view one element into its storage, so no 16-byte word
    divides its rows' addresses: the kernels take narrower words."""
    table, ids, uniq, upd = _copy_inputs(dtype, 333, d, cuda, seed=d,
                                         offset=1)
    assert port_el.copy_plan(table, upd)[0] == word
    _check_copies(table, ids, uniq, upd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 9), (torch.float32, 8),
                                     (torch.bfloat16, 1536)])
def test_copy_kernels_in_a_cuda_graph_on_card(cuda, dtype, d):
    """A gather and a scatter-set captured in a CUDA graph and replayed
    equal the plain versions; each replay launches no counted call."""
    table, ids, uniq, upd = _copy_inputs(dtype, 4096, d, cuda, seed=5)
    work = table.clone()
    for _ in range(2):                          # warm up: build and load
        port_el.embedding_lookup(table, ids)
        port_el.embedding_scatter(work, uniq, upd)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = port_el.embedding_lookup(table, ids)
        port_el.embedding_scatter(work, uniq, upd)
    work.copy_(table)
    out.zero_()
    before = port_ops.launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert port_ops.launch_counts() == before
    assert torch.equal(out, port_ref.embedding_lookup(table, ids))
    assert torch.equal(work, port_ref.embedding_scatter(table.clone(), uniq,
                                                        upd))


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


# row widths of the codec cases: every regime of codec_plan at its edges
# (narrow <= 16 with the compile-time 1, 8 and 9; warp <= 2,048; block
# <= 16,384; split beyond, with ragged last tiles), in float4 words where
# the width allows them and in floats
CODEC_WIDTHS = [1, 2, 3, 4, 7, 8, 9, 12, 16, 17, 20, 1536, 2047, 2048, 2049,
                2052, 16384, 16385, 16388, 100_003]


def _codec_case(b, d, device, seed, offset=0):
    """codec_rows(b, d) on ``device``, as a view ``offset`` elements into
    its buffer (offset 1: no pointer is 16-byte aligned)."""
    x = torch.from_numpy(smoke.codec_rows(b, d, seed).reshape(-1))
    buf = torch.empty(b * d + offset, device=device)
    buf[offset:] = x.to(device)
    return buf[offset:].view(b, d)


def _check_codec(x, want_launches):
    """Both kernels on ``x`` against the CPU's plain version (NaN rows
    included) and the card's (finite rows); ``want_launches`` quantize
    launches and one dequantize launch."""
    from repro_torch.kernels import delta_codec as port_dc
    before = port_ops.launch_counts()
    q, s = port_dc.quantize_rows(x)
    out = port_dc.dequantize_rows(q, s)
    torch.cuda.synchronize()
    counts = port_ops.launch_counts()
    assert counts["quantize_rows"] == before["quantize_rows"] + want_launches
    assert counts["dequantize_rows"] == before["dequantize_rows"] + 1
    cq, csc = port_ref.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and smoke.codec_same(s.cpu(), csc)
    assert smoke.codec_same(out.cpu(), port_ref.dequantize_rows(cq, csc))
    k = smoke.CODEC_SPECIAL
    pq, ps = port_ref.quantize_rows(x[k:])
    assert torch.equal(q[k:], pq) and torch.equal(s[k:], ps)
    assert torch.equal(out[k:], port_ref.dequantize_rows(pq, ps))
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", CODEC_WIDTHS)
def test_codec_plan_regimes_on_card(cuda, d, offset):
    """Each regime and word of codec_plan, NaN / Inf / zero rows first:
    codes and scales as the CPU's plain version gives them; a misaligned
    view takes float words, and a misaligned code view decodes the same."""
    from repro_torch.kernels import delta_codec as port_dc
    b = 300 if d <= port_dc.WARP_MAX else 37 if d <= port_dc.BLOCK_MAX else 7
    x = _codec_case(b, d, cuda, seed=d + offset, offset=offset)
    plan = port_dc.codec_plan(d, x.data_ptr())
    assert plan.word == (16 if d % 4 == 0 and offset == 0 else 4)
    q, s = _check_codec(x, plan.quantize_launches)
    qbuf = torch.empty(b * d + 1, dtype=torch.int8, device=cuda)
    qv = qbuf[1:].view(b, d)
    qv.copy_(q)
    assert smoke.codec_same(port_dc.dequantize_rows(qv, s),
                         port_dc.dequantize_rows(q, s))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", [(600_000, 1), (600_000, 8), (600_000, 9),
                                 (20_000, 17), (20_000, 1536)])
def test_codec_past_a_wave_on_card(cuda, b, d):
    """More rows than the card runs at once (132 SMs x 2,048 threads):
    the grid walks the rest; one launch a call."""
    _check_codec(_codec_case(b, d, cuda, seed=b + d), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 1536, 16384, 100_003])
def test_codec_in_a_cuda_graph_on_card(cuda, d):
    """quantize (a split row's two passes and the zeroed absmax word
    included) and dequantize captured in a CUDA graph and replayed equal
    the eager calls; a replay counts no launch."""
    from repro_torch.kernels import delta_codec as port_dc
    x = _codec_case(64, d, cuda, seed=d)
    want_q, want_s = port_dc.quantize_rows(x)
    want = port_dc.dequantize_rows(want_q, want_s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = port_dc.quantize_rows(x)
        out = port_dc.dequantize_rows(q, s)
    q.zero_()
    out.zero_()
    before = port_ops.launch_counts()
    graph.replay()
    graph.replay()                    # the absmax word is zeroed again
    torch.cuda.synchronize()
    assert port_ops.launch_counts() == before
    assert torch.equal(q, want_q) and smoke.codec_same(s, want_s)
    assert smoke.codec_same(out, want)


@pytest.mark.cuda
def test_codec_lm_leaf_on_card(cuda):
    """One MLP stack of qwen2-1.5b as ONE row (28 x 1536 x 8960 floats),
    as ModelSyncEngine encodes it: two quantize launches, one dequantize,
    bit-equal to the plain version on the card and on the CPU."""
    from repro_torch.kernels import delta_codec as port_dc
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = 0.02 * torch.randn(1, 28 * 1536 * 8960, generator=gen, device=cuda)
    before = port_ops.launch_counts()
    q, s = port_dc.quantize_rows(x)
    out = port_dc.dequantize_rows(q, s)
    torch.cuda.synchronize()
    counts = port_ops.launch_counts()
    assert counts["quantize_rows"] == before["quantize_rows"] + 2
    assert counts["dequantize_rows"] == before["dequantize_rows"] + 1
    pq, ps = port_ref.quantize_rows(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(out, port_ref.dequantize_rows(pq, ps))
    del pq, out
    cq, csc = port_ref.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), csc)


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


def _slots_inputs(b, d, w_dtype, device, seed, offset=0):
    """Arguments of ``ftrl_apply_slots`` on ``device``: (z, n, w) arenas of
    b + 500 rows (views ``offset`` floats into their storage), a 2^14-slot
    value table mapping b unique probe positions onto distinct arena rows,
    ``found`` all True, gradient rows holding a zero row, NaN and ±Inf."""
    rng = np.random.default_rng(seed)
    rows = b + 500
    z, n, _ = _ftrl_inputs(rows, d, seed)

    def arena(a, dtype=torch.float32):
        flat = torch.zeros(rows * d + offset, dtype=dtype, device=device)
        view = flat[offset:].view(rows, d)
        view.copy_(torch.from_numpy(a))
        return view

    w = rng.normal(size=(rows, d)).astype(np.float32)
    slot_of = rng.integers(0, rows, size=1 << 14).astype(np.int32)
    pos = rng.choice(1 << 14, size=b, replace=False).astype(np.int32)
    slot_of[pos] = rng.permutation(rows)[:b]
    g = rng.normal(size=(b, d)).astype(np.float32)
    g.reshape(-1)[1:4] = [np.nan, np.inf, -np.inf][:b * d - 1]
    up = lambda a: torch.from_numpy(a).to(device)
    return dict(pos=up(pos), found=torch.ones(b, dtype=torch.bool,
                                              device=device),
                slot_of=up(slot_of), z_arena=arena(z), n_arena=arena(n),
                w_arena=arena(w).to(w_dtype) if offset == 0
                else arena(w, w_dtype), grads=up(g))


FTRL_KW = dict(alpha=0.05, beta=1.0, l1=0.5, l2=1.0)


def _check_apply_slots(args):
    """The kernel and its plain version on copies of the same arenas, on
    the card, and the plain version on the CPU: arenas and row outputs
    bit-equal (NaN for NaN). One launch, counted on ``ftrl_row_update``;
    no gather or scatter-set."""
    from repro_torch.kernels import ftrl_row_update as port_ftrl
    arenas = ("z_arena", "n_arena", "w_arena")
    plain = {k: v.clone() if k in arenas else v for k, v in args.items()}
    host = {k: v.cpu() for k, v in args.items()}
    before = port_ops.launch_counts()
    got = port_ftrl.ftrl_apply_slots(**args, **FTRL_KW)
    after = port_ops.launch_counts()
    assert after["ftrl_row_update"] == before["ftrl_row_update"] + 1
    for k in ("embedding_lookup", "embedding_scatter"):
        assert after[k] == before[k]
    want = port_ref.ftrl_apply_slots(**plain, **FTRL_KW)
    cpu = port_ref.ftrl_apply_slots(**host, **FTRL_KW)
    for a, w, c in zip([*got, *(args[k] for k in arenas)],
                       [*want, *(plain[k] for k in arenas)],
                       [*cpu, *(host[k] for k in arenas)]):
        assert smoke.codec_same(a, w) and smoke.codec_same(a.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.float16,
                                     torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4097])
@pytest.mark.parametrize("d", [1, 4, 8, 9])
def test_ftrl_apply_slots_matches_plain_on_card(cuda, d, b, w_dtype):
    _check_apply_slots(_slots_inputs(b, d, w_dtype, cuda, seed=b + d))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_ftrl_apply_slots_on_a_misaligned_arena_on_card(cuda, w_dtype):
    """Arenas one element into their storage (no 16-byte boundary under
    their rows): the pass makes no alignment assumption."""
    args = _slots_inputs(999, 8, w_dtype, cuda, seed=8, offset=1)
    assert args["z_arena"].data_ptr() % 16 and args["w_arena"].data_ptr() % 8
    _check_apply_slots(args)


def _push_case(device, d=8, b=700, seed=21):
    """A 4,096-slot map of 1,500 ids, (z, n, w) arenas of 2,000 rows and a
    push of ``b`` unique present ids, on ``device``."""
    rng = np.random.default_rng(seed)
    m = IdHashMap(1 << 12)
    ids = rng.choice(1 << 40, size=1500, replace=False).astype(np.int64)
    m.put(ids, rng.permutation(2000)[:1500])
    z, n, _ = _ftrl_inputs(2000, d, seed)
    w = np.zeros((2000, d), np.float32)
    q = rng.permutation(ids)[:b]
    grads = rng.normal(size=(b, d)).astype(np.float32)
    t = [torch.from_numpy(a.copy()).to(device) for a in
         (m.key_table, m.val_table.astype(np.int32), z, n, w, q, grads)]
    return t, dict(shift=int(m.shift), **FTRL_KW)


@pytest.mark.cuda
def test_fused_ftrl_apply_is_probe_and_one_pass_on_card(cuda):
    """``ops.fused_ftrl_apply`` on the card: one probe launch and one
    ``ftrl_apply_slots`` launch (counted on ``ftrl_row_update``), no
    gather and no scatter-set."""
    t, kw = _push_case(cuda)
    before = port_ops.launch_counts()
    port_ops.fused_ftrl_apply(*t, **kw)
    after = port_ops.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["hashmap_probe"] + delta["hashmap_probe_hbm"] == 1
    assert delta["ftrl_row_update"] == 1
    assert delta["embedding_lookup"] == delta["embedding_scatter"] == 0


@pytest.mark.cuda
def test_fused_ftrl_apply_in_a_cuda_graph_on_card(cuda):
    """The push captured in a CUDA graph and replayed equals the chain
    of plain versions on the same arenas; a replay counts no launch."""
    t, kw = _push_case(cuda, d=9)
    start = [a.clone() for a in t[2:5]]
    for _ in range(2):                          # warm up: build and load
        port_ops.fused_ftrl_apply(*t, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rows = port_ops.fused_ftrl_apply(*t, **kw)
    for a, s0 in zip(t[2:5], start):
        a.copy_(s0)
    before = port_ops.launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert port_ops.launch_counts() == before
    plain = [a.clone() for a in start]
    pos, found = port_ref.hashmap_probe(t[0], t[5], shift=kw["shift"])
    want = port_ref.ftrl_apply_slots(pos, found, t[1], *plain, t[6],
                                     **FTRL_KW)
    for a, w in zip([*rows[:3], *t[2:5]], [*want, *plain]):
        assert torch.equal(a, w)
    assert bool(rows[3].all())


@pytest.mark.cuda
def test_fused_update_on_absent_id_raises_and_resyncs_on_card(cuda):
    """The card twin of ``test_torch_training``'s CPU test: an id absent
    from the map raises ``RuntimeError``, the mirror's arenas are dropped,
    and the next push (after a re-upload) gives the CPU table's rows."""
    from repro_torch.core.ps import SparseTable
    rng = np.random.default_rng(1)
    ids = np.sort(rng.choice(1 << 40, size=8, replace=False)).astype(
        np.int64)
    grads = rng.normal(size=(8, 4)).astype(np.float32)
    kw = dict(alpha=0.1, beta=1.0, l1=0.5, l2=0.2)
    tables = {}
    for dev in ("cpu", "cuda"):
        t = SparseTable(4, ("n", "z"), backend="torch", device=dev)
        sl = t.ensure(ids)
        before = t.gather(ids)[1]["z"].copy()
        with pytest.raises(RuntimeError, match="absent"):
            t.fused_ftrl_update(np.array([ids[0], 12345], np.int64),
                                np.array([sl[0], 0]),
                                np.ones((2, 4), np.float32), **kw)
        np.testing.assert_array_equal(t.gather(ids)[1]["z"], before)
        tables[dev] = (t, t.fused_ftrl_update(ids, sl, grads, **kw))
    (tc, wc), (tg, wg) = tables["cpu"], tables["cuda"]
    np.testing.assert_array_equal(wg, wc)
    for k in ("z", "n"):
        np.testing.assert_array_equal(tg.gather(ids)[1][k],
                                      tc.gather(ids)[1][k])


def _tol(dtype):
    """2e-5 in float32 (summation order only), 2e-2 where the output is
    rounded to bfloat16 — the reference's own kernel tolerances."""
    return 2e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,g,s,t,d", [
    (2, 4, 2, 256, 256, 64),          # GQA 2:1, whole tiles
    (1, 12, 2, 1000, 1000, 128),      # qwen2-1.5b heads, ragged S
    (2, 4, 4, 100, 77, 128),          # MHA, ragged S != T
    (1, 8, 1, 130, 130, 256),         # MQA, the wide head
    (4, 12, 2, 2048, 2048, 128),      # the prefill's shape
    (1, 2, 1, 1, 1, 128),             # one query, one key
    (1, 4, 2, 17, 300, 64),           # S far below T (a ragged TMA box)
    (1, 4, 2, 1000, 1000, 256),       # the wide head at a ragged S
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda, b, h, g, s, t, d,
                                                      causal, dtype):
    from repro_torch.kernels import flash_attention as port_fa
    gen = torch.Generator(device=cuda).manual_seed(b * s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, s, d), (b, g, t, d), (b, g, t, d)))
    before = port_fa.flash_attention.launches
    got = port_fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert port_fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = port_ref.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    # (B, S, H, D) projections passed as transposed views: same result,
    # written in the views' layout
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (k, v))
    strided = port_fa.flash_attention(qt, kt, vt, causal=causal)
    assert strided.stride() == qt.stride()
    assert torch.equal(strided, got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,g,s,d", [
    (4, 12, 2, 512, 128),             # qwen2-1.5b heads
    (3, 4, 2, 300, 64),               # reduced configs' head dim
    (2, 28, 4, 257, 128),             # qwen2-7b: 7 heads per group
    (2, 28, 4, 4096, 128),            # qwen2-7b at the long cache
])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_decode_attention_kernel_matches_plain_on_card(cuda, b, h, g, s, d,
                                                       q_dtype, kv_dtype):
    from repro_torch.kernels import decode_attention as port_da
    gen = torch.Generator(device=cuda).manual_seed(b * s + d)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(q_dtype)
    k, v = (torch.randn((b, s, g, d), generator=gen, device=cuda)
            .to(kv_dtype) for _ in range(2))
    lengths = torch.tensor([1, s, 65, 64][:b], device=cuda,
                           dtype=torch.int32)          # mixed, 1 and S
    before = port_da.decode_attention.launches
    got = port_da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert port_da.decode_attention.launches == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    want = port_ref.decode_attention(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(q_dtype),
                               atol=_tol(q_dtype))
    # rows past a sequence's length are never read
    k2, v2 = k.clone(), v.clone()
    for i, n in enumerate(lengths.tolist()):
        k2[i, n:], v2[i, n:] = 1e6, float("nan")
    assert torch.equal(port_da.decode_attention(q, k2, v2, lengths), got)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_decode_attention_split_boundaries_on_card(cuda, q_dtype, kv_dtype):
    """Lengths that end exactly on, just before and just after the split
    boundaries of ``split_plan``; rows past each length are poison."""
    from repro_torch.kernels import decode_attention as port_da
    b, h, g, s, d = 8, 12, 2, 4096, 128
    splits, rows = port_da.split_plan(s, b, g)
    assert b * g * splits >= 264
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(q_dtype)
    k, v = (torch.randn((b, s, g, d), generator=gen, device=cuda)
            .to(kv_dtype) for _ in range(2))
    lengths = torch.tensor([rows, rows + 1, rows - 1, 2 * rows,
                            (splits - 1) * rows, (splits - 1) * rows + 1, s,
                            1], device=cuda, dtype=torch.int32)
    want = port_ref.decode_attention(q, k, v, lengths)
    for i, n in enumerate(lengths.tolist()):
        k[i, n:], v[i, n:] = 1e6, float("nan")
    got = port_da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(q_dtype),
                               atol=_tol(q_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_bf16", "flash_f32", "decode"])
def test_attention_kernels_repeat_bit_equal_on_card(cuda, kernel):
    """Two calls on the same inputs give the same bits: no atomics in the
    sums, the split-KV combine in split order."""
    from repro_torch.kernels import decode_attention as port_da
    from repro_torch.kernels import flash_attention as port_fa
    gen = torch.Generator(device=cuda).manual_seed(9)
    if kernel == "decode":
        q = torch.randn((4, 12, 128), generator=gen, device=cuda)
        k, v = (torch.randn((4, 4096, 2, 128), generator=gen, device=cuda)
                for _ in range(2))
        lengths = torch.tensor([4001, 1, 2048, 4096], device=cuda,
                               dtype=torch.int32)
        first = port_da.decode_attention(q, k, v, lengths)
        second = port_da.decode_attention(q, k, v, lengths)
    else:
        dtype = torch.bfloat16 if kernel == "flash_bf16" else torch.float32
        q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                   for shape in ((2, 12, 1000, 128), (2, 2, 1000, 128),
                                 (2, 2, 1000, 128)))
        first = port_fa.flash_attention(q, k, v, causal=True)
        second = port_fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_decode_attention_length_zero_fails_on_card(cuda):
    """A length of 0 fails the kernel's device-side assert and surfaces as
    a RuntimeError at the next synchronisation. In a child process: the
    assert leaves that process's CUDA context unusable."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    script = (
        "import torch\n"
        "from repro_torch.kernels import decode_attention as da\n"
        "q = torch.zeros(1, 2, 64, device='cuda')\n"
        "k = torch.zeros(1, 8, 1, 64, device='cuda')\n"
        "da.decode_attention(q, k, k, torch.zeros(1, dtype=torch.int32,\n"
        "                                         device='cuda'))\n"
        "try:\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert "raised:" in out.stdout, out.stdout + out.stderr
    assert "assert" in out.stdout.lower()


def _scatter_add_ids(kind: str, n: int, v: int, gen, device):
    if kind == "random":
        return torch.randint(0, v, (n,), generator=gen, device=device)
    if kind == "all_duplicate":
        return torch.full((n,), v // 3, device=device, dtype=torch.int64)
    if kind == "all_unique":
        return torch.randperm(v, generator=gen, device=device)[:n]
    return torch.zeros((0,), dtype=torch.int64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "all_duplicate", "all_unique",
                                  "empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 96, 1536])
def test_scatter_add_kernel_matches_plain_on_card(cuda, kind, dtype, d):
    """Bit-equal: both add each id's duplicates in input order, rounding
    to the table's dtype after every add."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    v, n = 5000, 3000
    table = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    ids = _scatter_add_ids(kind, n if kind != "empty" else 0, v, gen, cuda)
    upd = torch.randn((ids.shape[0], d), generator=gen, device=cuda)
    before = port_el.embedding_scatter_add.launches
    got = port_el.embedding_scatter_add(table.clone(), ids.to(torch.int32),
                                        upd)
    torch.cuda.synchronize()
    assert port_el.embedding_scatter_add.launches == before + (kind != "empty")
    want = port_ref.embedding_scatter_add(table.clone(), ids, upd)
    assert got.dtype == dtype and torch.equal(got, want)
    if kind == "empty":
        assert torch.equal(got, table)


def _scatter_add_both(table, ids, upd):
    """The kernel (called twice, each call counted) and the plain version
    on clones of ``table``: the kernel's result, bit-equal to both."""
    before = port_el.embedding_scatter_add.launches
    got = port_el.embedding_scatter_add(table.clone(), ids.to(torch.int32),
                                        upd)
    again = port_el.embedding_scatter_add(table.clone(), ids, upd)
    torch.cuda.synchronize()
    assert port_el.embedding_scatter_add.launches == before + 2
    want = port_ref.embedding_scatter_add(table.clone(), ids, upd)
    assert got.dtype == table.dtype
    assert torch.equal(got, want) and torch.equal(again, got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_zipf_ids_on_card(cuda, dtype):
    """4,096 token ids from a Zipf law (s = 1.0) over qwen2's vocabulary:
    ~2,100 distinct, the hottest a segment of ~330 rows."""
    vocab, d = 151936, 256
    ids = torch.from_numpy(zipf_ids(4096, vocab, 0)).to(cuda)
    assert int(torch.bincount(ids).max()) > 200
    gen = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randn((vocab, d), generator=gen, device=cuda).to(dtype)
    upd = torch.randn((4096, d), generator=gen, device=cuda)
    _scatter_add_both(table, ids, upd)


@pytest.mark.cuda
@pytest.mark.parametrize("length", ["1", "K-1", "K", "K+1", "17", "31", "32",
                                    "33", "64", "65", "4096"])
@pytest.mark.parametrize("before", [800, 805])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_segment_lengths_on_card(cuda, dtype, before, length):
    """One id's segment of ``length`` rows around the ring rows K that
    each warp owns (a longer segment borrows the shares of the warps it
    covers: 16, 32, 64 rows deep), the kernel's 32-row chunks of
    ``order`` and its cp.async groups, its rows scattered among
    ``before`` rows of smaller ids so the order is no identity and the
    segment starts at different warps of a block."""
    k = port_el._lib().embedding_scatter_add_share()
    m = (int(length) if length.isdigit()
         else k + {"K-1": -1, "K": 0, "K+1": 1}[length])
    gen = torch.Generator(device=cuda).manual_seed(m + before)
    v, d = 1000, 1536
    other = torch.randint(0, v - 1, (before,), generator=gen, device=cuda)
    ids = torch.cat([other, torch.full((m,), v - 1, device=cuda)])
    ids = ids[torch.randperm(ids.shape[0], generator=gen, device=cuda)]
    table = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    upd = torch.randn((ids.shape[0], d), generator=gen, device=cuda)
    _scatter_add_both(table, ids, upd)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["contiguous", "strided", "misaligned",
                                  "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 9, 257, 1536])
def test_scatter_add_widths_and_views_on_card(cuda, d, dtype, view):
    """Row widths and update views that take each lane word (16, 8, 4,
    2 bytes): a column slice read in place through its row stride, a
    view one element off 16-byte alignment, a transposed (copied) one."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    v, n = 700, 900
    table = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, 60, (n,), generator=gen, device=cuda)
    big = torch.randn((n, d + 8), generator=gen, device=cuda).to(dtype)
    upd = {"contiguous": big[:, :d].contiguous(), "strided": big[:, :d],
           "misaligned": big[:, 1:d + 1],
           "transposed": big[:, :d].t().contiguous().t()}[view]
    _scatter_add_both(table, ids, upd)


@pytest.mark.cuda
def test_scatter_add_in_a_cuda_graph_on_card(cuda):
    """The wrapper (sort, casts, one kernel) captured in a CUDA graph and
    replayed onto a fresh table: bit-equal to the plain version. No host
    synchronisation inside, or the capture would fail."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    v, d, n = 5000, 1536, 4096
    base = torch.randn((v, d), generator=gen, device=cuda).bfloat16()
    ids = torch.from_numpy(zipf_ids(n, v, 1)).to(cuda)
    upd = torch.randn((n, d), generator=gen, device=cuda).bfloat16()
    table = base.clone()
    port_el.embedding_scatter_add(table, ids, upd)      # warm-up, built
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        port_el.embedding_scatter_add(table, ids, upd)
    table.copy_(base)
    before = port_el.embedding_scatter_add.launches
    graph.replay()
    torch.cuda.synchronize()
    assert port_el.embedding_scatter_add.launches == before
    want = port_ref.embedding_scatter_add(base.clone(), ids, upd)
    assert torch.equal(table, want)


def _lm_grads(cfg, params, tokens, what):
    """Gradients of a scalar of ``what``'s output w.r.t. the params."""
    from repro_torch.models import attention, common
    leaves = [p.requires_grad_(True) for p in params.values()]
    if what == "embed":
        out = common.embed_tokens(params["embed"], tokens)
    else:
        x = common.embed_tokens(params["embed"], tokens).detach()
        pos = torch.arange(tokens.shape[1], device=x.device).expand(
            tokens.shape)
        out = attention.self_attention(
            {k: v for k, v in params.items() if k != "embed"}, x, pos,
            cfg=cfg)
    w = torch.linspace(-1, 1, out.numel(), device=out.device).view(
        out.shape)
    return torch.autograd.grad((out.float() * w).sum(), leaves,
                               allow_unused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["embed", "attention"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_gradients_on_card_match_plain_versions(cuda, monkeypatch, what,
                                                   dtype):
    """``embed_tokens`` (gather forward, scatter-add backward) and the
    differentiable ``self_attention`` (flash forward, plain-op backward)
    on the card, against the same functions with ``kernels.ops`` routed
    to the plain versions: embedding gradients bit-equal; attention
    gradients, which sum over every position, within 1e-4 (float32) or
    2e-2 (bfloat16) of each gradient's largest magnitude — the flash
    output's summation order feeds the backward."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    cfg = reduced(get_config("qwen2-1.5b"), layers_per_segment=2)
    p = init_params(cfg, torch.Generator(device=cuda).manual_seed(5))
    layer = {k: v[0] for k, v in p["segments"][0]["pos0"]["mixer"].items()
             if k != "norm"}
    gen = torch.Generator(device=cuda).manual_seed(6)
    for k in ("bq", "bk", "bv"):
        layer[k] = 0.1 * torch.randn(layer[k].shape, generator=gen,
                                     device=cuda)
    params = {k: v.detach().to(dtype).contiguous()
              for k, v in {"embed": p["embed"], **layer}.items()}
    tokens = torch.randint(0, 40, (3, 256), generator=gen, device=cuda)
    before = port_ops.launch_counts()
    got = _lm_grads(cfg, params, tokens, what)
    torch.cuda.synchronize()
    counts = port_ops.launch_counts()
    assert counts["embedding_lookup"] == before["embedding_lookup"] + 1
    if what == "embed":
        assert counts["embedding_scatter_add"] == \
            before["embedding_scatter_add"] + 1
    else:
        assert counts["flash_attention"] == before["flash_attention"] + 1
    for name in ("embedding_lookup", "embedding_scatter_add",
                 "flash_attention"):
        monkeypatch.setattr(port_ops, name, getattr(port_ref, name))
    want = _lm_grads(cfg, params, tokens, what)
    assert port_ops.launch_counts() == counts
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif what == "embed":
            assert torch.equal(g, w)
        else:
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= tol * scale


# ---------------------------------------------------------------------------
# the checkpoint plane and the cluster on the card
# ---------------------------------------------------------------------------
def _ckpt_masters(backend, device):
    from repro_torch.core.ps import MasterShard
    from repro_torch.optim import get_optimizer
    return [MasterShard(i, {"w": 1, "v": 8},
                        get_optimizer("ftrl", alpha=0.1, l1=0.05),
                        backend=backend, device=device) for i in range(2)]


def _ckpt_traffic(sides, seed):
    from repro_torch.core.routing import RoutingPlan
    rng = np.random.default_rng(seed)
    plan = RoutingPlan(2, 1, 1)
    pool = rng.choice(1 << 40, size=5000, replace=False).astype(np.int64)
    for step in range(3):
        for g, dim in (("w", 1), ("v", 8)):
            ids = pool[rng.integers(0, len(pool), size=4096)]
            grads = rng.normal(size=(4096, dim)).astype(np.float32)
            owner = plan.master_shard(ids)
            for mid in (0, 1):
                for shards in sides:
                    shards[mid].push_grad(g, ids[owner == mid],
                                          grads[owner == mid], step=step)
    for shards in sides:
        for m in shards:
            m.delete_rows("v", pool[:40])


def _same_snap(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_snap(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    else:
        assert a == b


@pytest.mark.cuda
def test_checkpoint_kill_recover_on_card(cuda):
    """Masters on the card and on the host take the same pushes; int8
    checkpoints (a full, then a delta) are bit-equal across the two, and
    a killed card master recovers to the host twin's restored rows."""
    from repro_torch.core import fault_tolerance as ft
    card, host = _ckpt_masters("torch", cuda), _ckpt_masters("numpy", "cpu")
    pol = dict(incremental=True, compress="int8")
    cbs = [ft.ColdBackup(s, ft.CheckpointStore(), ft.BackupPolicy(**pol),
                         codec_backend=b, device=d)
           for s, b, d in ((card, "torch", cuda), (host, "numpy", "cpu"))]
    before = port_ops.launch_counts()
    _ckpt_traffic((card, host), 1)
    for cb in cbs:
        assert cb.checkpoint(1.0, tier="remote") == 1
    _ckpt_traffic((card, host), 2)
    for cb in cbs:
        assert cb.checkpoint(2.0) == 2
    a, b = (cb.store.load(2) for cb in cbs)
    assert a.kind == b.kind == "delta"
    for v in (1, 2):
        _same_snap(cbs[0].store.load(v).shard_snaps,
                   cbs[1].store.load(v).shard_snaps)
    for shards in (card, host):
        shards[1].kill()
    assert cbs[0].recover_shard(card[1]) == cbs[1].recover_shard(host[1])
    torch.cuda.synchronize()
    after = port_ops.launch_counts()
    for k in ("quantize_rows", "dequantize_rows", "ftrl_row_update",
              "embedding_lookup"):
        assert after[k] > before[k], k
    for m, h in zip(card, host):
        _same_snap(m.snapshot(), h.snapshot())
    assert card[1].tables["v"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 9, 1536])
def test_int8_checkpoint_blocks_bit_equal_on_card(cuda, d):
    from repro_torch.core import fault_tolerance as ft
    rng = np.random.default_rng(d)
    a = (rng.normal(size=(777, d)) * rng.uniform(1e-3, 50, (777, 1))) \
        .astype(np.float32)
    a[::97] = 0.0
    got, want = ft._pack_rows(a, "torch", cuda), ft._pack_rows(a, "numpy")
    _same_snap(got, want)
    _same_snap(ft._unpack_rows(got, "torch", cuda),
               ft._unpack_rows(want, "numpy"))


@pytest.mark.cuda
def test_hot_switch_frees_replaced_tables_on_card(cuda, tmp_path):
    """Three hot switches to one checkpoint: the replaced replica tables
    release their device mirrors, so the allocated memory after the third
    is within 5% of after the first; the serve cache is emptied."""
    import dataclasses

    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.core import ClusterConfig, WeiPSCluster
    cl = WeiPSCluster(dataclasses.replace(FM_FTRL, ftrl_l1=0.01),
                      ClusterConfig(codec="int8", ckpt_compress="int8",
                                    ckpt_root=str(tmp_path)))
    rng = np.random.default_rng(3)
    ids = rng.choice(1 << 40, size=(4096, 32)).astype(np.int64)
    for step in range(3):
        cl.train_on_batch(ids, (rng.random(4096) < 0.3).astype(np.float32),
                          now=float(step))
        cl.sync_tick(float(step))
    ckpt = cl.store.load(cl.checkpoint(3.0))
    cl.predict(ids[:512])
    mem = []
    for _ in range(3):
        cl._hot_switch(ckpt)
        assert all(len(s.cache) == 0 for s in cl.serving.registry)
        cl.predict(ids[:512])            # mirrors the new tables
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    assert mem[2] <= mem[0] * 1.05, mem


@pytest.fixture(scope="module")
def runtime_runs(tmp_path_factory):
    """Runs of the multi-process runtime at the chaos suite's shape with
    the int8 codec, one a (engine, plan), shared by the tests below."""
    import torch_runtime_harness as h
    cache: dict = {}

    def get(engine: str, kill: bool):
        if (engine, kill) not in cache:
            from repro_torch.launch.chaos import FaultEvent, FaultPlan
            plan = FaultPlan(seed=0, events=[
                FaultEvent("master-0", "mid_train", 6, "kill")]) \
                if kill else None
            kw = dict(device="cuda:0") if engine == "card" \
                else h.ENGINES["numpy"]
            root = tmp_path_factory.mktemp(f"{engine}-{kill}")
            cache[engine, kill] = h.run_cluster(root, plan, codec="int8",
                                                **kw)
        return cache[engine, kill]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("kill", [False, True])
def test_runtime_on_card_equals_host_twin(cuda, runtime_runs, kill):
    """The process-per-shard grid with every worker's PS on the card,
    fault-free and with master-0 SIGKILLed at ``mid_train``: masters,
    slaves and queue offsets bit-equal to the same run on the numpy
    backends, and the kill run's to the fault-free card run."""
    import torch_runtime_harness as h
    card, twin = runtime_runs("card", kill), runtime_runs("host", kill)
    assert card["recoveries"] == twin["recoveries"] == int(kill)
    h.assert_states_equal(card["masters"], twin["masters"], "masters")
    h.assert_states_equal(card["slaves"], twin["slaves"], "slaves")
    assert card["offsets"] == twin["offsets"]
    if kill:
        free = runtime_runs("card", False)
        h.assert_states_equal(card["masters"], free["masters"],
                              "masters after the kill")
        h.assert_states_equal(card["slaves"], free["slaves"],
                              "slaves after the kill")


@pytest.mark.cuda
def test_runtime_workers_count_kernel_launches_on_card(cuda, runtime_runs):
    """The workers' ``kernels`` metrics: masters launch the probe, the
    fused FTRL pass and the int8 encode, slaves the int8 decode; each
    holds allocator bytes on the card (``device_memory``); the host
    twin's workers launch none and report no device memory."""
    workers = runtime_runs("card", False)["metrics"]["workers"]
    for name, tree in workers.items():
        k = tree["kernels"]
        if name.startswith("master-"):
            assert k["hashmap_probe"] + k["hashmap_probe_hbm"] > 0, name
            assert k["ftrl_row_update"] > 0 and k["quantize_rows"] > 0, name
        else:
            assert k["dequantize_rows"] > 0, name
        assert tree["device_memory"]["reserved"] > 0, name
    for tree in runtime_runs("host", False)["metrics"]["workers"].values():
        assert set(tree["kernels"].values()) == {0}
        assert "device_memory" not in tree
