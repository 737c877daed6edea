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
from chip_smoke import zipf_ids  # noqa: E402
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
