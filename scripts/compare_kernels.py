#!/usr/bin/env python3
"""Time kernels of this tree against those built from another version of
their source, on one CUDA card, in turns (other, this, this, other). Each
pair of outputs must be bit-equal, or the script fails.

The copies (``--embedding-lookup``): the row gather and the row
scatter-set at the shapes ``chip_smoke.py`` times them, 131,072 ids into
a 2^21 x D float32 table for D = 1, 8 and 9, and qwen2-1.5b's token
gather (8,192 ids x 1,536 bf16 from its 152,064-row table). The other
source's copy entries must take ``(table, row_bytes, ids, n, rows,
stream)``: the C interface before ``copy_plan``.

The hash probes (``--hashmap-probe``): ``hashmap_probe_hbm`` on maps
built like the loop's (``probe_maps``): a replica's 2^24-slot map of its
2^21 ids under the ids of a 4096 x 32 cold request it owns, one
master's 2^23-slot map of its 2^20 ids under the ids of a 4096 x 32
train batch it owns (the fused FTRL push), the same replica map with a
cold L2 (``chip_smoke.cold_probe_batches``: batches of live ids in turn)
and the smoke's crafted 2^24-slot case; ``hashmap_probe`` (the walk) on
the serve cache's map under a warm request and the smoke's crafted
2^20-slot case. The other source's entries are ``hashmap_probe_walk``
``(keys, cap, shift, ids, n, pos, found, stream)`` and
``hashmap_probe_window``, which takes the window ``w`` after ``shift``:
the C interface before the hbm probe's redesign. Each pair must agree in
``found`` everywhere and in ``pos`` where found.

The FTRL push (``--ftrl-row-update``): the push after its probe on one
master's 2^23-slot map of its ~2^20 ids (built as ``probe_maps`` builds
it) with (z, n, w) arenas of as many rows, D = 8 and D = 1, under the
ids of a 4096 x 32 train batch that the master owns (``probe_maps``'
master batch). The other side is the chain the push ran before the fused
pass: the torch slot translate, this tree's two gathers, the other
source's ``ftrl_row_update`` and this tree's three scatter-sets; this
side is one ``ftrl_apply_slots``. Then the standalone call on the push's
gathered rows (contiguous (z, n, g) at D = 8). The other source's entry
must take ``(z, n, g, count, alpha, beta, l1, l2, z_out, n_out, w_out,
stream)``, as this tree's does. Arenas and row outputs must be bit-equal
pair by pair.

The int8 row codec (``--delta-codec``): ``quantize_rows`` and
``dequantize_rows`` at the sync path's shapes (one master's push, 32,768
x 8; one record, 16,384 x 8; the bootstrap's encode of a master, 2^20 x
8, and one of its records, 65,536 x 8), at 65,536 x 1,536 and at one
dense leaf of qwen2-1.5b, ONE row of 28 x 1,536 x 8,960 floats. The
other source's entries must take ``(x, rows, d, q, scale, stream)`` and
``(q, scale, rows, d, out, stream)``: the C interface before
``codec_plan``. Its quantize gives a row one warp, seconds for the leaf,
so there it runs a row of 2^24 floats and its time is scaled by the
leaf's length (``"scaled"`` in its line).

    git show <rev>:src/repro_torch/kernels/csrc/embedding_lookup.cu \\
        > build/other_embedding_lookup.cu
    git show <rev>:src/repro_torch/kernels/csrc/delta_codec.cu \\
        > build/other_delta_codec.cu
    git show <rev>:src/repro_torch/kernels/csrc/hashmap_probe.cu \\
        > build/other_hashmap_probe.cu
    git show <rev>:src/repro_torch/kernels/csrc/ftrl_row_update.cu \\
        > build/other_ftrl_row_update.cu
    python3 scripts/compare_kernels.py \\
        --embedding-lookup build/other_embedding_lookup.cu \\
        --delta-codec build/other_delta_codec.cu \\
        --hashmap-probe build/other_hashmap_probe.cu \\
        --ftrl-row-update build/other_ftrl_row_update.cu

Any option may be left out. The other sources are built with the
port's ``nvcc`` flags into ``build/repro_torch/compare/``. Prints the
card's name and power limit, a line a shape and kernel, and a JSON object
of every time last. Device times come from ``chip_smoke._device_ms`` (a
CUDA graph of 20 calls, replayed).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# one MLP stack of qwen2-1.5b: layers x d_model x d_ff, one codec row
LM_LEAF = 28 * 1536 * 8960
# the other quantize's cut of that row (it streams a row with one warp)
OTHER_LEAF_CUT = 1 << 24
CODEC_SHAPES = (("quantize_rows", 32_768, 8, "one master's push"),
                ("dequantize_rows", 16_384, 8, "one record"),
                ("quantize_rows", 1 << 20, 8, "the bootstrap's encode of a "
                 "master"),
                ("dequantize_rows", 65_536, 8, "one bootstrap record"),
                ("quantize_rows", 65_536, 1536, ""),
                ("dequantize_rows", 65_536, 1536, ""),
                ("quantize_rows", 1, LM_LEAF, "a qwen2-1.5b MLP leaf"),
                ("dequantize_rows", 1, LM_LEAF, "a qwen2-1.5b MLP leaf"))


def build_other(src: Path) -> ctypes.CDLL:
    """The library built from ``src`` with the port's flags."""
    from repro_torch.kernels import _build
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / "compare" / f"libother-{digest}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(src)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def _check_rc(rc: int) -> None:
    if rc:
        raise RuntimeError(f"other library: CUDA error {rc}")


def _stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def _turns(name: str, label: str, old, new, scale: float = 1.0,
           iters: int = 20) -> dict:
    """Time ``old`` and ``new`` in turns, ``iters`` calls a graph;
    ``scale`` multiplies the other's times (a cut of the shape)."""
    import chip_smoke as cs
    t = [cs._device_ms(f, iters) for f in (old, new, new, old)]
    t[0] *= scale
    t[3] *= scale
    row = {"name": name, "shape": label, "other_ms": (t[0] + t[3]) / 2,
           "this_ms": (t[1] + t[2]) / 2, "turns_ms": t}
    if scale != 1.0:
        row["other_scaled_by"] = scale
    row["ratio"] = row["this_ms"] / row["other_ms"]
    print(f"{name} at {label}: other {row['other_ms']:.5f} ms"
          + (f" (scaled by {scale:.4f})" if scale != 1.0 else "")
          + f", this {row['this_ms']:.5f} ms ({row['ratio']:.3f}x); turns "
          + ", ".join(f"{x:.5f}" for x in t), flush=True)
    return row


def copy_shapes(dev):
    """(label, table, gather ids, unique scatter ids, updates), as
    ``chip_smoke.phase_kernels`` makes them."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    n = cs.REQ_BATCH * cs.FIELDS
    for d in (1, 8, 9):
        yield (f"{cs.COPY_ROWS}x{d} f32, {n} ids",
               torch.randn(cs.COPY_ROWS, d, device=dev),
               torch.randint(0, cs.COPY_ROWS, (n,), device=dev,
                             dtype=torch.int32),
               torch.randperm(cs.COPY_ROWS, device=dev)[:n].to(torch.int32),
               torch.randn(n, d, device=dev))
    cfg = get_config(cs.LM_ARCH)
    n = cs.PREFILL_BATCH * cs.PREFILL_LEN
    yield (f"{cfg.padded_vocab}x{cfg.d_model} bf16, {n} ids",
           torch.randn(cfg.padded_vocab, cfg.d_model, device=dev,
                       dtype=torch.bfloat16),
           torch.randint(0, cfg.vocab_size, (n,), device=dev,
                         dtype=torch.int32),
           torch.randperm(cfg.vocab_size, device=dev)[:n].to(torch.int32),
           torch.randn(n, cfg.d_model, device=dev, dtype=torch.bfloat16))


def compare_copies(src: Path, dev) -> list[dict]:
    import torch

    from repro_torch.kernels import embedding_lookup as el
    other = build_other(src)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in (other.embedding_lookup, other.embedding_scatter):
        fn.argtypes = [p, ll, p, ll, p, p]
        fn.restype = ctypes.c_int

    def call(cfunc, table, ids, rows):
        _check_rc(cfunc(table.data_ptr(), table.shape[1]
                        * table.element_size(), ids.data_ptr(), ids.shape[0],
                        rows.data_ptr(), _stream()))

    results = []
    for label, table, ids, uniq, upd in copy_shapes(dev):
        out = torch.empty(ids.shape[0], table.shape[1], dtype=table.dtype,
                          device=dev)
        call(other.embedding_lookup, table, ids, out)
        if not torch.equal(out, el.embedding_lookup(table, ids)):
            raise AssertionError(f"gather at {label}: not bit-equal")
        mine = el.embedding_scatter(table.clone(), uniq, upd)
        theirs = table.clone()
        call(other.embedding_scatter, theirs, uniq, upd)
        if not torch.equal(mine, theirs):
            raise AssertionError(f"scatter-set at {label}: not bit-equal")
        del mine, theirs
        results.append(_turns(
            "embedding_lookup", label,
            lambda: call(other.embedding_lookup, table, ids, out),
            lambda: el.embedding_lookup(table, ids)))
        results.append(_turns(
            "embedding_scatter", label,
            lambda: call(other.embedding_scatter, table, uniq, upd),
            lambda: el.embedding_scatter(table, uniq, upd)))
    return results


def compare_codec(src: Path, dev) -> list[dict]:
    import torch

    from repro_torch.kernels import delta_codec as dc
    other = build_other(src)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    other.quantize_rows.argtypes = [p, ll, ll, p, p, p]
    other.dequantize_rows.argtypes = [p, p, ll, ll, p, p]
    other.quantize_rows.restype = other.dequantize_rows.restype = ctypes.c_int

    def quantize(x, q, s):
        _check_rc(other.quantize_rows(x.data_ptr(), x.shape[0], x.shape[1],
                                      q.data_ptr(), s.data_ptr(), _stream()))

    def dequantize(q, s, out):
        _check_rc(other.dequantize_rows(q.data_ptr(), s.data_ptr(),
                                        q.shape[0], q.shape[1],
                                        out.data_ptr(), _stream()))

    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for name, b, d, what in CODEC_SHAPES:
        label = f"{b}x{d}" + (f", {what}" if what else "")
        x = torch.randn(b, d, generator=gen, device=dev) * 10.0 ** (
            torch.rand(b, 1, generator=gen, device=dev) * 8 - 4)
        q, s = dc.quantize_rows(x)
        if name == "quantize_rows":
            cut = x[:, :OTHER_LEAF_CUT] if d > OTHER_LEAF_CUT else x
            oq = torch.empty(cut.shape, dtype=torch.int8, device=dev)
            os_ = torch.empty(b, 1, device=dev)
            quantize(cut.contiguous(), oq, os_)
            mq, ms = dc.quantize_rows(cut.contiguous()) if cut is not x \
                else (q, s)
            if not (torch.equal(oq, mq) and torch.equal(os_, ms)):
                raise AssertionError(f"quantize at {label}: not bit-equal")
            cut = cut.contiguous()
            results.append(_turns(name, label,
                                  lambda: quantize(cut, oq, os_),
                                  lambda: dc.quantize_rows(x),
                                  scale=d / cut.shape[1]))
            del oq, mq
        else:
            out = torch.empty(b, d, device=dev)
            dequantize(q, s, out)
            if not torch.equal(out, dc.dequantize_rows(q, s)):
                raise AssertionError(f"dequantize at {label}: not bit-equal")
            results.append(_turns(name, label,
                                  lambda: dequantize(q, s, out),
                                  lambda: dc.dequantize_rows(q, s)))
            del out
        del x, q, s
        torch.cuda.empty_cache()
    return results


def probe_maps(dev):
    """``(label, kernel, host map, keys on dev, [id batches on dev])`` of
    the probe comparison, built as the loop's maps are: 2^22 hashed ids
    split by ``RoutingPlan(4, 2, 8)``, each map filled with its shard's
    ids in one ``put`` (the loop fills them record by record, so slots
    differ, not the load), the requests drawn from the seed."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.core.hashmap import IdHashMap
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.kernels import ref
    plan = RoutingPlan(num_master=4, num_slave=2, num_partitions=8)
    pool = cs.hashed_ids(FM_FTRL.feature_space)
    rng = np.random.default_rng(cs.SEED)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def drawn():                        # one request's or batch's ids
        return pool[rng.integers(0, len(pool), size=cs.REQ_BATCH * cs.FIELDS)]

    def filled(ids, pad):
        m = IdHashMap(16)
        m.put(ids, np.arange(len(ids)))
        keys = up(m.key_table)
        return m, ref.wrap_pad(keys, cap=m.capacity) if pad else keys

    request = drawn()
    cold = np.unique(request)
    m, keys = filled(pool[plan.slave_shard(pool) == 0], True)
    owned = cold[plan.slave_shard(cold) == 0]
    yield ("a replica's map, the cold request's ids it owns",
           "hashmap_probe_hbm", m, keys, [up(owned)])
    batches, touched = cs.cold_probe_batches(m, len(owned), dev)
    yield (f"the same, L2 cold ({len(batches)} batches of {len(owned)} "
           f"live ids in turn, home sectors {touched / 1e6:.1f} MB)",
           "hashmap_probe_hbm", m, keys, batches)
    del keys, batches
    m, keys = filled(pool[plan.master_shard(pool) == 0], True)
    push = np.unique(drawn())
    yield ("a master's map, a train batch's ids it owns (the fused FTRL "
           "push)", "hashmap_probe_hbm", m, keys,
           [up(push[plan.master_shard(push) == 0])])
    del keys
    n = cs.REQ_BATCH * cs.FIELDS
    for name, cap_pow in (("hashmap_probe_hbm", 24), ("hashmap_probe", 20)):
        m, q = cs.probe_case(cap_pow, (1 << cap_pow) // 5, n, rng)
        keys = up(m.key_table)
        if name == "hashmap_probe_hbm":
            keys = ref.wrap_pad(keys, cap=m.capacity)
        yield ("the smoke's crafted case", name, m, keys, [up(q)])
        del keys
    m, keys = filled(cold, False)
    yield ("the serve cache's map, a warm request", "hashmap_probe", m,
           keys, [up(request)])


def compare_probes(src: Path, dev) -> list[dict]:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import hashmap_probe as hm
    other = build_other(src)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    other.hashmap_probe_walk.argtypes = [p, ll, i, p, ll, p, p, p]
    hbm = other.hashmap_probe_window
    hbm.argtypes = [p, ll, i, i, p, ll, p, p, p]
    other.hashmap_probe_walk.restype = hbm.restype = ctypes.c_int
    results = []
    for label, name, m, keys, batches in probe_maps(dev):
        shift, cap = int(m.shift), m.capacity
        cfunc, extra = other.hashmap_probe_walk, ()
        if name == "hashmap_probe_hbm":
            cfunc, extra = hbm, (min(hm._DMA_WINDOW, cap),)
        outs = [(torch.empty(b.shape[0], dtype=torch.int32, device=dev),
                 torch.empty(b.shape[0], dtype=torch.bool, device=dev))
                for b in batches]

        def theirs(k):
            q, (pos, found) = batches[k], outs[k]
            _check_rc(cfunc(keys.data_ptr(), cap, shift, *extra,
                            q.data_ptr(), q.shape[0], pos.data_ptr(),
                            found.data_ptr(), _stream()))

        mine = getattr(hm, name)
        for k, q in enumerate(batches):
            cs.check_probe(name, keys, q, shift, m)
            pos, found = mine(keys, q, shift=shift)
            theirs(k)
            opos, ofound = outs[k]
            if not (torch.equal(found, ofound)
                    and torch.equal(pos[found], opos[found])):
                raise AssertionError(f"{name} at {label}: the other "
                                     f"version differs")
        n_found = int(found.sum())
        results.append(_turns(
            name, f"{label}: {cap} slots, {batches[0].shape[0]} ids "
                  f"({n_found} found)",
            cs._cycling(theirs, list(range(len(batches)))),
            cs._cycling(lambda q: mine(keys, q, shift=shift), batches),
            iters=len(batches) if len(batches) > 1 else 20))
        del keys, batches, outs
        torch.cuda.empty_cache()
    return results


def master_push(dev):
    """``(host map, keys on dev (wrap-padded), push ids on dev)``: the
    master map and train batch of ``probe_maps`` (master 0 of
    ``RoutingPlan(4, 2, 8)`` over the 2^22 hashed ids, filled in one
    ``put`` with arena slots 0, 1, ...; the unique ids of the seed's
    second 4096 x 32 draw that the master owns)."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.core.hashmap import IdHashMap
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.kernels import ref
    plan = RoutingPlan(num_master=4, num_slave=2, num_partitions=8)
    pool = cs.hashed_ids(FM_FTRL.feature_space)
    rng = np.random.default_rng(cs.SEED)
    n = cs.REQ_BATCH * cs.FIELDS
    rng.integers(0, len(pool), size=n)              # probe_maps' request
    push = np.unique(pool[rng.integers(0, len(pool), size=n)])
    ids = pool[plan.master_shard(pool) == 0]
    m = IdHashMap(16)
    m.put(ids, np.arange(len(ids)))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    keys = ref.wrap_pad(up(m.key_table), cap=m.capacity)
    return m, keys, up(push[plan.master_shard(push) == 0])


def compare_ftrl(src: Path, dev) -> list[dict]:
    import torch

    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ftrl_row_update as fr
    from repro_torch.kernels import hashmap_probe as hm
    other = build_other(src)
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    other.ftrl_row_update.argtypes = [p, p, p, ll, f, f, f, f, p, p, p, p]
    other.ftrl_row_update.restype = ctypes.c_int
    kw = dict(alpha=FM_FTRL.ftrl_alpha, beta=FM_FTRL.ftrl_beta,
              l1=FM_FTRL.ftrl_l1, l2=FM_FTRL.ftrl_l2)

    def theirs(z, n, g, outs):
        _check_rc(other.ftrl_row_update(
            z.data_ptr(), n.data_ptr(), g.data_ptr(), z.numel(),
            *kw.values(), *(o.data_ptr() for o in outs), _stream()))

    m, keys, ids = master_push(dev)
    slot_of = torch.from_numpy(m.val_table.astype(np.int32)).to(dev)
    pos, found = hm.hashmap_probe_hbm(keys, ids, shift=int(m.shift))
    if not bool(found.all()):
        raise AssertionError("the master's push: ids absent from its map")
    rows, b = len(m), ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for d in (8, 1):
        start = (1.5 * torch.randn(rows, d, generator=gen, device=dev),
                 4 * torch.rand(rows, d, generator=gen, device=dev),
                 torch.zeros(rows, d, device=dev))
        g = torch.randn(b, d, generator=gen, device=dev)
        outs = [torch.empty(b, d, device=dev) for _ in range(3)]

        def chain(arenas, outs=outs, g=g):
            slot = torch.where(found, slot_of[pos], torch.zeros_like(pos))
            theirs(el.embedding_lookup(arenas[0], slot),
                   el.embedding_lookup(arenas[1], slot), g, outs)
            for a, v in zip(arenas, outs):
                el.embedding_scatter(a, slot, v)
            return outs

        def fused(arenas, g=g):
            return fr.ftrl_apply_slots(pos, found, slot_of, *arenas, g, **kw)

        a_old = [a.clone() for a in start]
        a_new = [a.clone() for a in start]
        got_old, got_new = chain(a_old), fused(a_new)
        if not all(torch.equal(x, y) for x, y in
                   zip([*got_old, *a_old], [*got_new, *a_new])):
            raise AssertionError(f"the push at D = {d}: not bit-equal")
        label = (f"the push after its probe: {b} ids of a master's "
                 f"{m.capacity}-slot map into ({rows}, {d}) arenas")
        results.append(_turns("ftrl_apply_slots", label,
                              lambda: chain(a_old), lambda: fused(a_new)))
        if d == 8:
            slot = slot_of[pos]
            z, n = (el.embedding_lookup(a, slot) for a in start[:2])
            mine = fr.ftrl_row_update(z, n, g, **kw)
            theirs(z, n, g, outs)
            if not all(torch.equal(x, y) for x, y in zip(mine, outs)):
                raise AssertionError("ftrl_row_update: not bit-equal")
            results.append(_turns(
                "ftrl_row_update", f"{b}x{d} f32 contiguous rows",
                lambda: theirs(z, n, g, outs),
                lambda: fr.ftrl_row_update(z, n, g, **kw)))
        del start, a_old, a_new
        torch.cuda.empty_cache()
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--embedding-lookup", type=Path,
                    help="the other version of csrc/embedding_lookup.cu")
    ap.add_argument("--delta-codec", type=Path,
                    help="the other version of csrc/delta_codec.cu")
    ap.add_argument("--hashmap-probe", type=Path,
                    help="the other version of csrc/hashmap_probe.cu")
    ap.add_argument("--ftrl-row-update", type=Path,
                    help="the other version of csrc/ftrl_row_update.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.manual_seed(cs.SEED)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    results = []
    if args.embedding_lookup:
        results += compare_copies(args.embedding_lookup, dev)
    if args.delta_codec:
        results += compare_codec(args.delta_codec, dev)
    if args.hashmap_probe:
        results += compare_probes(args.hashmap_probe, dev)
    if args.ftrl_row_update:
        results += compare_ftrl(args.ftrl_row_update, dev)
    print(json.dumps({"card": smi, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
