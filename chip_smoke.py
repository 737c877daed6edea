#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: builds the
serving path's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the path gives it,
then serves the paper's FM-FTRL CTR model at full width through the
port's ``ServingPlane`` and checks it against the port's host path.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Kernels against their plain versions, bit-equal: the in-place probe
   on a 2^20-slot map and the windowed probe on a 2^24-slot wrap-padded
   map, each with a crafted collision cluster longer than a 256-slot
   window; the row gather (N = 4096 x 32 ids, D in {1, 8, 9}) and the
   row scatter (unique ids). The copies are timed here, beside their
   bound (bytes over 3.35 TB/s), their plain version's time and the
   one-call PyTorch equivalent (``library_ms``, never used by the port).
2. The slice: FM_FTRL (32 fields, embed 8, groups w:1 + v:8, feature
   space 2^22), 2 slave shards x 2 replicas, 8 partitions. All 2^22 ids
   get seeded rows through ``convert.load_serve_state``, so each replica
   map has 2^24 slots (windowed probe) while the serve caches stay small
   (in-place probe). Requests: cold at batch 4096, warm at 64..4096, and
   rounds of a 90%-hit request, a warm read that syncs the cache mirror
   (from the second round on through ``embedding_scatter``) and a warm
   read. The launch counters are read around these predicts alone; all
   four kernels must have launched there. Then predictions must agree
   within 1e-5, and served rows be bit-equal, with a ``numpy``-backend
   plane on the host.
3. The probes timed on the slice's own mirrors: the cache's key table
   under a warm request and a replica's under the cold request's ids
   that replica owns — bit-equal to the plain version and the host map.
4. A JSON line of per-kernel numbers, the card's name and power limit
   from ``nvidia-smi``, and the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SEED = 0
REQ_BATCH, FIELDS = 4096, 32
WARM_BATCHES = (64, 128, 256, 512, 1024, 2048, 4096)
WARM_REPS = 8
PARTIAL_ROUNDS = 3


def _call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` called back to back from Python, between
    CUDA events: host dispatch included where it outlasts the device
    work. The only timer for the plain versions, whose host syncs
    cannot be captured in a graph."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, so no
    Python dispatch sits between launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def crafted_ids(home: int, count: int, shift: int,
                rng: np.random.Generator) -> np.ndarray:
    """``count`` ids whose Fibonacci home slot is ``home``: the hash is
    multiplication by an odd constant mod 2^64, so it inverts — pick
    products with the wanted top bits and multiply back."""
    fib = 0x9E3779B97F4A7C15
    inv = pow(fib, -1, 1 << 64)
    low = rng.integers(0, 1 << (shift - 1), size=count, dtype=np.int64)
    prods = (np.uint64(home) << np.uint64(shift)) | low.astype(np.uint64)
    ids = (prods * np.uint64(inv)).view(np.int64)   # wraps mod 2^64
    return ids[ids > -2 ** 63 + 1]


def probe_case(cap_pow: int, n_live: int, n_query: int,
               rng: np.random.Generator):
    """A map of 2^cap_pow slots holding ~n_live ids (tombstones, and a
    collision cluster several 256-slot windows long) and a query batch
    of present, deleted, absent, clustered and sentinel ids."""
    from repro_torch.core.hashmap import IdHashMap
    m = IdHashMap(1 << cap_pow)
    shift = int(m.shift)
    home = int(rng.integers(0, 1 << cap_pow))
    cluster = np.unique(crafted_ids(home, 700, shift, rng))
    live = np.unique(rng.integers(-2 ** 62, 2 ** 62, size=n_live))
    live = np.setdiff1d(live, cluster)
    m.put(np.concatenate([live, cluster]),
          np.arange(len(live) + len(cluster)))
    dead = live[:n_live // 10]
    m.delete(dead)
    if m.capacity != 1 << cap_pow:
        raise RuntimeError(f"probe case grew its map to {m.capacity}")
    stray = crafted_ids(home, 64, shift, rng)          # walk the cluster
    parts = [live, cluster, dead, stray,
             rng.integers(-2 ** 62, 2 ** 62, size=n_query // 4),
             np.array([-2 ** 63, -2 ** 63 + 1], np.int64)]
    pool = np.concatenate(parts)
    q = pool[rng.integers(0, len(pool), size=n_query)]
    q[:len(cluster)] = cluster                         # every chain walked
    return m, q


def _row(name, source, replaces, err, kernel, plain, library, nbytes,
         shape) -> dict:
    """Time a kernel that already matched its plain version, and print
    and return its entry of the result line."""
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source}",
           "replaces": replaces, "max_abs_err": float(err),
           "ms": _device_ms(kernel), "call_ms": _call_ms(kernel),
           "plain_ms": _call_ms(plain, iters=3, warmup=1),
           "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
           "library_ms": _device_ms(library) if library else None}
    lib = "" if library is None else f", library {row['library_ms']:.5f}"
    print(f"kernel {name} at {shape}: bit-equal to its plain version; "
          f"{row['ms']:.5f} ms on the device ({row['call_ms']:.5f} per "
          f"Python call), bound {row['bound_ms']:.5f}, plain "
          f"{row['plain_ms']:.5f}{lib}", flush=True)
    return row


PROBES = {"hashmap_probe": "src/repro/kernels/hashmap_probe.py:171",
          "hashmap_probe_hbm": "src/repro/kernels/hashmap_probe.py:339"}


def _probe_fns(name):
    from repro_torch.kernels import hashmap_probe as hm
    from repro_torch.kernels import ref
    return getattr(hm, name), getattr(ref, name)


def check_probe(name, keys, ids, shift: int, host_map) -> int:
    """Kernel ``name`` against its plain version and the host map on one
    batch: ``found`` equal everywhere, ``pos`` where found. Returns the
    number of ids found."""
    import torch
    fn, plain = _probe_fns(name)
    pos, found = fn(keys, ids, shift=shift)
    ppos, pfound = plain(keys, ids, shift=shift)
    hpos, hfound = host_map._probe(ids.cpu().numpy())
    f = found.cpu().numpy()
    if not (torch.equal(found, pfound) and (f == hfound).all()):
        raise AssertionError(f"{name}: found differs from plain/host "
                             f"({int((f != hfound).sum())} ids)")
    if not (torch.equal(pos[found], ppos[found])
            and (pos.cpu().numpy()[f] == hpos[hfound]).all()):
        raise AssertionError(f"{name}: pos differs where found")
    return int(f.sum())


def probe_row(name, keys, ids, shift: int, host_map, what: str) -> dict:
    """Check probe ``name`` on one of the slice's own tables and batches,
    then time it there. Bound: ids in, pos + found out, one 32-byte
    sector per id at its home slot, one 8-slot window (64 B) more for
    each id the home slot does not resolve."""
    import torch

    from repro_torch.kernels import ref
    fn, plain = _probe_fns(name)
    n_found = check_probe(name, keys, ids, shift, host_map)
    n = ids.shape[0]
    k_home = keys[ref.home_slots(torch.where(ids <= ref.TOMB, 0, ids),
                                 shift)]
    tail = int(((k_home != ids) & (k_home != ref.EMPTY)
                & (ids > ref.TOMB)).sum().item())
    nbytes = n * (8 + 4 + 1) + n * 32 + tail * 64
    return _row(name, "hashmap_probe.cu", PROBES[name], 0,
                lambda: fn(keys, ids, shift=shift),
                lambda: plain(keys, ids, shift=shift), None, nbytes,
                f"{what}: {1 << (64 - shift)} slots, {n} ids ({n_found} "
                f"found, {tail} past home)")


def phase_kernels(dev, rng) -> list[dict]:
    """Each kernel against its plain version on the card, bit-equal; the
    copies timed (the probes are timed on the slice's own tables)."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import hashmap_probe as hm
    from repro_torch.kernels import ref
    n = REQ_BATCH * FIELDS
    rows = []

    for name, cap_pow in (("hashmap_probe", 20), ("hashmap_probe_hbm", 24)):
        m, q = probe_case(cap_pow, (1 << cap_pow) // 5, n, rng)
        keys = torch.from_numpy(m.key_table.copy()).to(dev)
        if name == "hashmap_probe_hbm":
            keys = hm.wrap_pad(keys, cap=m.capacity)
        ids, shift = torch.from_numpy(q).to(dev), int(m.shift)
        n_found = check_probe(name, keys, ids, shift, m)
        fn = _probe_fns(name)[0]
        crafted_ms = _device_ms(lambda: fn(keys, ids, shift=shift))
        print(f"kernel {name} at {1 << cap_pow} slots, {n} ids with a "
              f"crafted collision cluster ({n_found} found): bit-equal to "
              f"its plain version and the host map; {crafted_ms:.5f} ms on "
              f"the device", flush=True)
        del keys, ids

    v_rows = 1 << 21
    for d in (1, 8, 9):
        table = torch.randn(v_rows, d, device=dev)
        ids = torch.randint(0, v_rows, (n,), device=dev, dtype=torch.int32)
        out = el.embedding_lookup(table, ids)
        want = ref.embedding_lookup(table, ids)
        if not torch.equal(out, want):
            raise AssertionError(f"embedding_lookup D={d}: not bit-equal")
        ids_l = ids.long()
        row = _row("embedding_lookup", "embedding_lookup.cu",
                   "src/repro/kernels/embedding_lookup.py:30",
                   (out - want).abs().max().item(),
                   lambda: el.embedding_lookup(table, ids),
                   lambda: ref.embedding_lookup(table, ids),
                   lambda: torch.index_select(table, 0, ids_l),
                   n * 4 + 2 * n * d * 4, f"{v_rows}x{d} f32, {n} ids")
        if d == 9:                      # the serve cache's row
            rows.append(row)

        uniq = torch.randperm(v_rows, device=dev)[:n].to(torch.int32)
        upd = torch.randn(n, d, device=dev)
        got = el.embedding_scatter(table.clone(), uniq, upd)
        want = ref.embedding_scatter(table.clone(), uniq, upd)
        if not torch.equal(got, want):
            raise AssertionError(f"embedding_scatter D={d}: not bit-equal")
        uniq_l = uniq.long()
        row = _row("embedding_scatter", "embedding_lookup.cu",
                   "src/repro/kernels/embedding_lookup.py:122",
                   (got - want).abs().max().item(),
                   lambda: el.embedding_scatter(table, uniq, upd),
                   lambda: ref.embedding_scatter(table, uniq, upd),
                   lambda: table.index_copy_(0, uniq_l, upd),
                   n * 4 + 2 * n * d * 4,
                   f"{v_rows}x{d} f32, {n} unique ids")
        if d == 9:
            rows.append(row)
        del table, ids, out, want, got, upd
    return rows


def build_plane(cfg, plan, groups, state, backend: str, device):
    """A serving plane over 2 x 2 slave replicas loaded with ``state``."""
    from repro_torch.convert import load_serve_state
    from repro_torch.core.fault_tolerance import ReplicaSet
    from repro_torch.core.ps import SlaveShard
    from repro_torch.serving import ServingPlane
    sets = [ReplicaSet([SlaveShard(sid, groups, backend=backend,
                                   device=device) for _ in range(2)])
            for sid in range(plan.num_slave)]
    load_serve_state(sets, plan, state)
    plane = ServingPlane(plan, sets, groups, ps_backend=backend,
                         device=device)
    plane.add_scenario(cfg)
    return plane


def profile_predicts(plane, req, reps: int = 8) -> dict:
    """Where the time of a warm predict goes: ``reps`` predicts of
    ``req`` under ``torch.profiler`` (CPU + CUDA activity). Returns the
    wall time and the device-busy time per predict (sum of the CUDA
    kernels' and copies' own device time) and the top device entries;
    ``busy_ms`` is None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    plane.predict(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            plane.predict(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in dev)
    dev.sort(key=lambda kv: -kv[1])
    return {"wall_ms": wall * 1e3 / reps,
            "busy_ms": busy_us / 1e3 / reps if dev else None,
            "top": [(k[:60], us / 1e3 / reps) for k, us in dev[:6]]}


def drive_slice(device, *, feature_space: int, batch: int, fields: int,
                warm_batches, warm_reps: int, partial_rounds: int,
                seed: int = SEED) -> dict:
    """Serve FM_FTRL (``fields`` wide, ``feature_space`` ids) on a
    ``torch``-backend plane on ``device`` and on a ``numpy``-backend plane
    on the host; check rows bit-equal and predictions within 1e-5.
    Returns the latencies and counters the report prints."""
    import torch

    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.kernels import ops
    from repro_torch.models.ctr import groups_for

    cfg = dataclasses.replace(FM_FTRL, fields=fields,
                              feature_space=feature_space)
    groups = groups_for(cfg)
    plan = RoutingPlan(num_master=4, num_slave=2, num_partitions=8)
    rng = np.random.default_rng(seed)
    ids = np.arange(feature_space, dtype=np.int64)
    state = {g: (ids, (0.05 * rng.standard_normal(
        (feature_space, dim), dtype=np.float32))) for g, dim in groups.items()}
    t0 = time.perf_counter()
    host = build_plane(cfg, plan, groups, state, "numpy", "cpu")
    plane = build_plane(cfg, plan, groups, state, "torch", device)
    load_s = time.perf_counter() - t0
    del state

    cold = rng.integers(0, feature_space, size=(batch, fields))
    requests = [(f"cold {batch}", cold)]
    for b in warm_batches:
        requests += [(f"warm {b}", cold[:b])] * warm_reps
    req = cold
    for _ in range(partial_rounds):
        req = req.copy()
        fresh = rng.random(req.shape) < 0.1
        req[fresh] = rng.integers(0, feature_space, size=int(fresh.sum()))
        # the read after a fill syncs the cache's device mirror
        requests += [(f"90%-hit {batch}", req), (f"post-fill {batch}", req),
                     (f"warm {batch}", req)]

    # the main path: predicts alone between the counters' reset and read
    lat: dict[str, list] = {}
    per_request: dict[str, list] = {}       # launches of each predict
    preds = []
    ops.reset_launches()
    for label, r in requests:
        before = ops.launch_counts()
        t = time.perf_counter()
        preds.append(plane.predict(r))
        lat.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
        after = ops.launch_counts()
        per_request.setdefault(label, []).append(
            tuple(after[k] - before[k] for k in after))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    summed = np.sum([c for v in per_request.values() for c in v], axis=0)
    if tuple(summed) != tuple(launches.values()):
        raise AssertionError(f"launches {launches} are not the sum over "
                             f"the predicts {tuple(summed)}")

    # comparisons with the host path; they launch kernels of their own
    max_dev = 0.0
    for (label, r), p in zip(requests, preds):
        want = host.predict(r)
        if p.shape != (len(r),) or not np.isfinite(p).all():
            raise AssertionError(f"{label}: predictions not finite of shape "
                                 f"({len(r)},)")
        max_dev = max(max_dev, float(np.abs(p - want).max()))
        if not np.allclose(p, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{label}: predictions differ from the "
                                 f"host path by {np.abs(p - want).max():.3g}")
    for r in {id(r): r for _, r in requests}.values():
        got_rows, want_rows = plane.serve_rows(r), host.serve_rows(r)
        for g in groups:
            if not np.array_equal(got_rows[g], want_rows[g]):
                raise AssertionError(f"served {g} rows differ from the "
                                     f"host path")

    scn, hscn = plane.scenario(), host.scenario()
    for key in ("hits", "misses"):
        if scn.cache.stats()[key] != hscn.cache.stats()[key]:
            raise AssertionError(f"cache {key} differ from the host path")
    if plane.shard_pulled_rows != host.shard_pulled_rows:
        raise AssertionError("shard_pulled_rows differ from the host path")
    placements = {scn.cache.table.mirror_metrics()["placement"]}
    mirror_bytes = 0
    for rs in plane.replica_sets:
        for rep in rs.replicas:
            for t in rep.tables.values():
                if t.mirror_metrics() is not None:
                    placements.add(t.mirror_metrics()["placement"])
                    mir = t._dev
                    mirror_bytes += sum(a.nbytes for a in (
                        mir.keys, mir.slot_of, *mir.arenas.values()))
    cache_mir = scn.cache.table._dev
    mirror_bytes += sum(a.nbytes for a in (
        cache_mir.keys, cache_mir.slot_of, *cache_mir.arenas.values()))
    cache_stats, cache_mirror = scn.cache.stats(), cache_mir.metrics()
    device_blocks = plane.device_blocks
    # profiled predicts run after every comparison with the host path:
    # they move the cache counters of this plane only
    profiles = {b: profile_predicts(plane, cold[:b])
                for b in (warm_batches[0], warm_batches[-1])} \
        if device.type == "cuda" else {}

    # each probe's table and batch as the path gives them: the cache's
    # key table under the last warm request, and a replica's under the
    # cold request's ids its shard owns; keyed by the kernel each
    # mirror's placement takes
    rep, table = next((rep, t) for rs in plane.replica_sets
                      for rep in rs.replicas for t in rep.tables.values()
                      if t._dev is not None)
    ucold = np.unique(cold)
    owned = ucold[plan.slave_shard(ucold) == rep.shard_id]
    probe_inputs = {}
    for t, q, what in (
            (scn.cache.table, requests[-1][1].reshape(-1),
             f"serve cache, warm request at batch {batch}"),
            (table, owned, f"replica of shard {rep.shard_id}, the cold "
                           f"request's ids it owns")):
        name = {"vmem": "hashmap_probe",
                "hbm": "hashmap_probe_hbm"}[t._dev.placement]
        probe_inputs[name] = (t._dev.keys, torch.from_numpy(q).to(device),
                              t._dev.shift, t._map, what)
    return {"launches": launches, "placements": placements,
            "latency_ms": lat, "launches_per_predict": per_request,
            "profiles": profiles, "max_pred_dev": max_dev, "load_s": load_s,
            "mirror_bytes": mirror_bytes,
            "cache": cache_stats, "cache_mirror": cache_mirror,
            "shard_pulled_rows": plane.shard_pulled_rows,
            "device_blocks": device_blocks, "requests": len(requests),
            "probe_inputs": probe_inputs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
          f"card: {smi}", flush=True)

    t = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    kernels = phase_kernels(dev, rng)

    from repro_torch.configs.weips_ctr import FM_FTRL
    t = time.perf_counter()
    res = drive_slice(dev, feature_space=FM_FTRL.feature_space,
                      batch=REQ_BATCH, fields=FM_FTRL.fields,
                      warm_batches=WARM_BATCHES, warm_reps=WARM_REPS,
                      partial_rounds=PARTIAL_ROUNDS)
    print(f"slice: FM_FTRL fields={FM_FTRL.fields} embed_dim="
          f"{FM_FTRL.embed_dim} feature_space={FM_FTRL.feature_space}, "
          f"{res['requests']} requests in {time.perf_counter() - t:.1f} s "
          f"(state load {res['load_s']:.1f} s); served rows bit-equal to "
          f"the host path, max prediction deviation "
          f"{res['max_pred_dev']:.3g}", flush=True)
    for label, v in res["latency_ms"].items():
        counts = sorted(set(res["launches_per_predict"][label]))
        print(f"  predict {label:>12}: p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms over {len(v)}; launches "
              f"per predict (probe, probe_hbm, lookup, scatter) {counts}")
    for b, prof in res["profiles"].items():
        busy = "not visible to torch.profiler" if prof["busy_ms"] is None \
            else (f"{prof['busy_ms']:.4f} ms "
                  f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy)")
        print(f"  profiled warm predict at batch {b}: wall "
              f"{prof['wall_ms']:.3f} ms, device {busy}; top "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in prof["top"]))
    print(f"  cache {res['cache']}; cache mirror {res['cache_mirror']}")
    print(f"  shard_pulled_rows {res['shard_pulled_rows']}, device_blocks "
          f"{res['device_blocks']}, placements {sorted(res['placements'])}, "
          f"table bytes on the device {res['mirror_bytes']}")
    print(f"  launches in the slice's predicts: {res['launches']}")
    missing = [k for k, v in res["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the slice's "
                             f"predicts: {missing}")
    if res["placements"] != {"vmem", "hbm"}:
        raise AssertionError(f"placements taken: {res['placements']}")

    probes = res.pop("probe_inputs")
    kernels = [probe_row(k, *probes[k]) for k in PROBES] + kernels
    del probes
    print("kernels: " + ", ".join(ops.KERNELS))
    for row in kernels:
        row["launches"] = res["launches"][row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
