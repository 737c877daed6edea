#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version at the shapes the path gives it, then
runs the paper's online-learning loop for the FM-FTRL CTR model at full
width — train on master shards, stream through the int8 codec to the
serving replicas, serve from the streamed rows — and checks it against
the port's host path; then drives the whole ``WeiPSCluster`` (click
stream, joiner, pipeline, checkpoints, faults, domino downgrade) beside
a host twin; then the multi-process ``ClusterRuntime`` (a process per
shard, SIGKILLs at its crash windows) beside a host twin and a
fault-free run; then serves qwen2-1.5b at full width (prefill and
greedy decode with hot weight swaps) and checks it against the same
model on the plain attention; then trains qwen2-1.5b at full width with
Adam, streams it to a serving replica and hot-swaps the replica's params
into a decoding driver.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Kernels against their plain versions, bit-equal: the in-place probe
   on a 2^20-slot map and the hbm probe on a 2^24-slot wrap-padded map,
   each with a crafted collision cluster longer than 256 slots; the row
   gather and the row scatter-set (unique ids) at N =
   4096 x 32 ids into a 2^21-row float32 table, D in {1, 8, 9}, and at
   qwen2-1.5b's token-gather shape (8,192 ids x 1,536 bf16 from its
   152,064-row table). The copies are timed here, beside their bound
   (bytes over 3.35 TB/s), their plain version's time and the one-call
   PyTorch equivalent (``library_ms``: ``index_select``,
   ``index_copy_``; never used by the port), and at D = 9 with a cold
   L2 too: 16 id batches in turn, whose rows touch more sectors than the
   50 MB L2 holds.
2. The loop: FM_FTRL (32 fields, embed 8, groups w:1 + v:8 with FTRL
   slots (z, n), feature space 2^22) on 4 master shards, 2 slave shards
   x 2 replicas, 8 partitions, int8 codec, realtime gather. The ids are
   2^22 distinct splitmix64 hashes, so the maps' probes meet collisions.
   ``convert.load_train_state`` puts seeded (z, n) on the masters; a
   bootstrap flush streams every master row (Pusher → ``quantize_rows``
   → queue → Scatter → ``dequantize_rows`` → replica tables). A host
   path of the same shape (``numpy`` PS and codec backends) is built and
   loaded beside it.
3. Serving over the streamed replicas, as the serving slice runs it:
   cold at batch 4096, warm at 64..4096, and rounds of a 90%-hit
   request, a warm read that syncs the cache mirror and a warm read. The
   launch counters are reset before these predicts and read after them;
   the four serving kernels must have launched there. Predictions agree
   within 1e-5, and served rows are bit-equal, with the host plane. The
   probes are then timed on the loop's own mirrors (the serve cache's
   under the last warm request; a replica's under the cold request's ids
   it owns), and the hbm probe with a cold L2 too: 32 batches of as many
   live replica ids in turn, whose home slots touch more 32-byte sectors
   than the 50 MB L2 holds.
4. Train → sync → serve: 16 ``TrainingPlane.train_batch`` steps of 4096 x
   32 ids, each followed by a sync tick (collect → gather → push, then a
   poll on every replica, whose ``on_apply`` invalidates the serving
   caches), then post-update, post-fill and warm predicts. The counters
   are reset before and read after; ``ftrl_row_update``,
   ``quantize_rows`` and ``dequantize_rows`` must have launched. Then
   the host masters apply exactly the pushes the card's masters received
   (recorded here), and master rows (w, z, n), queue records (ids, seq,
   meta, payload bytes), replica rows and served rows must be bit-equal
   to the card's, with predictions within 1e-5; the card's loss and row
   gradients for one batch must match the CPU's within rtol 1e-5, atol
   1e-6. The train and sync kernels are then held against their plain
   versions on the path's own inputs and timed, and so is the probe of
   the fused FTRL push (one master's largest group-v push of the last
   step against that master's 2^23-slot key mirror). The FTRL rows'
   bound is the larger of their bytes and their instruction issue: the
   MUFU and FP32 instructions an element issues, counted in the
   library's SASS (``cuobjdump -sass``), over 16 MUFU and 128 issued
   instructions a clock on each of the 132 SMs at the card's top SM
   clock. ``ftrl_apply_slots``, the push after its probe in one pass, is
   held bit-equal to its plain version (arenas and row outputs) on the
   largest group-v and group-w pushes of the last step against their
   masters' mirrors and arenas, timed beside its bound and beside the
   chain it replaces (slot translate, two gathers, ``ftrl_row_update``,
   three scatter-sets); one push through ``ops.fused_ftrl_apply`` must
   launch exactly two kernels, the probe and the pass: the launch
   counters and the nodes of a CUDA graph it is captured into
   (``cuGraphGetNodes``) must show the two, and its ``torch.profiler``
   profile (which may miss some of them) no other kernel. Then the
   int8 codec beyond the path's shapes: rows of zeros, NaN, +Inf and
   -Inf at a width of every ``codec_plan`` regime, whose codes and
   scales must be the CPU's plain version's (the reference's: scale NaN
   or inf, codes 0); and ``CODEC_SHAPES`` (the bootstrap's 2^20 x 8 encode and a
   65,536 x 8 record, 65,536 x 1,536, and ONE row of 385,351,680 floats,
   a qwen2-1.5b MLP leaf), each bit-equal to its plain version, then
   timed beside its bound, its plain version and, for dequantize,
   ``torch.mul``.
5. The cluster: ``WeiPSCluster`` with its defaults (torch PS and codec
   backends on the card) for FM_FTRL at full width (FTRL l1 0.01, alpha
   0.2, as the repo's serving tests set it), 4 masters, 2 slave shards x
   2 replicas, 8 partitions, int8 sync codec, the durable ``FileQueue``,
   int8 delta-chain checkpoints (local every ~1 s, remote every ~4 s of
   the stream clock) and the domino downgrade (logloss over 0.72 across
   10 batches, read once 15 are in). 48 ticks 0.2 s apart, each 4096
   ``ClickStream`` events (Zipf a = 1.2 over 2^22 ids) through
   ``SampleJoiner`` → ``TrainPipeline`` → ``train_scheduler.tick`` →
   ``sync_tick`` → ``maybe_checkpoint`` → ``downgrade_check``; a flush
   past the join window; warm predicts of 4096 x 32 ids. Then a delta
   and a full checkpoint, each of whose chains must be the live masters
   (ids and touch stats equal, (w, z, n) equal to the NumPy int8 codec's
   round trip, the card's decoded chain equal to the host's); kill →
   recover of master 1 (its tables equal the chain's shard-1 rows);
   ``add_slave_replica(0)`` (its ids its peers', its rows the chain's
   serve rows overlaid with the records after the checkpoint's offsets,
   and a peer's for every id streamed since); then
   ``ClickStream.corrupt()`` and ticks until ``downgrade_check`` fires
   the hot switch (at most 40), after which every replica holds the
   serve transform of the chosen checkpoint, its scatter sits at the
   checkpoint's offsets and the serve cache is empty. A host twin (numpy backends, on the
   CPU) applies the card's recorded pushes and makes the same calls at
   the same points: masters, queue records, every checkpoint and every
   replica bit-equal, predictions within 1e-5. ``sync_metrics()``
   carries the 63 frozen names of ``tests/test_metrics_schema.py`` plus
   the pipeline's 11. The launch counters are reset before the phase
   and read after it, the checks' own launches taken out; the probe,
   the gather, the scatter-set, ``ftrl_row_update`` and the codec must
   have launched. Train tick, sync tick and warm predict p50 / p99, the
   join wait, checkpoint times and sizes, the fault times, peak device
   memory before and after the faults and one profiled tick's busy share
   are printed. The phase runs in a child process (``--cluster-phase``):
   its ``torch.profiler`` session stays out of this process, whose later
   sessions would lose kernels, and its state is gone before the LM
   phases.
5b. The multi-process runtime: ``ClusterRuntime`` (``repro_torch.launch``)
   at LR_FTRL's full width (group emb of width 1, FTRL, 32 ids a sample
   over 2^22, batches of 4096), int8 sync codec, 4 masters and 2 slave
   shards x 2 replicas, each its own OS process with its own CUDA
   context on ``cuda:0``, 8 partitions of the ``FileQueue``, a
   manifest-committed cut every 4 steps (every third full), traced.
   24 steps under ``runtime_plan()``: SIGKILLs of a master at
   ``mid_train``, one at ``mid_flush``, one at ``mid_ckpt`` while it
   writes a delta, and of a slave replica at ``pre_apply``; a dropped
   fetch and a delayed flush; ``add_replica(0)`` at step 16 and
   ``remove_replica`` at step 20. Then lookup RPCs of 4096 x 32 ids
   each replica owns on every replica (the serve cache is off, so each
   takes the replica's probe and gather; the first call apart from 8
   warm ones). The same run on a host twin (numpy backends, CPU) must
   give bit-equal masters, slaves, queue offsets and lookups, and a
   fault-free run on the card bit-equal masters (the trajectory
   invariant); ``recoveries`` must equal the kills, the merged Perfetto
   trace must hold ``driver.step``, ``fault.kill`` and ``recover``, and
   the workers' ``kernels`` counters, summed, must show a probe,
   ``ftrl_row_update``, the gather, the scatter-set and both codec
   kernels launched. Startup, step p50 / p99 (host clock around
   ``step_once``), each recovery from the first ``WorkerDied`` back to
   the step that died (with its reap, respawn and restore), the
   ``add_replica`` and checkpoint commit times, lookup times and each
   worker's device memory (``nvidia-smi --query-compute-apps``) are
   printed. The phase runs in a child process (``--runtime-phase``),
   whose supervisor spawns the workers; the twin and the fault-free run
   run side by side, after the timed run.
6. LM serving, qwen2-1.5b at full width (28 layers, random weights from
   the seed). (At the build, before phase 1: the whole ``-Xptxas -v``
   report of ``flash_attention_sm90.cu`` and ``decode_attention.cu``, and
   the count of ``HGMMA`` and ``UTMALDG`` instructions in the bf16 flash
   kernel's SASS from ``cuobjdump -sass``, which must not be 0: the
   tensor cores and TMA are on its path.) First ``flash_attention`` (bf16
   on the wgmma/TMA kernel, float32 on the CUDA-core one) and
   ``decode_attention`` (split-KV) against
   their plain versions at the path's shapes (prefill q (4, 12, 2048,
   128) causal in bf16 and f32, a ragged S = 1000, a full (non-causal)
   case; decode q (4, 12, 128) against a (4, 4096, 2, 128) cache, mixed
   lengths 1..4096), within 2e-5 (f32) and 2e-2 (bf16). Then, with the
   counters reset before and read after: ``make_prefill_step`` on 4 x
   2048 tokens in float32 (logits within 1e-3 of the plain path's) and
   in bf16 (timed; logits within the bound ``BF16_LOGIT_BOUND`` set in
   PERF.md); ``launch.serve``'s own run (batch 4, 32 steps, max_len 64,
   float32 cache, a hot swap every 8 steps) through the ``ServeDriver``
   it builds; and a decode against a long cache seeded up to position
   4000 of 4096 (the reference has no prefill-to-cache path; seeding is
   the cut that puts the kernel at a real length). Decode is compared
   teacher-forced: the plain path replays the kernel path's tokens,
   params and positions on its own copy of the cache, logits at every
   step within the bf16 bound; greedy agreement is printed, not held.
   ``flash_attention`` must launch 28 times a forward and
   ``decode_attention`` 28 times a step, ``embedding_lookup`` (the token
   gather) once a forward and once a step. Both attentions are then
   timed beside their bound, their plain versions and
   ``torch.nn.functional.scaled_dot_product_attention`` (never used by
   the port).
7. LM training, qwen2-1.5b at full width (bf16, Adam, remat). First
   ``embedding_scatter_add`` against its plain version, bit-equal (and
   two calls equal), in float32 and bf16, on a (151936, 1536) table with
   three mixes of 4096 ids: one ``lm_batches`` batch's 4 x 1024 token
   ids, Zipf (s = 1.0) ids over the vocabulary and 4096 rows of one id,
   each mix timed in bf16. The scatter-add is then timed on one batch's
   ids beside its bound, its plain version and ``Tensor.index_add_``
   (never used by the port), and split into the sort's time and the
   kernel's (each timed alone; one call profiled, which must list the
   sort and ``scatter_add_rows_kernel`` and no gather). Then one
   float32 train step's loss and gradients on the kernel path against the
   plain path (``plain_attention()`` also swaps the token gather and its
   gradient): loss within rtol ``F32_LOSS_RTOL``, the embed, layer-0
   ``wq`` and last-layer ``w_down`` gradients within ``F32_GRAD_BOUND``
   of their largest magnitude. Then, with the counters reset before and
   read after, ``launch.train``'s own run (``TRAIN_ARGV``: 8 steps of 4 x
   1024, cast16, a sync period of 5 on a clock that counts steps, so one
   periodic flush and the final one): ``embedding_scatter_add`` and
   ``embedding_lookup`` once a step, ``flash_attention`` 56 times a step
   (28 forward, 28 in remat's recompute); the replica's staleness against
   the trained params under 2e-3. Step p50 / p99, tokens/s, ``mfu`` (model
   FLOPs over step time over 989 TFLOP/s), peak memory and each flush's
   time, records and bytes are printed. Then the trained params are
   flushed once through the int8 codec on the card (``--codec int8``: a
   ``ModelSyncEngine`` whose replica starts from the initial params, every
   leaf one codec row, split over the card): its time beside the cast16
   flushes, the codec's launches equal to what the leaves' plans want,
   the replica's staleness under the reference's int8 bound of 2e-2, and
   the largest leaf's codes and scale equal to the plain version's on the
   card. Last, a ``ServeDriver`` started
   on the initial params decodes 4 steps, hot-swaps in the replica's
   ``device_params`` and decodes 8 more: logits finite, 28
   ``decode_attention`` launches a step.
8. The launches of both probes, the gather, the scatter-set,
   ``ftrl_row_update`` and the codec on every path above (serving
   predicts, bootstrap flush, train -> sync -> serve, the cluster, the
   runtime's workers, LM serving, the LM training run and its hot-swap
   decode), each read
   after its own reset. A train push is the
   probe and one ``ftrl_apply_slots`` launch (counted on
   ``ftrl_row_update``), so train -> sync -> serve launches no gather or
   scatter-set for its pushes: their launches there are the sync
   tick's and the predicts'. A JSON line of
   per-kernel numbers, the card's name and power limit from
   ``nvidia-smi``, and the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SMS = 132                           # H100 SXM streaming multiprocessors
# thread instructions a clock an SM: MUFU (RCP, RSQ) and issue (4 warp
# schedulers x 32 lanes; the FP32 pipes keep the same pace)
MUFU_PER_CLOCK, ISSUE_PER_CLOCK = 16, 128
SEED = 0
COPY_ROWS = 1 << 21                 # table rows of the CTR copy cases
COLD_BATCHES = 16                   # id batches of a cold-L2 copy figure
COLD_PROBE_BATCHES = 32             # id batches of the probe's cold-L2 line
REQ_BATCH, FIELDS = 4096, 32
WARM_BATCHES = (64, 128, 256, 512, 1024, 2048, 4096)
WARM_REPS = 8
PARTIAL_ROUNDS = 3
TRAIN_STEPS = 16
SERVE_KERNELS = ("hashmap_probe", "hashmap_probe_hbm", "embedding_lookup",
                 "embedding_scatter")
# kernels whose launches are summed over every path (phase 8)
PATH_KERNELS = ("hashmap_probe", "hashmap_probe_hbm", "embedding_lookup",
                "embedding_scatter", "ftrl_row_update", "quantize_rows",
                "dequantize_rows")
TRAIN_KERNELS = ("ftrl_row_update", "quantize_rows", "dequantize_rows")
# sources whose whole ptxas report is printed (the redesigned attention)
PTXAS_FULL = ("flash_attention_sm90", "decode_attention")
# the attention kernels' symbols, whose device time each profile sums
ATTENTION_KERNELS = ("flash_attention_sm90_kernel", "flash_attention_kernel",
                     "decode_attention_kernel")
# the scatter-add kernel's symbol
SCATTER_ADD_KERNEL = "scatter_add_rows_kernel"


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


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many instructions of each opcode the built library of
    ``csrc/<name>.cu`` holds, from ``cuobjdump -sass`` (HGMMA: wgmma on
    the tensor cores; UTMALDG: a TMA tile load)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    words = [w for line in sass.splitlines() for w in line.split()]
    return {op: sum(w.split(".")[0] == op for w in words) for op in opcodes}


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
         shape, *, flops: float = 0.0, peak: float = 1.0,
         agreement: str = "bit-equal to its plain version") -> dict:
    """Time a kernel that already matched its plain version, and print
    and return its entry of the result line. The bound is the larger of
    ``nbytes`` over the memory rate and ``flops`` over ``peak``."""
    by_ops = flops / peak * 1e3 > _bound_ms(nbytes)
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source}",
           "replaces": replaces, "max_abs_err": float(err),
           "ms": _device_ms(kernel), "call_ms": _call_ms(kernel),
           "plain_ms": _call_ms(plain, iters=3, warmup=1),
           "bound_ms": flops / peak * 1e3 if by_ops else _bound_ms(nbytes),
           "bound_by": "operations" if by_ops else "bytes",
           "library_ms": _device_ms(library) if library else None}
    lib = "" if library is None else f", library {row['library_ms']:.5f}"
    print(f"kernel {name} at {shape}: {agreement}; "
          f"{row['ms']:.5f} ms on the device ({row['call_ms']:.5f} per "
          f"Python call), bound {row['bound_ms']:.5f}, plain "
          f"{row['plain_ms']:.5f}{lib}", flush=True)
    return row


PROBES = {"hashmap_probe": "src/repro/kernels/hashmap_probe.py:171",
          "hashmap_probe_hbm": "src/repro/kernels/hashmap_probe.py:339"}
# the probe kernel a device mirror's placement takes
PROBE_OF = {"vmem": "hashmap_probe", "hbm": "hashmap_probe_hbm"}


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
    fn, plain = _probe_fns(name)
    n_found = check_probe(name, keys, ids, shift, host_map)
    nbytes, tail = probe_bytes(keys, ids, shift)
    return _row(name, "hashmap_probe.cu", PROBES[name], 0,
                lambda: fn(keys, ids, shift=shift),
                lambda: plain(keys, ids, shift=shift), None, nbytes,
                f"{what}: {1 << (64 - shift)} slots, {ids.shape[0]} ids "
                f"({n_found} found, {tail} past home)")


def probe_bytes(keys, ids, shift: int) -> tuple[int, int]:
    """The bytes a probe must move (``probe_row``'s bound) and the number
    of ids its home slot does not resolve."""
    import torch

    from repro_torch.kernels import ref
    n = ids.shape[0]
    k_home = keys[ref.home_slots(torch.where(ids <= ref.TOMB, 0, ids),
                                 shift)]
    tail = int(((k_home != ids) & (k_home != ref.EMPTY)
                & (ids > ref.TOMB)).sum().item())
    return n * (8 + 4 + 1) + n * 32 + tail * 64, tail


def cold_probe_batches(host_map, n: int, device):
    """Up to ``COLD_PROBE_BATCHES`` batches of ``n`` live ids of
    ``host_map``, drawn from the seed without replacement, on ``device``,
    and the bytes of the 32-byte sectors their home slots touch."""
    import torch

    from repro_torch.core.hashmap import home_slots
    live = host_map.keys()
    count = min(COLD_PROBE_BATCHES, len(live) // n)
    pick = live[np.random.default_rng(SEED).permutation(len(live))[
        :count * n]]
    touched = np.unique(home_slots(pick, host_map.shift) // 4).size * 32
    return [torch.from_numpy(b).to(device)
            for b in np.split(pick, count)], touched


def cold_probe_line(keys, ids, shift: int, host_map, what: str) -> dict:
    """``hashmap_probe_hbm`` with a cold L2: batches of as many live ids
    as ``ids`` holds (``cold_probe_batches``), each bit-equal to the plain
    version and the host map, then timed in turn (``_device_ms`` captures
    one cycle), so a batch's home sectors come back only after the other
    batches have touched more than the 50 MB L2 holds (printed). Bound:
    the batches' mean ``probe_bytes``. Returns the time and bound, which
    the result line carries under the kernel's ``l2_cold``."""
    from repro_torch.kernels import hashmap_probe as hm
    batches, touched = cold_probe_batches(host_map, ids.shape[0],
                                          keys.device)
    for b in batches:
        check_probe("hashmap_probe_hbm", keys, b, shift, host_map)
    bound = np.mean([probe_bytes(keys, b, shift)[0] for b in batches])
    ms = _device_ms(_cycling(
        lambda q: hm.hashmap_probe_hbm(keys, q, shift=shift), batches),
        len(batches))
    print(f"kernel hashmap_probe_hbm at {what}, L2 cold ({len(batches)} "
          f"batches of {ids.shape[0]} live ids in turn, their home slots "
          f"touching {touched / 1e6:.1f} MB of 32-byte sectors): bit-equal "
          f"to its plain version and the host map; {ms:.5f} ms on the "
          f"device, bound {_bound_ms(bound):.5f}", flush=True)
    return {"ms": ms, "bound_ms": _bound_ms(bound), "batches": len(batches),
            "ids": ids.shape[0], "home_sector_bytes": int(touched)}


def phase_kernels(dev, rng) -> list[dict]:
    """Each kernel against its plain version on the card, bit-equal; the
    copies timed at D = 1, 8 and 9 float32 and at the LM's token-gather
    shape, and at D = 9 with a cold L2 too (the probes are timed on the
    slice's own tables)."""
    import torch

    from repro_torch.kernels import hashmap_probe as hm
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

    for d in (1, 8, 9):
        table = torch.randn(COPY_ROWS, d, device=dev)
        ids = torch.randint(0, COPY_ROWS, (n,), device=dev,
                            dtype=torch.int32)
        uniq = torch.randperm(COPY_ROWS, device=dev)[:n].to(torch.int32)
        upd = torch.randn(n, d, device=dev)
        what = f"{COPY_ROWS}x{d} f32, {n}"
        gather = gather_row(table, ids, f"{what} ids")
        scatter = scatter_row(table, uniq, upd, f"{what} unique ids")
        if d == 9:                      # the serve cache's row
            rows += [gather, scatter]
            cold_copy_line(table, n, dev)
        del table, ids, uniq, upd

    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)           # the LM's token gather
    n_tok = PREFILL_BATCH * PREFILL_LEN
    table = torch.randn(cfg.padded_vocab, cfg.d_model, device=dev,
                        dtype=torch.bfloat16)
    ids = torch.randint(0, cfg.vocab_size, (n_tok,), device=dev,
                        dtype=torch.int32)
    uniq = torch.randperm(cfg.vocab_size, device=dev)[:n_tok].to(torch.int32)
    upd = torch.randn(n_tok, cfg.d_model, device=dev, dtype=torch.bfloat16)
    what = f"{cfg.padded_vocab}x{cfg.d_model} bf16, {n_tok}"
    gather_row(table, ids, f"{what} token ids ({LM_ARCH}'s token gather)")
    scatter_row(table, uniq, upd, f"{what} unique ids")
    del table, ids, uniq, upd
    return rows


def gather_row(table, ids, what: str) -> dict:
    """``embedding_lookup`` against its plain version, bit-equal, then
    timed beside ``index_select``. Bound: the ids and each row read once,
    each row written once."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    out = el.embedding_lookup(table, ids)
    want = ref.embedding_lookup(table, ids)
    if not torch.equal(out, want):
        raise AssertionError(f"embedding_lookup at {what}: not bit-equal")
    ids_l = ids.long()
    n, row_bytes = ids.shape[0], table.shape[1] * table.element_size()
    return _row("embedding_lookup", "embedding_lookup.cu",
                "src/repro/kernels/embedding_lookup.py:30", 0,
                lambda: el.embedding_lookup(table, ids),
                lambda: ref.embedding_lookup(table, ids),
                lambda: torch.index_select(table, 0, ids_l),
                n * 4 + 2 * n * row_bytes, what)


def scatter_row(table, uniq, upd, what: str) -> dict:
    """``embedding_scatter`` against its plain version, bit-equal, on a
    copy of ``table``, then timed in place beside ``index_copy_``."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    got = el.embedding_scatter(table.clone(), uniq, upd)
    want = ref.embedding_scatter(table.clone(), uniq, upd)
    if not torch.equal(got, want):
        raise AssertionError(f"embedding_scatter at {what}: not bit-equal")
    del got, want
    uniq_l = uniq.long()
    n, row_bytes = uniq.shape[0], table.shape[1] * table.element_size()
    return _row("embedding_scatter", "embedding_lookup.cu",
                "src/repro/kernels/embedding_lookup.py:122", 0,
                lambda: el.embedding_scatter(table, uniq, upd),
                lambda: ref.embedding_scatter(table, uniq, upd),
                lambda: table.index_copy_(0, uniq_l, upd),
                n * 4 + 2 * n * row_bytes, what)


def _cycling(fn, items: list):
    """A call of ``fn`` on the next of ``items`` each time."""
    k = [0]

    def call():
        fn(items[k[0] % len(items)])
        k[0] += 1
    return call


def cold_copy_line(table, n: int, dev) -> None:
    """Both copies and their library calls with a cold L2: each call
    takes the next of ``COLD_BATCHES`` id batches (``_device_ms`` captures
    exactly one cycle), so a batch's rows come back only after the other
    batches have touched far more 32-byte sectors than the 50 MB L2
    holds (printed)."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    v, d = table.shape
    row_bytes = d * table.element_size()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids = [torch.randint(0, v, (n,), device=dev, dtype=torch.int32,
                         generator=gen) for _ in range(COLD_BATCHES)]
    uniq = [torch.randperm(v, device=dev, generator=gen)[:n].to(torch.int32)
            for _ in range(COLD_BATCHES)]
    upd = torch.randn(n, d, device=dev, generator=gen)
    start = torch.cat(ids).long() * row_bytes   # a row spans <= 2 sectors
    if row_bytes > 36:
        raise ValueError(f"{row_bytes}-byte rows: the sector count takes "
                         f"rows of at most 36 bytes")
    first, last = start // 32, (start + row_bytes - 1) // 32
    touched = torch.unique(torch.cat([first, last])).numel() * 32
    ids_l = [i.long() for i in ids]
    uniq_l = [u.long() for u in uniq]
    times = {
        "embedding_lookup": _device_ms(_cycling(
            lambda i: el.embedding_lookup(table, i), ids), COLD_BATCHES),
        "index_select": _device_ms(_cycling(
            lambda i: torch.index_select(table, 0, i), ids_l), COLD_BATCHES),
        "embedding_scatter": _device_ms(_cycling(
            lambda u: el.embedding_scatter(table, u, upd), uniq),
            COLD_BATCHES),
        "index_copy_": _device_ms(_cycling(
            lambda u: table.index_copy_(0, u, upd), uniq_l), COLD_BATCHES)}
    print(f"copies at {v}x{d} f32, {n} ids, L2 cold ({COLD_BATCHES} id "
          f"batches in turn, their rows touching {touched / 1e6:.1f} MB of "
          f"32-byte sectors): "
          + ", ".join(f"{k} {ms:.5f} ms" for k, ms in times.items())
          + f"; bound {_bound_ms(n * 4 + 2 * n * row_bytes):.5f}",
          flush=True)


def hashed_ids(count: int) -> np.ndarray:
    """``count`` distinct 64-bit feature ids: the splitmix64 outputs for
    the states golden * 1, 2, 3, ... (a bijection of the 64-bit integers),
    without the hash map's EMPTY/TOMB sentinels — hashed ids as production
    sends them, so the maps' home slots collide."""
    x = np.arange(1, count + 3, dtype=np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    ids = x.view(np.int64)
    return ids[ids > -2 ** 63 + 1][:count]


def build_loop(cfg, plan, groups, backend: str, device):
    """One side of the online-learning loop: FTRL master shards with
    collectors, realtime gatherers and int8 pushers; 2 replicas of each
    slave shard with a scatter each; the serving plane over the replicas
    (every replica's ``on_apply`` wired to its invalidation hook); and,
    on the card's side (``backend="torch"``), the training plane over the
    masters. ``backend`` is both the PS and the codec backend."""
    from repro_torch.core import streaming
    from repro_torch.core.fault_tolerance import ReplicaSet
    from repro_torch.core.ps import MasterShard, SlaveShard
    from repro_torch.core.queue import PartitionedQueue
    from repro_torch.core.transform import make_transform
    from repro_torch.optim import get_optimizer
    from repro_torch.serving import ServingPlane
    from repro_torch.training import TrainingPlane

    opt = get_optimizer("ftrl", alpha=cfg.ftrl_alpha, beta=cfg.ftrl_beta,
                        l1=cfg.ftrl_l1, l2=cfg.ftrl_l2)
    queue = PartitionedQueue(plan.num_partitions)
    transform = make_transform("int8", opt, backend=backend, device=device)
    masters = [MasterShard(i, groups, opt, backend=backend, device=device)
               for i in range(plan.num_master)]
    cols = [streaming.Collector() for _ in masters]
    for m, c in zip(masters, cols):
        m.collector = c
    sets = [ReplicaSet([SlaveShard(sid, groups, backend=backend,
                                   device=device, codec_backend=backend)
                        for _ in range(2)])
            for sid in range(plan.num_slave)]
    scatters = []
    for rs in sets:
        for shard in rs.replicas:
            sc = streaming.Scatter(shard, queue, plan)
            rs.attach_scatter(shard, sc)
            scatters.append(sc)
    serving = ServingPlane(plan, sets, groups, ps_backend=backend,
                           device=device)
    serving.add_scenario(cfg)
    for rs in sets:
        for shard in rs.replicas:
            shard.on_apply = serving.on_applied
    training = None
    if backend == "torch":
        training = TrainingPlane(plan, masters, dict(groups), opt,
                                 device=device)
        training.add_scenario(cfg)
    return SimpleNamespace(
        masters=masters, collectors=cols, queue=queue, sets=sets,
        gatherers=[streaming.Gatherer("realtime") for _ in masters],
        pushers=[streaming.Pusher(m, queue, plan, transform)
                 for m in masters],
        scatters=scatters, serving=serving, training=training)


def sync_tick(loop, t_event: float, now=None) -> int:
    """collect → gather → push on every master (records stamped
    ``t_event``), then a poll on every replica; each poll's staleness
    clock reads ``now``, or the wall clock when it starts. Returns the
    records pushed."""
    n = 0
    for col, gat, push in zip(loop.collectors, loop.gatherers, loop.pushers):
        gat.offer(col.drain())
        if gat.ready(t_event):
            n += push.push(gat.flush(t_event), t_event)
    for sc in loop.scatters:
        sc.poll(now=time.perf_counter() if now is None else now)
    return n


def train_state(cfg, groups, ids: np.ndarray, seed: int) -> dict:
    """Seeded master rows for ``convert.load_train_state``: z ~ N(0, 1.5²)
    and n ~ U(0, 4), so |z| > l1 for many elements (an FM trained from
    all-zero rows never moves v), and w the FTRL weights of (z, n)."""
    from repro_torch.optim import FTRL
    opt = FTRL(alpha=cfg.ftrl_alpha, beta=cfg.ftrl_beta, l1=cfg.ftrl_l1,
               l2=cfg.ftrl_l2)
    rng = np.random.default_rng(seed + 1)
    state = {}
    for g, dim in groups.items():
        z = 1.5 * rng.standard_normal((len(ids), dim), dtype=np.float32)
        n = 4.0 * rng.random((len(ids), dim), dtype=np.float32)
        state[g] = (ids, opt._np_weights(z, n), {"z": z, "n": n})
    return state


def bootstrap(loop) -> int:
    """Stream every master row to the replicas: each master's collector
    records all its ids, then one sync tick. Returns the records pushed."""
    for m, col in zip(loop.masters, loop.collectors):
        for g, t in m.tables.items():
            col.record(g, t.all_ids())
    return sync_tick(loop, 0.0, now=0.0)


def record_pushes(masters, log: list) -> None:
    """Record every ``(master, group, ids, grads, step)`` push the masters
    receive, in order, so a host path can apply exactly the same ones."""
    for m in masters:
        def push(group, ids, grads, *, step=None, m=m, real=m.push_grad):
            log.append((m.shard_id, group, np.array(ids), np.array(grads),
                        step))
            real(group, ids, grads, step=step)
        m.push_grad = push


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


def check_preds(label: str, r: np.ndarray, p: np.ndarray,
                want: np.ndarray) -> float:
    """Predictions of request ``r``: finite, one per example, within 1e-5
    of the host path's ``want``. Returns the largest deviation."""
    if p.shape != (len(r),) or not np.isfinite(p).all():
        raise AssertionError(f"{label}: predictions not finite of shape "
                             f"({len(r)},)")
    dev = float(np.abs(p - want).max())
    if not np.allclose(p, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label}: predictions differ from the host "
                             f"path by {dev:.3g}")
    return dev


def serve_phase(plane, host, plan, groups, pool: np.ndarray, rng, device, *,
                batch: int, fields: int, warm_batches, warm_reps: int,
                partial_rounds: int) -> dict:
    """Serve FM_FTRL requests drawn from ``pool`` on the card's plane and
    check them against the host plane: rows bit-equal, predictions within
    1e-5, cache counters and replica pulls equal. The launch counters are
    reset before the predicts and read right after them. Returns the
    latencies and counters the report prints."""
    import torch

    from repro_torch.kernels import ops

    cold = pool[rng.integers(0, len(pool), size=(batch, fields))]
    requests = [(f"cold {batch}", cold)]
    for b in warm_batches:
        requests += [(f"warm {b}", cold[:b])] * warm_reps
    req = cold
    for _ in range(partial_rounds):
        req = req.copy()
        fresh = rng.random(req.shape) < 0.1
        req[fresh] = pool[rng.integers(0, len(pool),
                                       size=int(fresh.sum()))]
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
    max_dev = max(check_preds(label, r, p, host.predict(r))
                  for (label, r), p in zip(requests, preds))
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
        probe_inputs[PROBE_OF[t._dev.placement]] = (
            t._dev.keys, torch.from_numpy(q).to(device), t._dev.shift,
            t._map, what)
    return {"launches": launches, "placements": placements,
            "latency_ms": lat, "launches_per_predict": per_request,
            "profiles": profiles, "max_pred_dev": max_dev, "cold": cold,
            "mirror_bytes": mirror_bytes,
            "cache": cache_stats, "cache_mirror": cache_mirror,
            "shard_pulled_rows": plane.shard_pulled_rows,
            "device_blocks": device_blocks, "requests": len(requests),
            "probe_inputs": probe_inputs}


def click_labels(ids: np.ndarray, rng) -> np.ndarray:
    """Clicks with a learnable signal: each feature id's low bit moves
    its example's logit by ±0.15."""
    logit = ((ids & 1) * 0.3 - 0.15).sum(axis=1)
    return (rng.random(len(ids)) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.float32)


def train_phase(card, pool: np.ndarray, rng, device, *, steps: int,
                batch: int, fields: int, requests: list) -> dict:
    """``steps`` train steps on the card, each followed by a sync tick,
    then ``requests`` predicted; the launch counters are reset before and
    read right after. Records every push the masters receive."""
    import torch

    from repro_torch.kernels import ops
    scn = card.training.scenario()
    log: list = []
    record_pushes(card.masters, log)
    pushed = [(p.pushed_bytes, p.pushed_records) for p in card.pushers]
    train_ms, tick_ms, t_events, metrics = [], [], [], []
    for sc in card.scatters:
        sc.staleness.reset()                    # drop the bootstrap's
    ops.reset_launches()
    for i in range(steps):
        ids = pool[rng.integers(0, len(pool), size=(batch, fields))]
        y = click_labels(ids, rng)

        def step():
            t0 = time.perf_counter()
            m = card.training.train_batch(scn, ids, y, now=float(scn.step))
            t_event = time.perf_counter()
            sync_tick(card, t_event)
            return m, t0, t_event, time.perf_counter()

        if i < steps - 1:
            m, t0, t_event, t_end = step()
            train_ms.append((t_event - t0) * 1e3)
            tick_ms.append((t_end - t_event) * 1e3)
        else:           # the last step profiled, its times kept apart
            staleness = _staleness(card.scatters)
            (m, t0, t_event, t_end), prof = profile_step(step, device)
            prof["train_ms"] = (t_event - t0) * 1e3
            prof["tick_ms"] = (t_end - t_event) * 1e3
        metrics.append(m)
        t_events.append(t_event)
    lat: dict[str, list] = {}
    preds = []
    for label, r in requests:
        t = time.perf_counter()
        preds.append(card.serving.predict(r))
        lat.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    return {"launches": launches, "log": log, "t_events": t_events,
            "train_ms": train_ms, "tick_ms": tick_ms, "metrics": metrics,
            "predict_ms": lat, "preds": preds, "last_batch": (ids, y),
            "pushed_bytes": sum(p.pushed_bytes for p in card.pushers)
            - sum(b for b, _ in pushed),
            "pushed_records": sum(p.pushed_records for p in card.pushers)
            - sum(r for _, r in pushed),
            "staleness_ms": {k: v * 1e3 for k, v in staleness.items()},
            "profile": prof,
            "dedup_ratio": scn.stats.dedup_ratio,
            "gather_dedup": float(np.mean([g.stats.dedup_ratio
                                           for g in card.gatherers]))}


def profile_step(step, device):
    """``step()`` under cProfile (host time by function) and, on the card,
    ``torch.profiler`` (device-busy time: the CUDA kernels' and copies'
    own time). Returns ``(step(), profile)``; the profilers slow the step,
    so its times are reported apart from the latencies."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    pr = cProfile.Profile()
    with profile(activities=acts) as tprof:
        t = time.perf_counter()
        pr.enable()
        out = step()
        pr.disable()
        wall = time.perf_counter() - t
    own = sorted(((f"{Path(f).name}:{fn}" if f != "~" else fn, v[2])
                  for (f, _line, fn), v in pstats.Stats(pr).stats.items()),
                 key=lambda kv: -kv[1])
    busy = sum(e.self_device_time_total for e in tprof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, {"wall_ms": wall * 1e3,
                 "busy_ms": busy / 1e3 if busy else None,
                 "top": [(k[:70], tt * 1e3) for k, tt in own[:12]]}


def _staleness(scatters) -> dict:
    from repro_torch.core.monitor import PercentileRing
    return PercentileRing.merged_percentiles(
        [sc.staleness for sc in scatters], (50, 99))


def replay(host, log: list, t_events: list) -> None:
    """Apply the card's recorded pushes, step by step, to the host path's
    masters, each step followed by a sync tick stamped like the card's."""
    for step, t in enumerate(t_events):
        for mid, group, ids, grads, st in log:
            if st == step:
                host.masters[mid].push_grad(group, ids, grads, step=st)
        sync_tick(host, t, now=t)


def _same(a: np.ndarray, b: np.ndarray, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or \
            a.tobytes() != b.tobytes():
        raise AssertionError(f"{what}: the card and the host path differ")


def compare_loops(card, host, groups, requests, preds) -> dict:
    """The card's loop against the host path's after the same pushes:
    master rows, queue records, replica rows and served rows bit-equal,
    predictions within 1e-5."""
    n_rows = 0
    for m, hm in zip(card.masters, host.masters):
        for g in groups:
            ids = np.sort(hm.tables[g].all_ids())
            if len(m.tables[g]) != len(ids):
                raise AssertionError(f"master {m.shard_id} {g}: row counts")
            (w, s), (hw, hs) = m.tables[g].gather(ids), hm.tables[g].gather(ids)
            for k, a, b in (("w", w, hw), ("z", s["z"], hs["z"]),
                            ("n", s["n"], hs["n"])):
                _same(a, b, f"master {m.shard_id} {g} {k}")
            n_rows += len(ids)
    n_rec = compare_queues(card.queue, host.queue)
    for rs, hrs in zip(card.sets, host.sets):
        for rep, hrep in zip(rs.replicas, hrs.replicas):
            for g in groups:
                a, b = rep.tables[g].snapshot(), hrep.tables[g].snapshot()
                oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
                _same(a["ids"][oa], b["ids"][ob], f"replica {g} ids")
                _same(a["w"][oa], b["w"][ob], f"replica {g} rows")
    max_dev = 0.0
    for (label, r), p in zip(requests, preds):
        max_dev = max(max_dev, check_preds(label, r, p,
                                           host.serving.predict(r)))
        got, want_rows = card.serving.serve_rows(r), host.serving.serve_rows(r)
        for g in groups:
            _same(got[g], want_rows[g], f"{label}: served {g} rows")
    return {"master_rows": n_rows, "records": n_rec,
            "max_pred_dev": max_dev}


def check_loss_grads(card, cfg, ids: np.ndarray, y: np.ndarray) -> float:
    """The card's loss and row gradients for one batch against the same
    computation in torch on the CPU, within rtol 1e-5, atol 1e-6. Returns
    the largest absolute deviation."""
    import torch

    from repro_torch.models.ctr import weighted_loss_and_grads_fn
    from repro_torch.serving.router import RowRouter
    tp = card.training
    scn = tp.scenario()
    uniq, inverse = RowRouter.unique(ids)
    rows = RowRouter.expand(tp.pull_unique(scn, uniq), inverse, ids.shape)
    w = np.ones(len(y), np.float32)
    on = {}
    for dev in (tp.device, torch.device("cpu")):
        fn = scn.loss_grads if dev == tp.device else \
            weighted_loss_and_grads_fn(cfg)
        loss, grads, _ = fn({k: torch.from_numpy(v).to(dev)
                             for k, v in rows.items()}, {},
                            torch.from_numpy(y).to(dev),
                            torch.from_numpy(w).to(dev))
        on[dev.type] = [loss.cpu().numpy()] + [grads[g].cpu().numpy()
                                               for g in sorted(grads)]
    dev = 0.0
    for a, b in zip(on[tp.device.type], on["cpu"]):
        if not np.allclose(a, b, rtol=1e-5, atol=1e-6):
            raise AssertionError("loss or row grads differ from the CPU's")
        dev = max(dev, float(np.abs(a - b).max()))
    return dev


def train_kernel_inputs(card, log: list, t_last: float, device) -> dict:
    """The new kernels' inputs as the loop's last step gave them: the
    largest group-"v" push to one master (its ids' (z, n) rows as they
    stand after the step, and its gradients; its ids against that
    master's key mirror, as the fused FTRL push probes them), the largest
    group-"v" and group-"w" pushes of the step against their masters'
    mirrors (keys, value table, arenas; the fused pass's inputs), the
    serve values that master's pusher encoded from those rows, and the
    largest group-"v" record of the last tick."""
    import torch
    last = max(e[4] for e in log)
    mid, _g, ids, grads, _ = max(
        (e for e in log if e[4] == last and e[1] == "v"),
        key=lambda e: len(e[2]))
    _, slots = card.masters[mid].tables["v"].gather(ids)
    serve = card.pushers[mid].transform.serve_values(
        np.empty((len(ids), 0), np.float32), slots)
    rec = max((r for p in range(card.queue.num_partitions)
               for r in card.queue.consume(p, 0)[0]
               if r.group == "v" and r.meta["t"] == t_last),
              key=lambda r: len(r.ids))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    table = card.masters[mid].tables["v"]
    pushes = []
    for group in ("v", "w"):
        pmid, _g, pids, pgrads, _ = max(
            (e for e in log if e[4] == last and e[1] == group),
            key=lambda e: len(e[2]))
        mir = card.masters[pmid].tables[group]._dev
        pushes.append(SimpleNamespace(
            what=f"master {pmid}, its largest group-{group} push of the "
                 f"last step", keys=mir.keys, slot_of=mir.slot_of,
            shift=mir.shift, placement=mir.placement,
            arenas=tuple(mir.arenas[k] for k in ("z", "n", "w")),
            ids=up(pids), grads=up(pgrads)))
    return {"ftrl": (up(slots["z"]), up(slots["n"]), up(grads)),
            "pushes": pushes,
            "serve": up(serve),
            "record": (up(rec.payload["q"]), up(rec.payload["scale"])),
            "probe": (PROBE_OF[table._dev.placement],
                      (table._dev.keys, up(ids), table._dev.shift,
                       table._map, f"master {mid}, its largest group-v "
                                   f"push of the last step"))}


CODEC_SPECIAL = 5                   # rows of codec_rows that are not finite


def codec_rows(b: int, d: int, seed) -> np.ndarray:
    """(b, d) float32 codec rows from ``seed``, magnitudes spread over
    1e-4..1e4 a row, the first ``CODEC_SPECIAL`` of them (as far as ``b``
    goes) special: all zeros, one NaN, one +Inf, one -Inf, and NaN with
    both infinities. The reference gives scale 1e-12, NaN, inf, inf and
    NaN, and codes 0, for these."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, d))
         * 10.0 ** rng.uniform(-4, 4, size=(b, 1))).astype(np.float32)
    special = [(0, slice(None), 0.0), (1, d // 2, np.nan),
               (2, d - 1, np.inf), (3, 0, -np.inf), (4, d // 3, np.inf),
               (4, d - 1, -np.inf), (4, 0, np.nan)]
    for row, col, v in special:
        if row < b:
            x[row, col] = v
    return x


def codec_same(a, b) -> bool:
    """Bit-equal tensors, NaNs in the same places standing for equal (the
    card's arithmetic returns a canonical NaN, the host's keeps the
    input's payload)."""
    import torch
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0), b.masked_fill(nan, 0)))


# FP32 opcodes of the SASS count (the rest are integer, memory, control)
FP32_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def max_sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi``'s ``clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def ftrl_issue() -> dict:
    """Instructions an element of the FTRL kernels issues (a thread a
    float), read from ``cuobjdump -sass`` of the built library: ``{slots:
    {"mufu", "fp32", "all", "clocks"}}`` for the kernel that reads rows
    through the slots (``ftrl_apply_slots``, float32 w arena) or not
    (``ftrl_row_update``). Counted over the kernel's main body, from its
    first instruction to its first branch to itself; the subroutines
    after that are the slow paths of the IEEE divide and square root,
    taken only for operands the fast path cannot take (denormal, Inf,
    NaN, huge quotients). ``clocks``: SM clocks an element takes at the
    H100's rates, the larger of its MUFU instructions over 16 a clock and
    its MUFU and FP32 instructions over the 128 a clock an SM issues."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(_build.library_path("ftrl_row_update"))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"ftrl_kernelILb([01])EfEEv", part.split("\n", 1)[0])
        if not m:
            continue
        ops = []
        for addr, op, args in _SASS_LINE.findall(part):
            if op == "BRA" and args.strip() == f"0x{int(addr, 16):x}":
                break
            if op != "NOP":
                ops.append(op)
        mufu = sum(op.startswith("MUFU") for op in ops)
        fp32 = sum(op.split(".")[0] in FP32_OPS for op in ops)
        out[m.group(1) == "1"] = {
            "mufu": mufu, "fp32": fp32, "all": len(ops),
            "clocks": max(mufu / MUFU_PER_CLOCK,
                          (mufu + fp32) / ISSUE_PER_CLOCK)}
    if len(out) != 2:
        raise AssertionError(f"FTRL kernels found in the SASS: {sorted(out)}")
    return out


def _sectors(start, nbytes: int) -> int:
    """Distinct 32-byte sectors that ``nbytes`` from each byte offset of
    ``start`` (a tensor) cover."""
    import torch
    first, last = start // 32, (start + nbytes - 1) // 32
    cells = [torch.where(first + j <= last, first + j, first)
             for j in range(int((last - first).max()) + 1)]
    return int(torch.cat(cells).unique().numel())


def apply_bytes(push, pos, found) -> int:
    """The bytes ``ftrl_apply_slots`` must move on ``push``: 16 an
    element (g read; z', n', w' row outputs written), the rows' pos and
    found, the 32-byte sectors of ``slot_of`` the rows read, and the
    sectors of the arenas they touch: z and n read and written, w
    written."""
    import torch
    b, d = push.grads.shape
    slot = torch.where(found, push.slot_of[pos.long()], 0).long()
    zn = _sectors(slot * d * 4, d * 4)
    esize = push.arenas[2].element_size()
    w = _sectors(slot * d * esize, d * esize)
    return (16 * b * d + 5 * b + 32 * _sectors(pos.long() * 4, 4)
            + 32 * (4 * zn + w))


def apply_row(push, ftrl_kw: dict, issue: dict, clock_hz: float) -> dict:
    """``ftrl_apply_slots`` on one of the path's own pushes: its probe's
    results, then the pass on a copy of the master's arenas against its
    plain version on another copy (arenas and row outputs bit-equal),
    then timed beside its bound and the chain it replaces (the torch slot
    translate, two gathers, ``ftrl_row_update``, three scatter-sets, this
    tree's kernels). One push through ``ops.fused_ftrl_apply`` is timed,
    captured in a CUDA graph and profiled: exactly two kernels, the probe
    and the pass (the graph's nodes and the launch counters must show the
    two; the profile, which may miss kernels launched through ctypes late
    in the process, must show no other)."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ftrl_row_update as fr
    from repro_torch.kernels import ops, ref
    kw = dict(shift=push.shift, placement=push.placement)
    pos, found = ops.hashmap_probe(push.keys, push.ids, **kw)
    if not bool(found.all()):
        raise AssertionError(f"ftrl_apply_slots at {push.what}: ids absent "
                             f"from the map")
    mine = [a.clone() for a in push.arenas]
    plain = [a.clone() for a in push.arenas]
    args = (pos, found, push.slot_of)
    got = fr.ftrl_apply_slots(*args, *mine, push.grads, **ftrl_kw)
    want = ref.ftrl_apply_slots(*args, *plain, push.grads, **ftrl_kw)
    if not all(torch.equal(a, w) for a, w in zip([*got, *mine],
                                                 [*want, *plain])):
        raise AssertionError(f"ftrl_apply_slots at {push.what}: not "
                             f"bit-equal (arenas or row outputs)")
    b, d = push.grads.shape
    per = issue[True]
    row = _row("ftrl_apply_slots", "ftrl_row_update.cu",
               "src/repro/kernels/ftrl_row_update.py:38", 0.0,
               lambda: fr.ftrl_apply_slots(*args, *mine, push.grads,
                                           **ftrl_kw),
               lambda: ref.ftrl_apply_slots(*args, *plain, push.grads,
                                            **ftrl_kw), None,
               apply_bytes(push, pos, found),
               f"{push.what}: {b}x{d} f32 rows through a "
               f"{push.slot_of.shape[0]}-slot map into "
               f"{tuple(mine[0].shape)} arenas",
               flops=b * d * per["clocks"], peak=SMS * clock_hz,
               agreement="arenas and row outputs bit-equal to its plain "
                         "version")
    row.update(shape=f"{b}x{d}",
               sass_per_element={k: per[k] for k in ("mufu", "fp32", "all")})

    def chain():
        slot = torch.where(found, push.slot_of[pos], torch.zeros_like(pos))
        z2, n2, w2 = fr.ftrl_row_update(el.embedding_lookup(mine[0], slot),
                                        el.embedding_lookup(mine[1], slot),
                                        push.grads, **ftrl_kw)
        for a, v in zip(mine, (z2, n2, w2)):
            el.embedding_scatter(a, slot, v)

    push_call = lambda: ops.fused_ftrl_apply(  # noqa: E731
        push.keys, push.slot_of, *mine, push.ids, push.grads, **kw,
        **ftrl_kw)
    row["chain_ms"] = _device_ms(chain)
    row["push_ms"] = _device_ms(push_call)
    # the push launches the probe and the pass, and nothing else: the
    # counters, the captured graph's nodes and the profiler must agree
    before = ops.launch_counts()
    kinds, graph_names = graph_kernels(push_call)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v != before[k]}
    probe = PROBE_OF[push.placement]
    prof = profile_call(push_call, push.grads.device)
    names = [k for k, _ in prof["entries"]]
    ours = lambda k: "probe" in k or "ftrl_kernel" in k
    two = lambda ks: (len(ks) == 2 and any("probe" in k for k in ks)
                      and any("ftrl_kernel" in k for k in ks))
    # the profiler may miss ctypes-launched kernels late in a process (it
    # listed none, then one of the two): it must list no kernel of another
    if (kinds != {0: 2} or launched != {probe: 1, "ftrl_row_update": 1}
            or (graph_names and not two(graph_names))
            or not all(map(ours, names))):
        raise AssertionError(
            f"ops.fused_ftrl_apply at {push.what}: not the probe and "
            f"ftrl_apply_slots alone: graph nodes by type {kinds} "
            f"{graph_names}, counted launches {launched}, profiled {names}")
    seen = (f"{len(names)} of the 2 kernels listed by torch.profiler"
            + "".join(f", {k[:60]} {ms:.5f}" for k, ms in prof["entries"]))
    print(f"  the push after its probe: {row['ms']:.5f} ms, the chain it "
          f"replaces {row['chain_ms']:.5f} ms; the whole push (probe + "
          f"pass) {row['push_ms']:.5f} ms; SASS per element "
          f"{row['sass_per_element']}; one push captured: {kinds[0]} "
          f"kernel nodes and nothing else "
          f"({', '.join(n[:50] for n in graph_names) or 'names not read'}), "
          f"counted {launched}; profiled: {seen}", flush=True)
    return row


def graph_kernels(fn) -> tuple[dict, list[str]]:
    """What one ``fn()`` launches on the card, whatever the profiler
    sees: it is captured into a CUDA graph, whose nodes libcuda lists
    (``cuGraphGetNodes``). Returns ``({node type: count}, kernel
    names)``; type 0 is a kernel, and a kernel's name comes from
    ``cuFuncGetName`` where libcuda has it (else the list is empty)."""
    import ctypes

    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t()
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds, names = {}, []
    params = (ctypes.c_void_p * 16)()    # CUDA_KERNEL_NODE_PARAMS: func first
    name = ctypes.c_char_p()
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[kind.value] = kinds.get(kind.value, 0) + 1
        if (kind.value == 0 and hasattr(cu, "cuFuncGetName")
                and not cu.cuGraphKernelNodeGetParams(ctypes.c_void_p(node),
                                                      params)
                and params[0] and not cu.cuFuncGetName(
                    ctypes.byref(name), ctypes.c_void_p(params[0]))):
            names.append(name.value.decode())
    graph.reset()
    return kinds, names


def train_kernel_rows(inputs: dict, ftrl_kw: dict) -> list[dict]:
    """Each new kernel against its plain version on the path's inputs,
    bit-equal, then timed beside its bound. The FTRL rows' bound is the
    larger of their bytes and their instruction issue (``ftrl_issue``);
    ``ftrl_apply_slots``' rows, one for each of the path's pushes, ride
    on the ``ftrl_row_update`` entry (one kernel source, one count)."""
    import torch

    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ftrl_row_update as fr
    from repro_torch.kernels import ref
    rows = []
    clock_hz = max_sm_clock_hz()
    issue = ftrl_issue()
    print(f"FTRL kernels' SASS per element (MUFU, FP32, all; SM clocks at "
          f"{clock_hz / 1e6:.0f} MHz): "
          + ", ".join(f"{name} {v['mufu']}, {v['fp32']}, {v['all']}; "
                      f"{v['clocks']:.4f}" for name, v in
                      (("ftrl_row_update", issue[False]),
                       ("ftrl_apply_slots", issue[True]))), flush=True)
    z, n, g = inputs["ftrl"]
    got, want = fr.ftrl_row_update(z, n, g, **ftrl_kw), \
        ref.ftrl_row_update(z, n, g, **ftrl_kw)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("ftrl_row_update: not bit-equal")
    b, d = z.shape
    rows.append(_row("ftrl_row_update", "ftrl_row_update.cu",
                     "src/repro/kernels/ftrl_row_update.py:38", 0.0,
                     lambda: fr.ftrl_row_update(z, n, g, **ftrl_kw),
                     lambda: ref.ftrl_row_update(z, n, g, **ftrl_kw), None,
                     24 * b * d, f"{b}x{d} f32 rows, one master's push",
                     flops=b * d * issue[False]["clocks"],
                     peak=SMS * clock_hz))
    rows[-1]["apply_slots"] = [apply_row(p, ftrl_kw, issue, clock_hz)
                               for p in inputs["pushes"]]
    x = inputs["serve"]
    (q, s), (pq, ps) = dc.quantize_rows(x), ref.quantize_rows(x)
    if not (torch.equal(q, pq) and torch.equal(s, ps)):
        raise AssertionError("quantize_rows: not bit-equal")
    b, d = x.shape
    rows.append(_row("quantize_rows", "delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:36", 0.0,
                     lambda: dc.quantize_rows(x),
                     lambda: ref.quantize_rows(x), None,
                     5 * b * d + 4 * b, f"{b}x{d} f32, one master's flush"))
    q, s = inputs["record"]
    out, want = dc.dequantize_rows(q, s), ref.dequantize_rows(q, s)
    if not torch.equal(out, want):
        raise AssertionError("dequantize_rows: not bit-equal")
    b, d = q.shape
    rows.append(_row("dequantize_rows", "delta_codec.cu",
                     "src/repro/kernels/delta_codec.py:58", 0.0,
                     lambda: dc.dequantize_rows(q, s),
                     lambda: ref.dequantize_rows(q, s),
                     lambda: torch.mul(q, s),
                     5 * b * d + 4 * b, f"{b}x{d} int8, one record"))
    return rows


# (rows, width, what) of the codec's timed shapes beyond the path's own:
# the bootstrap's encode of a master and one of its records, a wide
# block of rows, and one dense leaf of qwen2-1.5b (an MLP stack, 28 x
# 1536 x 8960 floats) as ModelSyncEngine encodes it, ONE row
CODEC_SHAPES = ((1 << 20, 8, "quantize", "the bootstrap's encode of a "
                 "master"),
                (65_536, 8, "dequantize", "one bootstrap record"),
                (65_536, 1536, "both", "a block of wide rows"),
                (1, 28 * 1536 * 8960, "both", "a qwen2-1.5b MLP leaf"))
# widths of the NaN / Inf rows' check: every regime of codec_plan
CODEC_SPECIAL_WIDTHS = (1, 8, 9, 1536, 16384, 100_003)


def codec_shape_lines(device) -> None:
    """The codec kernels at ``CODEC_SHAPES``, each bit-equal to its plain
    version first, then timed beside its bound (a split row's quantize
    also beside the bound of reading it twice), its plain version and,
    for dequantize, ``torch.mul``."""
    import torch

    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    for b, d, which, what in CODEC_SHAPES:
        x = torch.randn(b, d, generator=gen, device=device) * 10.0 ** (
            torch.rand(b, 1, generator=gen, device=device) * 8 - 4)
        (q, s), (pq, ps) = dc.quantize_rows(x), ref.quantize_rows(x)
        if not (torch.equal(q, pq) and torch.equal(s, ps)):
            raise AssertionError(f"quantize_rows at {b}x{d}: not bit-equal")
        del pq, ps
        plan = dc.codec_plan(d, x.data_ptr(), q.data_ptr())
        shape = f"{b}x{d}, {what} ({plan.regime}, {plan.word}-byte words)"
        if which in ("quantize", "both"):
            _row("quantize_rows", "delta_codec.cu",
                 "src/repro/kernels/delta_codec.py:36", 0.0,
                 lambda: dc.quantize_rows(x), lambda: ref.quantize_rows(x),
                 None, 5 * b * d + 4 * b, shape)
            if plan.regime == "split":
                print(f"  (read twice, as a split row is: bound "
                      f"{_bound_ms(9 * b * d + 4 * b):.5f} ms)")
        if which in ("dequantize", "both"):
            out = dc.dequantize_rows(q, s)
            if not torch.equal(out, ref.dequantize_rows(q, s)):
                raise AssertionError(f"dequantize_rows at {b}x{d}: not "
                                     f"bit-equal")
            del out
            _row("dequantize_rows", "delta_codec.cu",
                 "src/repro/kernels/delta_codec.py:58", 0.0,
                 lambda: dc.dequantize_rows(q, s),
                 lambda: ref.dequantize_rows(q, s), lambda: torch.mul(q, s),
                 5 * b * d + 4 * b, shape)
        del x, q, s
        torch.cuda.empty_cache()


def check_codec_special(device) -> None:
    """Rows holding NaN, +Inf, -Inf and zeros (``codec_rows``) at every
    regime's width: the kernels give the CPU's plain version's codes and
    scales (the reference's answer); whether the card's plain version
    agrees with the CPU's is printed, not held."""
    import torch

    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ref
    plain_agrees = []
    for d in CODEC_SPECIAL_WIDTHS:
        x = torch.from_numpy(codec_rows(64, d, d)).to(device)
        q, s = dc.quantize_rows(x)
        cq, cs = ref.quantize_rows(x.cpu())
        out = dc.dequantize_rows(q, s)
        if not (torch.equal(q.cpu(), cq) and codec_same(s.cpu(), cs)
                and codec_same(out.cpu(), ref.dequantize_rows(cq, cs))):
            raise AssertionError(f"codec on NaN / Inf rows at D = {d}: not "
                                 f"the CPU's plain version's answer")
        pq, ps = ref.quantize_rows(x)
        plain_agrees.append(bool(torch.equal(pq.cpu(), cq)
                                 and codec_same(ps.cpu(), cs)))
    print(f"codec on rows of zeros, NaN, +Inf, -Inf at D = "
          f"{', '.join(map(str, CODEC_SPECIAL_WIDTHS))}: kernels equal to "
          f"the CPU's plain version (scales 1e-12, nan, inf, inf, nan; codes "
          f"0); the card's plain version agrees with the CPU's: "
          f"{plain_agrees}", flush=True)


def drive_loop(device, *, feature_space: int, batch: int, fields: int,
               warm_batches, warm_reps: int, partial_rounds: int,
               train_steps: int, seed: int = SEED) -> dict:
    """Run the online-learning loop for FM_FTRL (``fields`` wide,
    ``feature_space`` hashed ids) on the card's side (``torch`` backends
    on ``device``) and on the host path (``numpy`` backends), phases 2-4
    of the module docstring. Returns the numbers the report prints and
    the inputs the probes and the new kernels are timed on."""
    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.convert import load_train_state
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.kernels import ops
    from repro_torch.models.ctr import groups_for

    cfg = dataclasses.replace(FM_FTRL, fields=fields,
                              feature_space=feature_space)
    groups = groups_for(cfg)
    plan = RoutingPlan(num_master=4, num_slave=2, num_partitions=8)
    rng = np.random.default_rng(seed)
    pool = hashed_ids(feature_space)
    t0 = time.perf_counter()
    card = build_loop(cfg, plan, groups, "torch", device)
    host = build_loop(cfg, plan, groups, "numpy", "cpu")
    state = train_state(cfg, groups, pool, seed)
    for side in (card, host):
        load_train_state(side.masters, plan, state)
    del state
    load_s = time.perf_counter() - t0

    ops.reset_launches()
    t0 = time.perf_counter()
    boot_records = bootstrap(card)
    boot_s = time.perf_counter() - t0
    boot_launches = ops.launch_counts()
    t0 = time.perf_counter()
    bootstrap(host)
    host_boot_s = time.perf_counter() - t0

    serve = serve_phase(card.serving, host.serving, plan, groups, pool, rng,
                        device, batch=batch, fields=fields,
                        warm_batches=warm_batches, warm_reps=warm_reps,
                        partial_rounds=partial_rounds)
    cold = serve.pop("cold")
    # the first read after training re-pulls the invalidated rows, the
    # next one syncs the cache mirror, the third is warm
    requests = [(f"post-update {batch}", cold), (f"post-fill {batch}", cold),
                (f"warm {batch}", cold)]
    train = train_phase(card, pool, rng, device, steps=train_steps,
                        batch=batch, fields=fields, requests=requests)
    t0 = time.perf_counter()
    replay(host, train["log"], train["t_events"])
    host_train_s = time.perf_counter() - t0
    compared = compare_loops(card, host, groups, requests, train["preds"])
    loss_dev = check_loss_grads(card, cfg, *train["last_batch"])
    inputs = train_kernel_inputs(card, train["log"], train["t_events"][-1],
                                 device)
    return {"serve": serve, "train": train, "compared": compared,
            "loss_dev": loss_dev, "train_inputs": inputs,
            "ftrl_kw": {"alpha": cfg.ftrl_alpha, "beta": cfg.ftrl_beta,
                        "l1": cfg.ftrl_l1, "l2": cfg.ftrl_l2},
            "boot": {"records": boot_records, "s": boot_s,
                     "host_s": host_boot_s, "launches": boot_launches,
                     "bytes": card.queue.produced_bytes
                     - train["pushed_bytes"]},
            "load_s": load_s, "host_train_s": host_train_s}


# ---------------------------------------------------------------------------
# The cluster: WeiPSCluster end to end (ingest → train → sync → checkpoints
# → faults → domino downgrade) beside a host twin that replays its pushes
# ---------------------------------------------------------------------------

CLUSTER_EVENTS, CLUSTER_TICKS, CLUSTER_DT = 4096, 48, 0.2
CLUSTER_CORRUPT_TICKS = 40
CLUSTER_WARM_REPS = 8
# kernels the cluster path must launch (the hbm probe only where a map
# passes VMEM_SLOT_BOUND slots; the phase prints the placements taken)
CLUSTER_KERNELS = ("hashmap_probe", "embedding_lookup", "embedding_scatter",
                   "ftrl_row_update", "quantize_rows", "dequantize_rows")
CLUSTER_DIR = ROOT / "build" / "cluster_smoke"     # queues and remote tiers
# FTRL as the repo's serving-plane tests set it: with FM_FTRL's l1 = 1
# every weight stays 0 over the run and the logloss cannot move
CLUSTER_FTRL = dict(ftrl_l1=0.01, ftrl_alpha=0.2)
# the domino trigger: the reference tests' logloss threshold over the
# default 10-batch window, read once 15 batches are in (the first FTRL
# steps from zero rows overshoot to ~0.8, which a 5-batch warm-up takes
# for a collapse)
DOWNGRADE_THRESHOLD, DOWNGRADE_MIN_POINTS = 0.72, 15
PIPELINE_METRICS = tuple(
    f"training.scenarios.<scenario>.pipeline.{k}" for k in (
        "buffered", "pending_feedback", "throttled_ticks", "shed_examples",
        "joiner.emitted", "joiner.in_flight", "joiner.late_feedback",
        "joiner.fast_emits", "joiner.negatives_dropped",
        "joiner.join_delay.p50", "joiner.join_delay.p99"))


def metric_snapshot() -> list:
    """The frozen metric names (``SNAPSHOT`` of
    ``tests/test_metrics_schema.py``)."""
    text = (ROOT / "tests" / "test_metrics_schema.py").read_text()
    return re.search(r'SNAPSHOT = """(.*?)"""', text, re.S).group(1).split()


def canonical_metrics(cl) -> set:
    """The cluster's metric names with scenario segments canonicalized."""
    scenarios = {s.name for s in cl.serving.registry} | \
        {s.name for s in cl.training.registry}
    return {".".join("<scenario>" if s in scenarios else s
                     for s in name.split("."))
            for name in cl.metrics_registry.names(1.0)}


def cluster_config(backend: str, device, root: Path):
    from repro_torch.core import ClusterConfig
    return ClusterConfig(
        num_master=4, num_slave=2, num_replicas=2, num_partitions=8,
        codec="int8", ps_backend=backend, codec_backend=backend,
        device=str(device), queue_dir=str(root / "queue"),
        ckpt_root=str(root / "ckpt"), ckpt_incremental=True,
        ckpt_compress="int8", local_ckpt_interval=1.0,
        remote_ckpt_interval=4.0, join_window=3.0,
        downgrade_threshold=DOWNGRADE_THRESHOLD)


def _sorted_rows(rows: dict) -> dict:
    """Columnar rows (a table snapshot or a chain's rows) by id, slots
    flattened beside w."""
    o = np.argsort(rows["ids"], kind="stable")
    return {"ids": rows["ids"][o], "w": rows["w"][o],
            **{k: v[o] for k, v in rows["slots"].items()},
            "last_touch": rows["last_touch"][o],
            "touch_count": rows["touch_count"][o]}


def _same_tree(a, b, what: str) -> None:
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"{what}: keys differ")
        for k in a:
            _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        _same(a, b, what)
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def _roundtrip(a: np.ndarray) -> np.ndarray:
    """The NumPy int8 codec's round trip of rows (the reference's)."""
    from repro_torch.core.transform import Int8Transform
    return Int8Transform.decode(Int8Transform._quantize_np(a),
                                backend="numpy")


def check_chain(card, host, version: int) -> int:
    """Taken with no training after it, checkpoint ``version``'s chain is
    the live masters: ids, touch stats, and the NumPy codec's round trip
    of (w, z, n), bit-equal; the card's materialized chain (decoded by
    ``dequantize_rows``) equals the host's (NumPy). Returns the rows."""
    state = card.cold_backup.materialize(version)
    _same_tree(state["shard_snaps"],
               host.cold_backup.materialize(version)["shard_snaps"],
               f"v{version} chain, card vs host")
    n = 0
    for m in card.masters:
        for g, t in m.tables.items():
            live = _sorted_rows(t.snapshot())
            rows = _sorted_rows(state["shard_snaps"][m.shard_id]["tables"][g])
            for k, v in live.items():
                want = _roundtrip(v) if k in ("w", "z", "n") else v
                _same(rows[k], want, f"v{version} master {m.shard_id} {g} "
                                     f"{k} against the live rows")
            n += len(live["ids"])
    return n


def check_recovered(card, shard_id: int, version: int) -> None:
    """A recovered master holds its shard's chain rows, bit-equal."""
    state = card.cold_backup.materialize(version)
    m = card.masters[shard_id]
    for g, t in m.tables.items():
        live = _sorted_rows(t.snapshot())
        rows = _sorted_rows(state["shard_snaps"][shard_id]["tables"][g])
        for k in live:
            _same(live[k], rows[k], f"recovered master {shard_id} {g} {k}")
        if t.device is None or t.device.type != card.device.type:
            raise AssertionError("a recovered table is off the device")


def expected_replica(host, shard_id: int) -> dict:
    """What a replica bootstrapped from the latest checkpoint and caught
    up from its queue offsets holds, from the host twin alone: the
    chain's serve rows for the shard, overlaid (last record wins) with
    every record after the checkpoint's offsets, decoded by the NumPy
    codec. Returns ``{group: (sorted ids, rows, ids streamed after)}``."""
    from repro_torch.core.transform import decode_record
    state = host._serve_state()
    parts = {}
    for g, (ids, serve) in state["groups"].items():
        mine = host.plan.slave_shard(ids) == shard_id
        parts[g] = ([ids[mine]], [serve[mine]])
    after: dict = {}
    for p in host.plan.partitions_for_slave(shard_id):
        recs, _ = host.queue.consume(p, state["queue_offsets"].get(p, 0))
        for r in recs:
            if r.group.startswith("dense/") or r.op != "upsert":
                raise AssertionError(f"unexpected record {r.group} {r.op}")
            keep = host.plan.slave_shard(r.ids) == shard_id
            vals = decode_record(r, backend="numpy")
            parts[r.group][0].append(r.ids[keep])
            parts[r.group][1].append(vals[keep])
            after.setdefault(r.group, []).append(r.ids[keep])
    out = {}
    for g, (ids_l, val_l) in parts.items():
        ids, vals = np.concatenate(ids_l), np.concatenate(val_l)
        uniq, last_rev = np.unique(ids[::-1], return_index=True)
        out[g] = (uniq, vals[len(ids) - 1 - last_rev],
                  np.unique(np.concatenate(after.get(g, [ids[:0]]))))
    return out


def check_bootstrap(card, host, new, shard_id: int) -> None:
    """The new replica, after checkpoint bootstrap and catch-up: its ids
    are its peers', its rows what bootstrap + catch-up give
    (``expected_replica``), and equal to a peer's for every id streamed
    after the checkpoint."""
    peer = card.replica_sets[shard_id].replicas[0]
    for g, (ids, rows, streamed) in expected_replica(host, shard_id).items():
        got = new.tables[g].snapshot()
        o = np.argsort(got["ids"])
        _same(got["ids"][o], np.sort(peer.tables[g].all_ids()),
              f"new replica {g} ids against a peer's")
        _same(got["ids"][o], ids, f"new replica {g} ids")
        _same(got["w"][o], rows, f"new replica {g} rows")
        _same(new.lookup(g, streamed), peer.lookup(g, streamed),
              f"new replica {g} rows streamed after the checkpoint")


def check_hot_switch(card, host, version: int) -> None:
    """Right after the hot switch: every replica holds the serve transform
    of checkpoint ``version``'s rows (the host's NumPy materialization),
    its scatter sits at the checkpoint's offsets, and the serve caches
    are empty."""
    state = host._serve_state(version)
    for rs in card.replica_sets:
        for rep in rs.replicas:
            for g, (ids, serve) in state["groups"].items():
                mine = card.plan.slave_shard(ids) == rep.shard_id
                if len(rep.tables[g]) != int(mine.sum()):
                    raise AssertionError(f"hot switch: replica {g} rows")
                _same(rep.lookup(g, ids[mine]), serve[mine],
                      f"hot switch: replica {g} against v{version}")
    offsets = card.store.load(version).queue_offsets
    for sc in card.scatters:
        if any(off != offsets.get(p, 0) for p, off in sc.offsets().items()):
            raise AssertionError("hot switch: scatter offsets")
    if any(len(s.cache) for s in card.serving.registry):
        raise AssertionError("hot switch: the serve cache is not empty")


def compare_queues(queue, host_queue) -> int:
    """Queue records (headers, ids, payload bytes) equal across two logs;
    returns the count."""
    n_rec = 0
    for p in range(queue.num_partitions):
        recs, hrecs = queue.consume(p, 0)[0], host_queue.consume(p, 0)[0]
        if len(recs) != len(hrecs):
            raise AssertionError(f"partition {p}: record counts differ")
        for a, b in zip(recs, hrecs):
            if (a.group, a.op, a.seq, a.producer, a.meta) != \
                    (b.group, b.op, b.seq, b.producer, b.meta) or \
                    sorted(a.payload) != sorted(b.payload):
                raise AssertionError(f"partition {p}: record headers differ")
            _same(a.ids, b.ids, f"partition {p} record ids")
            for k in a.payload:
                _same(a.payload[k], b.payload[k], f"partition {p} {k}")
            n_rec += 1
    return n_rec


def compare_clusters(card, host) -> dict:
    """The card's cluster against the host twin: masters (ids, w, z, n,
    touch stats), queue records, every checkpoint (kind, base, tier,
    offsets, payload) and every replica, bit-equal."""
    n_rows = 0
    for m, hm in zip(card.masters, host.masters):
        for g in card.groups:
            _same_tree(_sorted_rows(m.tables[g].snapshot()),
                       _sorted_rows(hm.tables[g].snapshot()),
                       f"master {m.shard_id} {g}")
            n_rows += len(m.tables[g])
    n_rec = compare_queues(card.queue, host.queue)
    if card.store.versions() != host.store.versions():
        raise AssertionError("checkpoint versions differ")
    for v in card.store.versions():
        a, b = card.store.load(v), host.store.load(v)
        for f in ("kind", "base", "tier", "queue_offsets", "created_at",
                  "num_shards"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"checkpoint v{v} {f} differs")
        _same_tree(a.shard_snaps, b.shard_snaps, f"checkpoint v{v}")
    n_rep = 0
    for rs, hrs in zip(card.replica_sets, host.replica_sets):
        if len(rs.replicas) != len(hrs.replicas):
            raise AssertionError("replica counts differ")
        for rep, hrep in zip(rs.replicas, hrs.replicas):
            for g in card.groups:
                a, b = rep.tables[g].snapshot(), hrep.tables[g].snapshot()
                oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
                _same(a["ids"][oa], b["ids"][ob], f"replica {g} ids")
                _same(a["w"][oa], b["w"][ob], f"replica {g} rows")
            n_rep += 1
    return {"master_rows": n_rows, "records": n_rec,
            "checkpoints": len(card.store.versions()), "replicas": n_rep}


def mirror_bytes(cl) -> int:
    """Device bytes the cluster's table mirrors hold (masters, replicas,
    serve caches): what the held device memory should be made of."""
    tables = [t for m in cl.masters for t in m.tables.values()]
    tables += [t for rs in cl.replica_sets for rep in rs.replicas
               for t in rep.tables.values()]
    tables += [s.cache.table for s in cl.serving.registry]
    n = 0
    for t in tables:
        mir = t._dev
        if mir is not None and mir.keys is not None:
            n += sum(a.nbytes for a in (mir.keys, mir.slot_of,
                                        *mir.arenas.values()))
    return n


def drive_cluster(device, *, feature_space: int, fields: int, events: int,
                  ticks: int, corrupt_ticks: int, warm_reps: int,
                  seed: int = SEED) -> dict:
    """Drive ``WeiPSCluster`` for FM_FTRL (``fields`` wide, ``feature_space``
    ids) on ``device`` with its defaults (torch PS and codec backends),
    the durable queue and int8 delta-chain checkpoints: ``ticks`` ticks of
    ``events`` Zipf click events (``ClickStream`` → joiner → pipeline →
    train tick → sync tick → maybe_checkpoint → downgrade_check), a flush
    past the join window and warm predicts; then a delta and a full
    checkpoint, kill → recover of master 1, ``add_slave_replica(0)`` and a
    corrupted stream until the downgrade fires (at most
    ``corrupt_ticks``). A host twin (numpy backends, on the CPU) applies
    the card's recorded pushes and the same calls at the same points; the
    exact checks of the module docstring run along the way. The launch
    counters are reset before the phase; the checks' own launches are
    taken out of the path's count."""
    import gc
    import shutil

    import torch

    from repro_torch.configs.weips_ctr import FM_FTRL
    from repro_torch.core import WeiPSCluster
    from repro_torch.core.fault_tolerance import (Checkpoint,
                                                  checkpoint_nbytes)
    from repro_torch.data import ClickStream
    from repro_torch.kernels import ops

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    cfg = dataclasses.replace(FM_FTRL, fields=fields,
                              feature_space=feature_space, **CLUSTER_FTRL)
    card = WeiPSCluster(cfg, cluster_config("torch", device,
                                            CLUSTER_DIR / "card"))
    host = WeiPSCluster(cfg, cluster_config("numpy", "cpu",
                                            CLUSTER_DIR / "host"))
    for cl in (card, host):
        cl.downgrader.trigger.min_points = DOWNGRADE_MIN_POINTS
    stream = ClickStream(feature_space=feature_space, fields=fields,
                         zipf_a=1.2, signal_scale=0.8, feedback_delay=1.0,
                         seed=seed)
    pipe = card.make_train_pipeline()
    log: list = []
    record_pushes(card.masters, log)
    excluded = dict.fromkeys(ops.KERNELS, 0)

    def checking(fn, *args):
        """Run a check; its launches do not count on the path."""
        before = ops.launch_counts()
        out = fn(*args)
        sync()
        for k, v in ops.launch_counts().items():
            excluded[k] += v - before[k]
        return out

    def host_replay(mark: int) -> None:
        for mid, group, ids, grads, st in log[mark:]:
            host.masters[mid].push_grad(group, ids, grads, step=st)

    times = {"train": [], "sync": [], "ckpt": {}, "tick": []}

    def card_tick(now: float) -> dict:
        mark = len(log)
        t0 = time.perf_counter()
        pipe.ingest(stream.events_batch(events, now))
        t1 = time.perf_counter()
        trained = card.train_scheduler.tick(now)
        sync()
        t2 = time.perf_counter()
        pushed = card.sync_tick(now)
        sync()
        t3 = time.perf_counter()
        v = card.maybe_checkpoint(now)
        sync()
        t4 = time.perf_counter()
        fired = card.downgrade_check(now)
        sync()
        t5 = time.perf_counter()
        return {"mark": mark, "trained": any(trained.values()),
                "pushed": pushed, "v": v, "fired": fired,
                "ms": [(b - a) * 1e3 for a, b in
                       zip((t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5))]}

    def host_tick(now: float, r: dict) -> None:
        host_replay(r["mark"])
        host.sync_tick(now)
        if host.maybe_checkpoint(now) != r["v"]:
            raise AssertionError("checkpoint cadence differs from the host")
        if r["fired"] is not None:
            host.downgrader.execute(now, version=r["fired"])

    def keep(r: dict) -> None:
        times["tick"].append(sum(r["ms"]))
        if r["trained"]:
            times["train"].append(r["ms"][1])
            times["sync"].append(r["ms"][2])
        if r["v"] is not None:
            kind = card.store.load(r["v"]).kind
            times["ckpt"].setdefault(kind, []).append(r["ms"][3])

    t_phase = time.perf_counter()
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    now, prof = 0.0, None
    for i in range(ticks):
        if i == ticks - 1:
            r, prof = profile_step(lambda: card_tick(now), device)
            prof["ms"] = r["ms"]
        else:
            r = card_tick(now)
            keep(r)
        host_tick(now, r)
        if r["fired"] is not None:
            raise AssertionError(f"downgrade fired on the healthy stream "
                                 f"at tick {i}")
        now += CLUSTER_DT
    # flush past the join window, then warm predicts of fresh traffic
    now += card.ccfg.join_window + 1.0
    mark = len(log)
    card.train_scheduler.flush(now)
    card.sync_tick(now)
    host_replay(mark)
    host.sync_tick(now)
    req, _ = stream.batch(events)
    preds = [card.predict(req)]
    predict_ms = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        preds.append(card.predict(req))
        sync()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    want = host.predict(req)
    max_dev = max(check_preds(f"cluster predict {events}", req, p, want)
                  for p in preds)
    scn = card.training.scenario()
    joiner = pipe.metrics()["joiner"]
    loop = {"ticks": ticks, "examples": scn.stats.examples,
            "batches": scn.stats.batches, "dedup_ratio": scn.stats.dedup_ratio,
            "gather_dedup": float(np.mean([g.stats.dedup_ratio
                                           for g in card.gatherers])),
            "logloss": scn.evaluator.smoothed("logloss"),
            "auc": scn.evaluator.smoothed("auc"),
            "join_delay": joiner["join_delay"], "emitted": joiner["emitted"],
            "rows": {g: sum(len(m.tables[g]) for m in card.masters)
                     for g in card.groups},
            "versions": [(v, card.store.load(v).kind)
                         for v in card.store.versions()],
            "predict_ms": predict_ms, "max_pred_dev": max_dev}

    # checkpoints with no training after them: the chain is the masters
    ckpts = {}
    for kind, tier in (("delta", "local"), ("full", "remote")):
        t0 = time.perf_counter()
        v = card.checkpoint(now, tier=tier)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        host.checkpoint(now, tier=tier)
        ck = card.store.load(v)
        if ck.kind != kind:
            raise AssertionError(f"checkpoint v{v} is {ck.kind}, not {kind}")
        rows = checking(check_chain, card, host, v)
        plain = Checkpoint(v, now, checking(card.cold_backup.materialize,
                                            v)["shard_snaps"], {}, 4)
        ckpts[kind] = {"v": v, "ms": ms, "rows": rows,
                       "nbytes": checkpoint_nbytes(ck),
                       "plain_nbytes": checkpoint_nbytes(plain)}
        del plain

    # faults: kill → recover master 1, a replica from the chain
    mem = {"mirrors_before": mirror_bytes(card)}
    if cuda:
        mem["peak_before"] = torch.cuda.max_memory_allocated()
        mem["before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    faults = {}
    for cl in (card, host):
        cl.kill_master(1)
    t0 = time.perf_counter()
    v = card.recover_master(1)
    sync()
    faults["recover_master_ms"] = (time.perf_counter() - t0) * 1e3
    if host.recover_master(1) != v:
        raise AssertionError("recover_master versions differ")
    checking(check_recovered, card, 1, v)
    faults["recovered_from"] = v
    for cl in (card, host):              # stream the recovered shard
        cl.sync_tick(now)
    t0 = time.perf_counter()
    new = card.add_slave_replica(0)
    sync()
    faults["add_replica_ms"] = (time.perf_counter() - t0) * 1e3
    host.add_slave_replica(0)
    checking(check_bootstrap, card, host, new, 0)

    # a corrupted stream until the domino downgrade fires
    stream.corrupt()
    now += CLUSTER_DT
    fired = None
    for i in range(corrupt_ticks):
        r = card_tick(now)
        keep(r)
        host_tick(now, r)
        now += CLUSTER_DT
        if r["fired"] is not None:
            fired = r["fired"]
            faults.update(downgrade_tick=i, downgrade_to=fired,
                          hot_switch_ms=r["ms"][4],
                          logloss=scn.evaluator.smoothed(
                              "logloss", card.ccfg.downgrade_window))
            checking(check_hot_switch, card, host, fired)
            break
    if fired is None:
        raise AssertionError(f"no downgrade within {corrupt_ticks} ticks of "
                             f"the corrupted stream")
    for cl in (card, host):              # replay from the offsets
        cl.sync_tick(now)
    preds = card.predict(req)
    faults["max_pred_dev"] = check_preds("cluster predict after the switch",
                                         req, preds, host.predict(req))
    sync()
    launches = {k: v - excluded[k] for k, v in ops.launch_counts().items()}
    mem["mirrors_after"] = mirror_bytes(card)
    if cuda:
        mem["peak_after"] = torch.cuda.max_memory_allocated()
        mem["after"] = torch.cuda.memory_allocated()
    phase_s = time.perf_counter() - t_phase

    compared = compare_clusters(card, host)
    names = canonical_metrics(card)
    want_names = set(metric_snapshot()) | set(PIPELINE_METRICS)
    if names != want_names:
        raise AssertionError(f"metric names: extra {sorted(names - want_names)}"
                             f", missing {sorted(want_names - names)}")
    placements = sorted({t.mirror_metrics()["placement"]
                         for t in [t for m in card.masters
                                   for t in m.tables.values()]
                         + [t for rs in card.replica_sets
                            for rep in rs.replicas
                            for t in rep.tables.values()]
                         + [s.cache.table for s in card.serving.registry]
                         if t.mirror_metrics() is not None})
    staleness = card.sync_metrics(now)["staleness"]
    for cl in (card, host):
        cl.queue.close()
    del card, host, new, pipe, stream, log, scn, cl
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        mem["freed"] = torch.cuda.memory_allocated()
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    return {"loop": loop, "times": times, "profile": prof, "ckpts": ckpts,
            "faults": faults, "mem": mem, "launches": launches,
            "compared": compared, "placements": placements,
            "metric_names": len(names), "staleness": staleness,
            "phase_s": phase_s}


def cluster_child(out_path: str) -> int:
    """Phase 5 on its own: the child process ``run_cluster_phase`` starts.
    Prints the phase's report and writes its launch counts to
    ``out_path``."""
    import torch

    from repro_torch.configs.weips_ctr import FM_FTRL
    res = drive_cluster(torch.device("cuda"),
                        feature_space=FM_FTRL.feature_space,
                        fields=FM_FTRL.fields, events=CLUSTER_EVENTS,
                        ticks=CLUSTER_TICKS,
                        corrupt_ticks=CLUSTER_CORRUPT_TICKS,
                        warm_reps=CLUSTER_WARM_REPS)
    report_cluster(res)
    Path(out_path).write_text(json.dumps(res["launches"]))
    return 0


def run_cluster_phase() -> dict:
    """Run phase 5 in a child process and return its launch counts. The
    child has a torch.profiler of its own: a further profiling session in
    this process makes later sessions here list only some of a call's
    kernels (the LM training phase's scatter-add check saw its kernel
    without the sort). The child's state is gone when it exits."""
    out = CLUSTER_DIR.with_name("cluster_launches.json")
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--cluster-phase", str(out)], timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the cluster phase failed (exit "
                             f"{proc.returncode})")
    launches = json.loads(out.read_text())
    out.unlink()
    return launches


def _pcts(v) -> str:
    return (f"p50 {np.percentile(v, 50):.3f} ms, p99 "
            f"{np.percentile(v, 99):.3f} ms over {len(v)}")


def report_cluster(res: dict) -> None:
    """Print the cluster phase's numbers and hold its launches."""
    lp, tm, ck, ft = res["loop"], res["times"], res["ckpts"], res["faults"]
    print(f"cluster: WeiPSCluster(FM_FTRL fields={FIELDS} embed 8, "
          f"{lp['ticks']} ticks of {CLUSTER_EVENTS} Zipf events) in "
          f"{res['phase_s']:.1f} s with its host twin; trained "
          f"{lp['examples']} examples in {lp['batches']} batches, logloss "
          f"{lp['logloss']:.4f}, auc {lp['auc']:.4f}; master rows "
          f"{lp['rows']}; checkpoints {lp['versions']}", flush=True)
    print(f"  dedup ratio of the Zipf traffic: per train batch "
          f"{lp['dedup_ratio']:.4f}, per sync gather "
          f"{lp['gather_dedup']:.4f}")
    for what, v in (("train tick", tm["train"]), ("sync tick", tm["sync"]),
                    ("whole tick", tm["tick"]),
                    (f"warm predict {CLUSTER_EVENTS}", lp["predict_ms"])):
        print(f"  {what:>18}: {_pcts(v)}")
    jd = lp["join_delay"]
    print(f"  event -> deployed staleness: join wait p50 {jd['p50']:.3f} s, "
          f"p99 {jd['p99']:.3f} s (stream clock) + train -> deployed (the "
          f"sync tick after each train tick, wall) {_pcts(tm['sync'])}; "
          f"scatter staleness on the stream clock {res['staleness']}")
    for kind, v in sorted(tm["ckpt"].items()):
        print(f"  maybe_checkpoint {kind:>5}: {_pcts(v)}")
    for kind, c in ck.items():
        print(f"  checkpoint {kind} v{c['v']}: {c['ms']:.1f} ms, "
              f"checkpoint_nbytes {c['nbytes']} int8 ({c['plain_nbytes']} "
              f"as float32); chain == live masters ({c['rows']} rows, int8 "
              f"round trip bit-equal to the NumPy codec's)")
    print(f"  recover_master(1) from v{ft['recovered_from']}: "
          f"{ft['recover_master_ms']:.1f} ms; add_slave_replica(0): "
          f"{ft['add_replica_ms']:.1f} ms; downgrade after "
          f"{ft['downgrade_tick'] + 1} corrupted ticks (logloss "
          f"{ft['logloss']:.4f}) to v{ft['downgrade_to']}, hot switch "
          f"{ft['hot_switch_ms']:.1f} ms")
    mem = res["mem"]
    if "peak_before" in mem:
        print(f"  device memory: peak {mem['peak_before']} B before the "
              f"faults ({mem['before']} B held, table mirrors "
              f"{mem['mirrors_before']} B), peak {mem['peak_after']} B "
              f"during them ({mem['after']} B held, table mirrors "
              f"{mem['mirrors_after']} B), {mem['freed']} B after the "
              f"phase's state was freed")
    prof = res["profile"]
    busy = "not visible to torch.profiler" if prof["busy_ms"] is None \
        else (f"{prof['busy_ms']:.3f} ms "
              f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy)")
    print(f"  profiled last tick: wall {prof['wall_ms']:.1f} ms, device "
          f"{busy}; host time by function (own ms): "
          + ", ".join(f"{k} {ms:.2f}" for k, ms in prof["top"][:8]))
    cmp = res["compared"]
    print(f"  host twin: {cmp['master_rows']} master rows, {cmp['records']} "
          f"queue records, {cmp['checkpoints']} checkpoints and "
          f"{cmp['replicas']} replicas bit-equal; predictions within "
          f"{max(lp['max_pred_dev'], ft['max_pred_dev']):.3g}; "
          f"{res['metric_names']} metric names (the 63 frozen + the "
          f"pipeline's {len(PIPELINE_METRICS)})")
    print(f"  placements {res['placements']}; launches in the cluster "
          f"phase: {res['launches']}", flush=True)
    missing = [k for k in CLUSTER_KERNELS if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the cluster "
                             f"phase: {missing}")


# ---------------------------------------------------------------------------
# The multi-process runtime: ClusterRuntime's process-per-shard grid with
# every worker's PS on the card, SIGKILLs at the four crash windows, beside
# a host twin and a fault-free run
# ---------------------------------------------------------------------------

# LR_FTRL at full width (configs/weips_ctr.py): 2^22 ids, 32 a sample
RUNTIME_VOCAB, RUNTIME_FEATS, RUNTIME_BATCH = 1 << 22, 32, 4096
RUNTIME_STEPS = 24
RUNTIME_ADD_AT, RUNTIME_REMOVE_AT = 16, 20
RUNTIME_REMOVED = "slave-0.0"
RUNTIME_LOOKUP_REPS = 8
RUNTIME_DEVICE = "cuda:0"           # every worker on one card, by index
RUNTIME_DIR = ROOT / "build" / "runtime_smoke"
# kernels the runtime's workers must launch (either probe, by placement)
RUNTIME_KERNELS = ("embedding_lookup", "embedding_scatter",
                   "ftrl_row_update", "quantize_rows", "dequantize_rows")
RUNTIME_SPANS = ("driver.step", "fault.kill", "recover")


def runtime_plan():
    """The phase's fault plan over 24 steps (ckpt_every 4, full_every 3):
    a master killed at ``mid_train`` (step 5, after the delta v2 of step
    4), another at ``mid_flush`` (step 9), a third at ``mid_ckpt`` while
    it writes the delta of step 16, a slave replica at ``pre_apply``
    (step 19); one dropped fetch and one delayed flush."""
    from repro_torch.launch.chaos import FaultEvent, FaultPlan
    return FaultPlan(seed=SEED, events=[
        FaultEvent("slave-0.0", "pre_apply", 2, "drop"),
        FaultEvent("master-0", "mid_train", 5, "kill"),
        FaultEvent("master-3", "mid_flush", 7, "delay", 0.05),
        FaultEvent("master-1", "mid_flush", 9, "kill"),
        FaultEvent("master-2", "mid_ckpt", 16, "kill"),
        FaultEvent("slave-1.0", "pre_apply", 19, "kill")])


def runtime_config(root: Path, device, backend: str, *, vocab: int,
                   batch: int, feats: int, trace: bool):
    """LR_FTRL's runtime shape: group emb of width 1, FTRL, int8 sync
    codec, 4 masters, 2 slave shards x 2 replicas, 8 partitions, a cut
    every 4 steps and every third cut full. The serve cache is off, so
    every lookup takes the replica's device path (a cache hit is a host
    probe)."""
    from repro_torch.launch.runtime import RuntimeConfig
    return RuntimeConfig(
        root=str(root), num_master=4, num_slave=2, num_replicas=2,
        num_partitions=8, groups={"emb": 1}, optimizer="ftrl",
        codec="int8", vocab=vocab, batch_size=batch,
        feats_per_sample=feats, ckpt_every=4, full_every=3, trace=trace,
        serve_cache_rows=0, device=str(device), ps_backend=backend,
        codec_backend=backend)


def runtime_lookup_ids(rt, count: int) -> dict:
    """Per slave shard, ``count`` ids it owns from the batches of the
    steps before ``rt.step`` (trained ids, so the lookups hit)."""
    out = {}
    for shard in range(rt.cfg.num_slave):
        got, step, n = [], rt.step, 0
        while n < count and step > 0:
            step -= 1
            flat = rt._batch(step)[0].reshape(-1)
            own = flat[rt.routing.slave_shard(flat) == shard]
            got.append(own)
            n += len(own)
        out[shard] = np.concatenate(got)[:count]
    return out


def gpu_memory_by_pid() -> dict:
    """``{pid: used MiB}`` of the compute processes ``nvidia-smi`` lists
    (empty where it cannot see them)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    mem = {}
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            mem[int(parts[0])] = parts[1]
    return mem


def _kernel_sum(trees) -> dict:
    out: dict = {}
    for t in trees:
        for k, n in t.items():
            out[k] = out.get(k, 0) + n
    return out


def runtime_run(root: Path, device, backend: str, plan, *, steps: int,
                vocab: int, batch: int, feats: int, elastic: bool,
                lookup_reps: int, trace: bool) -> dict:
    """One ``ClusterRuntime`` run to ``steps``: start, drive (recovering
    from every death, each recovery timed from the first ``WorkerDied``
    until the cluster is back at the step that died), with ``elastic``
    ``add_replica(0)`` at ``RUNTIME_ADD_AT`` and ``remove_replica`` of
    ``RUNTIME_REMOVED`` at ``RUNTIME_REMOVE_AT``; then lookup RPCs of
    ``batch * feats`` owned ids on every slave replica (the first call
    apart from ``lookup_reps`` warm ones); returns the end state and the
    timings. The workers' ``kernels`` counters count from their spawn:
    the launches of a killed life are lost with it."""
    from repro_torch.launch.runtime import ClusterRuntime
    from repro_torch.launch.transport import WorkerDied
    cfg = runtime_config(root, device, backend, vocab=vocab, batch=batch,
                         feats=feats, trace=trace)
    rt = ClusterRuntime(cfg, plan)
    res = {"step_ms": [], "recoveries": [], "ckpt": [], "removed": {}}
    commit = rt.checkpoint

    def timed_checkpoint(force_full: bool = False) -> int:
        t = time.perf_counter()
        v = commit(force_full=force_full)
        res["ckpt"].append((v, rt.store.load(v).kind, rt.step,
                            1e3 * (time.perf_counter() - t)))
        return v
    rt.checkpoint = timed_checkpoint

    def drive(to: int) -> None:
        open_rec = None
        while rt.step < to:
            replay = rt.step < rt._replaying_until
            t0 = time.perf_counter()
            try:
                rt.step_once()
            except WorkerDied:
                t_died = time.perf_counter()
                if open_rec is None:
                    open_rec = {"died_at": rt.step, "t0": t_died}
                rt.recover()
                open_rec.setdefault("parts", []).append(
                    dict(rt.last_recovery, rewind_to=rt.step))
            else:
                if not replay and open_rec is None:
                    res["step_ms"].append(1e3 * (time.perf_counter() - t0))
            if open_rec is not None and rt.step >= open_rec["died_at"]:
                open_rec["s"] = time.perf_counter() - open_rec.pop("t0")
                res["recoveries"].append(open_rec)
                open_rec = None

    try:
        t = time.perf_counter()
        rt.start()
        res["start_s"] = time.perf_counter() - t
        res["workers"] = len(rt.procs)
        if elastic:
            drive(RUNTIME_ADD_AT)
            t = time.perf_counter()
            res["added"] = rt.add_replica(0)
            res["add_replica_s"] = time.perf_counter() - t
            drive(RUNTIME_REMOVE_AT)
            res["removed"] = rt.clients[RUNTIME_REMOVED].call(
                "metrics")["kernels"]
            rt.remove_replica(RUNTIME_REMOVED)
        drive(steps)
        ids = runtime_lookup_ids(rt, batch * feats)
        res["lookups"], res["lookup_ms"] = {}, {"first": [], "warm": []}
        for name in rt.slave_names():
            q = ids[int(name.split("-")[1].split(".")[0])]
            c = rt.clients[name]
            t = time.perf_counter()
            first = c.call("lookup", group="emb", ids=q)
            res["lookup_ms"]["first"].append(1e3 * (time.perf_counter() - t))
            for _ in range(lookup_reps):
                t = time.perf_counter()
                warm = c.call("lookup", group="emb", ids=q)
                res["lookup_ms"]["warm"].append(
                    1e3 * (time.perf_counter() - t))
                _same(warm, first, f"{name}: a warm lookup")
            res["lookups"][name] = first
        res["masters"] = rt.master_state()
        res["slaves"] = rt.slave_state()
        res["offsets"] = {n: rt.clients[n].call("offsets")
                          for n in rt.slave_names()}
        res["metrics"] = rt.cluster_metrics()
        res["n_recoveries"] = rt.recoveries
        res["versions"] = rt.store.versions()
        res["pids"] = {n: p.pid for n, p in rt.procs.items()}
        res["gpu_mib"] = gpu_memory_by_pid() if device != "cpu" else {}
        if trace:
            path = str(root / "runtime_trace.json")
            res["trace_events"] = rt.export_trace(path)
            from repro_torch.obs import perfetto
            res["span_names"] = sorted({s["name"]
                                        for s in perfetto.load_spans(path)})
    finally:
        rt.shutdown()
    trees = [m["kernels"] for m in res.get("metrics", {}).get(
        "workers", {}).values() if m]
    res["launches"] = _kernel_sum(trees + [res["removed"]])
    return res


def drive_runtime(device, *, vocab: int, batch: int, feats: int,
                  steps: int = RUNTIME_STEPS,
                  lookup_reps: int = RUNTIME_LOOKUP_REPS) -> dict:
    """Phase 5b: ``ClusterRuntime`` with ``runtime_plan()`` on ``device``
    (the torch backends, every worker its own process and CUDA context),
    traced, alone and timed; then, side by side in two threads, the same
    run on the host twin (numpy backends on the CPU, the same plan and
    the same replica moves and lookups) and a fault-free run on
    ``device``. Masters, slaves, queue offsets and lookups must equal
    the twin's bit for bit, and masters the fault-free run's."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.obs import trace as obs_trace
    shutil.rmtree(RUNTIME_DIR, ignore_errors=True)
    plan = runtime_plan()
    shape = dict(steps=steps, vocab=vocab, batch=batch, feats=feats,
                 lookup_reps=lookup_reps)
    t_phase = time.perf_counter()
    try:
        card = runtime_run(RUNTIME_DIR / "card", device, "torch", plan,
                           elastic=True, trace=True, **shape)
        obs_trace.disable()
        t = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            twin_f = pool.submit(runtime_run, RUNTIME_DIR / "twin", "cpu",
                                 "numpy", plan, elastic=True, trace=False,
                                 **shape)
            free_f = pool.submit(runtime_run, RUNTIME_DIR / "free", device,
                                 "torch", None, elastic=False, trace=False,
                                 **dict(shape, lookup_reps=0))
            twin, free = twin_f.result(), free_f.result()
        compare_s = time.perf_counter() - t
    finally:
        obs_trace.disable()
        shutil.rmtree(RUNTIME_DIR, ignore_errors=True)
    for what in ("masters", "slaves", "offsets", "lookups"):
        _same_tree(card[what], twin[what], f"runtime {what}: card vs twin")
    _same_tree(card["masters"], free["masters"],
               "runtime masters: chaos run vs fault-free run")
    kills = len(plan.kills())
    for label, r, want in (("card", card, kills), ("twin", twin, kills),
                           ("fault-free", free, 0)):
        if r["n_recoveries"] != want or len(r["recoveries"]) != want:
            raise AssertionError(f"runtime {label} run: "
                                 f"{r['n_recoveries']} recoveries, "
                                 f"{want} wanted")
    missing = [s for s in RUNTIME_SPANS if s not in card["span_names"]]
    if missing:
        raise AssertionError(f"runtime trace lacks spans {missing}")
    return {"card": card, "twin": twin, "free": free, "kills": kills,
            "compare_s": compare_s, "phase_s": time.perf_counter() - t_phase,
            "launches": card["launches"]}


def report_runtime(res: dict) -> None:
    """Print the runtime phase's numbers and hold its launches."""
    card = res["card"]
    n_rows = sum(len(s["ids"]) for s in card["masters"].values())
    print(f"runtime: ClusterRuntime (LR_FTRL, {RUNTIME_BATCH} x "
          f"{RUNTIME_FEATS} ids a step over 2^22, int8 sync, 4 masters, "
          f"2 slave shards x 2 replicas, one process each on "
          f"{RUNTIME_DEVICE}) in {res['phase_s']:.1f} s: {RUNTIME_STEPS} "
          f"steps, {res['kills']} kills, {card['n_recoveries']} recoveries; "
          f"master rows {n_rows}; checkpoints {card['versions']}",
          flush=True)
    print(f"  startup (spawn {card['workers']} workers, connect, "
          f"bootstrap checkpoint): {card['start_s']:.2f} s")
    first, rest = card["step_ms"][0], card["step_ms"][1:]
    print(f"  step (host clock around step_once, replays out): first "
          f"{first:.1f} ms (each worker's first device call creates its "
          f"CUDA context), then {_pcts(rest)}")
    for r in card["recoveries"]:
        parts = "; ".join(
            f"{','.join(p['workers'])}: reap {p['reap_s']:.3f} s, respawn "
            f"{p['respawn_s']:.2f} s, restore {p['restore_s']:.2f} s, "
            f"rewind to {p['rewind_to']}" for p in r["parts"])
        print(f"  recovery of step {r['died_at']}: {r['s']:.2f} s back to "
              f"it ({parts})")
    print(f"  add_replica(0) -> {card['added']}: "
          f"{card['add_replica_s']:.2f} s")
    for v, kind, step, ms in card["ckpt"]:
        print(f"  checkpoint v{v} ({kind}) at step {step}: commit "
              f"{ms:.1f} ms")
    lk = card["lookup_ms"]
    print(f"  lookup {RUNTIME_BATCH} x {RUNTIME_FEATS} ids (RPC, probe + "
          f"gather on the replica): first call p50 "
          f"{np.percentile(lk['first'], 50):.3f} ms over "
          f"{len(lk['first'])} replicas, warm {_pcts(lk['warm'])}")
    mem = card["gpu_mib"]
    mine = {n: mem[pid] for n, pid in sorted(card["pids"].items())
            if pid in mem}
    print("  device memory by worker (nvidia-smi used_memory, MiB): "
          + (", ".join(f"{n} {v}" for n, v in mine.items()) if mine else
             f"no worker pid listed (another pid namespace); it lists "
             f"(pid, MiB) {sorted(mem.items())} for the "
             f"{len(card['pids'])} workers"
             if mem else "nvidia-smi lists no compute process"))
    held = {n: m["device_memory"] for n, m in
            sorted(card["metrics"]["workers"].items())
            if m and "device_memory" in m}
    print("  allocator bytes by worker (reserved / allocated, the context "
          "not in them): " + ", ".join(
              f"{n} {d['reserved']} / {d['allocated']}"
              for n, d in held.items()))
    print(f"  host twin (numpy backends, CPU) and fault-free card run in "
          f"{res['compare_s']:.1f} s: masters, slaves, offsets and "
          f"{len(card['lookups'])} replicas' lookups bit-equal to the "
          f"twin; masters bit-equal to the fault-free run; merged trace "
          f"{card['trace_events']} events with {', '.join(RUNTIME_SPANS)}")
    print(f"  launches summed over the workers (killed lives lost): "
          f"{res['launches']}", flush=True)
    ln = res["launches"]
    missing = [k for k in RUNTIME_KERNELS if ln.get(k, 0) <= 0]
    if ln.get("hashmap_probe", 0) + ln.get("hashmap_probe_hbm", 0) <= 0:
        missing.append("hashmap_probe / hashmap_probe_hbm")
    if missing:
        raise AssertionError(f"kernels never launched in the runtime "
                             f"phase: {missing}")


def runtime_child(out_path: str) -> int:
    """Phase 5b on its own, in the child process ``run_runtime_phase``
    starts. Prints the phase's report and writes its launch counts to
    ``out_path``."""
    res = drive_runtime(RUNTIME_DEVICE, vocab=RUNTIME_VOCAB,
                        batch=RUNTIME_BATCH, feats=RUNTIME_FEATS)
    report_runtime(res)
    Path(out_path).write_text(json.dumps(res["launches"]))
    return 0


def run_runtime_phase() -> dict:
    """Run phase 5b in a child process (its supervisor spawns the workers;
    nothing of it stays in this process) and return the workers' launch
    counts."""
    out = RUNTIME_DIR.with_name("runtime_launches.json")
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--runtime-phase", str(out)], timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the runtime phase failed (exit "
                             f"{proc.returncode})")
    launches = json.loads(out.read_text())
    out.unlink()
    return launches


# ---------------------------------------------------------------------------
# LM serving: qwen2-1.5b prefill and greedy decode with hot swap
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2-1.5b"
PREFILL_BATCH, PREFILL_LEN, PREFILL_REPS = 4, 2048, 5
SERVE_ARGV = ("--arch", LM_ARCH, "--batch", "4", "--steps", "32",
              "--max-len", "64", "--hot-swap-every", "8",
              "--seed", str(SEED))
LONG_LEN, LONG_POS, LONG_STEPS = 4096, 4000, 32
LM_KERNELS = ("flash_attention", "decode_attention")
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
F32_PEAK_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
F32_LOGIT_ATOL = 1e-3               # float32 logits, kernel vs plain path
# bfloat16 logits, kernel vs plain path: the two attentions agree to fp32
# rounding, but a bf16 rounding of an attention output can flip and travel
# through 28 layers; the bound is set in PERF.md before the first run
BF16_LOGIT_BOUND = 1.0


LM_PLAIN = ("flash_attention", "decode_attention", "embedding_lookup",
            "embedding_scatter_add")


@contextlib.contextmanager
def plain_attention():
    """Route the LM's kernels — both attentions, the token gather and its
    gradient — through their plain versions, on any device: the path the
    kernel path is held against. The model calls them as attributes of
    ``kernels.ops``, so swapping those is enough; the kernels' counters
    do not move."""
    from repro_torch.kernels import ops, ref
    saved = {name: getattr(ops, name) for name in LM_PLAIN}
    for name in LM_PLAIN:
        setattr(ops, name, getattr(ref, name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _logit_dev(a, b, vocab: int) -> tuple[float, float]:
    """Largest |a - b| over the real vocabulary columns, and the share of
    rows whose greedy token agrees."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    dev = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    return dev, agree


def profile_call(fn, device) -> dict:
    """One ``fn()`` under ``torch.profiler`` (CPU + CUDA): wall time, the
    device-busy time (the CUDA kernels' and copies' own time), the top
    device entries, and the host's kernel launches and stream syncs.
    ``busy_ms`` is None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t
    ka = prof.key_averages()
    dev = sorted(((e.key, e.self_device_time_total) for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    count = lambda *names: sum(e.count for e in ka if e.key in names)
    return {"wall_ms": wall * 1e3,
            "busy_ms": sum(t for _, t in dev) / 1e3 if dev else None,
            "top": [(k[:50], t / 1e3) for k, t in dev[:6]],
            "entries": [(k, t / 1e3) for k, t in dev],
            "attention_ms": {name: sum(t for k, t in dev if name in k) / 1e3
                             for name in ATTENTION_KERNELS},
            "launches": count("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC", "cuLaunchKernelEx"),
            "syncs": count("cudaStreamSynchronize", "cudaDeviceSynchronize")}


def _profile_line(label: str, prof: dict) -> str:
    busy = "not visible to torch.profiler" if prof["busy_ms"] is None \
        else (f"{prof['busy_ms']:.3f} ms "
              f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy)")
    return (f"  profiled {label}: wall {prof['wall_ms']:.3f} ms, device "
            f"{busy}; {prof['launches']} kernel launches and "
            f"{prof['syncs']} stream syncs from the host; top "
            + ", ".join(f"{k} {ms:.4f}" for k, ms in prof["top"])
            + "; attention kernels (device ms) "
            + ", ".join(f"{k} {ms:.4f}"
                        for k, ms in prof["attention_ms"].items()))


def prefill_phase(cfg, params, tokens, reps: int, device) -> dict:
    """``make_prefill_step`` on ``tokens``: once in float32 (the params
    cast) and ``reps`` timed times in the config's bf16 on the kernel
    path, each against the plain path on the same params and tokens,
    then once more profiled. ``forwards`` counts the kernel path's
    forwards (a warm-up included)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import make_prefill_step
    fa = ops.KERNELS["flash_attention"]
    batch = {"tokens": tokens}
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = _tree_map(lambda t: t.float(), params)
    step32 = make_prefill_step(cfg32)
    before = fa.launches
    kernel = step32(p32, batch)
    _sync(device)
    per_forward = fa.launches - before
    with plain_attention():
        plain = step32(p32, batch)
    f32_dev, f32_agree = _logit_dev(kernel, plain, cfg.vocab_size)
    del p32, kernel, plain
    step = make_prefill_step(cfg)
    ms = []
    for _ in range(reps + 1):                   # the first warms up
        t0 = time.perf_counter()
        kernel = step(params, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    with plain_attention():
        plain = step(params, batch)
    bf16_dev, bf16_agree = _logit_dev(kernel, plain, cfg.vocab_size)
    if not (torch.isfinite(kernel[..., :cfg.vocab_size]).all()
            and kernel.shape == (*tokens.shape, cfg.padded_vocab)):
        raise AssertionError("prefill logits not finite of shape (B, S, V)")
    del kernel, plain
    prof = profile_call(lambda: step(params, batch), device)
    return {"per_forward": per_forward, "forwards": len(ms) + 2,
            "f32_dev": f32_dev, "f32_agree": f32_agree, "bf16_dev": bf16_dev,
            "bf16_agree": bf16_agree, "ms": ms[1:], "profile": prof}


def _recording(step_fn, records: list):
    """``step_fn`` that also keeps each step's params, tokens, positions
    and logits, so the plain path can replay the kernel path's steps."""
    def step(params, cache, tokens, pos):
        logits, cache = step_fn(params, cache, tokens, pos)
        records.append((params, tokens, pos, logits))
        return logits, cache
    return step


def decode_run(cfg, driver, params, args, gen, device) -> dict:
    """``launch.serve.run`` on ``driver`` (hot swaps and all), then the
    plain path teacher-forced: each recorded step replayed with the same
    params, tokens and positions on a copy of the cache as it stood before
    the run, its logits compared with the kernel path's."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step
    records: list = []
    driver.step_fn = _recording(driver.step_fn, records)
    plain_cache = _tree_map(lambda t: t.clone(), driver.cache)
    t0 = time.perf_counter()
    tokens, lat = serve.run(driver, params, args, gen)
    wall = time.perf_counter() - t0
    devs, agree = [], []
    with plain_attention():
        for p, tok, pos, logits in records:
            plain, plain_cache = decode_step(p, cfg, plain_cache, tok, pos)
            d, a = _logit_dev(logits, plain, cfg.vocab_size)
            devs.append(d)
            agree.append(a)
    if tokens.shape != (args.batch, args.steps) or not (
            (0 <= tokens) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"decode tokens of shape {tokens.shape} or out "
                             f"of the vocabulary")
    _sync(device)
    return {"lat_ms": [x * 1e3 for x in lat], "wall_s": wall,
            "max_dev": max(devs), "agree": float(np.mean(agree)),
            "steps": len(records)}


def drive_lm(device, serve_argv, *, prefill_batch: int, prefill_len: int,
             prefill_reps: int, long_len: int, long_pos: int,
             long_steps: int, seed: int = SEED) -> dict:
    """The LM serving path through its entry points: ``launch.serve``
    builds the model and its ``ServeDriver`` from ``serve_argv``;
    ``make_prefill_step`` runs a prefill of ``prefill_batch`` x
    ``prefill_len`` tokens (float32 and bf16); the launcher's own decode
    run follows, then a decode against a long cache seeded up to
    ``long_pos`` of ``long_len``. Each is held against the plain path.
    The launch counters are reset before and read after the whole path."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.predictor import ServeDriver

    args = serve.parse_args([*serve_argv, "--device", device.type])
    cfg, params, driver, gen = serve.build(args)
    data = torch.Generator(device=device).manual_seed(seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (prefill_batch, prefill_len),
                           generator=data, device=device)
    long_args = serve.parse_args([*serve_argv, "--device", device.type,
                                  "--steps", str(long_steps),
                                  "--max-len", str(long_len)])
    long_driver = ServeDriver(cfg=cfg, params=params, batch=long_args.batch,
                              max_len=long_len, cache_dtype=torch.float32,
                              device=device)
    for seg in long_driver.cache["segments"]:       # K/V of a long context
        for kv in seg.values():
            for t in kv.values():
                t[:, :, :long_pos] = torch.randn(
                    t[:, :, :long_pos].shape, generator=data,
                    device=device)
    long_driver.pos = torch.full((long_args.batch,), long_pos,
                                 dtype=torch.int32, device=device)
    sizes = {"param_bytes": _tree_bytes(params),
             "cache_bytes": _tree_bytes(driver.cache)
             + _tree_bytes(long_driver.cache)}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    prefill = prefill_phase(cfg, params, tokens, prefill_reps, device)
    after_prefill = ops.launch_counts()
    serve_run = decode_run(cfg, driver, params, args, gen, device)
    after_serve = ops.launch_counts()
    long_run = decode_run(cfg, long_driver, params, long_args, gen, device)
    launches = ops.launch_counts()
    serve_run["launches"] = after_serve["decode_attention"] \
        - after_prefill["decode_attention"]
    long_run["launches"] = launches["decode_attention"] \
        - after_serve["decode_attention"]
    if device.type == "cuda":
        sizes["peak_bytes"] = torch.cuda.max_memory_allocated()
    # one more step of the long run, profiled (after the comparisons)
    tok = torch.zeros((long_args.batch, 1), dtype=torch.int32, device=device)
    long_run["profile"] = profile_call(lambda: long_driver.step(tok), device)
    # the path's own attention inputs for the kernels' timing rows: a
    # layer's q, k, v at the prefill's shapes, and a layer's cache of the
    # long run with its first step's lengths
    cache0 = long_driver.cache["segments"][0]["pos0"]
    return {"cfg": cfg, "prefill": prefill, "serve": serve_run,
            "long": long_run, "launches": launches, "sizes": sizes,
            "layers": cfg.num_layers,
            "decode_inputs": (cache0["k"][0], cache0["v"][0],
                              long_pos + 1)}


def _attn_inputs(b, h, g, s, d, dtype, gen, device):
    """q (B, H, S, D), k, v (B, G, S, D) as the model hands them to the
    kernel: transposed views of (B, S, heads, D) projections."""
    import torch
    return tuple(torch.randn((b, s, n, d), generator=gen, device=device)
                 .to(dtype).transpose(1, 2) for n in (h, g, g))


def _check_close(name: str, got, want, tol: float) -> float:
    """``got`` within ``rtol = atol = tol`` of ``want`` elementwise;
    returns the largest absolute deviation."""
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"{name}: deviates from its plain version by "
                             f"{float(diff.max()):.3g}, over rtol=atol={tol}")
    return float(diff.max())


def check_lm_kernels(cfg, device) -> list[str]:
    """Both LM kernels against their plain versions at the path's shapes,
    within 2e-5 (float32) and 2e-2 (bf16) relative and absolute."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    h, g, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    lines = []
    for s, causal, dtype in ((PREFILL_LEN, True, torch.bfloat16),
                             (PREFILL_LEN, True, torch.float32),
                             (1000, True, torch.bfloat16),
                             (1000, True, torch.float32),
                             (PREFILL_LEN, False, torch.bfloat16)):
        q, k, v = _attn_inputs(PREFILL_BATCH, h, g, s, d, dtype, gen, device)
        dev = _check_close("flash_attention",
                           fa.flash_attention(q, k, v, causal=causal),
                           ref.flash_attention(q, k, v, causal=causal),
                           tol[dtype])
        lines.append(f"flash_attention ({PREFILL_BATCH}, {h}, {s}, {d}) "
                     f"{'causal' if causal else 'full'} {str(dtype)[6:]}: "
                     f"max deviation {dev:.3g}")
    lengths = torch.tensor([1, LONG_LEN, 2048, LONG_POS + 1],
                           dtype=torch.int32, device=device)
    for q_dtype, kv_dtype in ((torch.float32, torch.float32),
                              (torch.bfloat16, torch.float32),
                              (torch.bfloat16, torch.bfloat16)):
        q = torch.randn((4, h, d), generator=gen, device=device).to(q_dtype)
        k, v = (torch.randn((4, LONG_LEN, g, d), generator=gen,
                            device=device).to(kv_dtype) for _ in range(2))
        dev = _check_close("decode_attention",
                           da.decode_attention(q, k, v, lengths),
                           ref.decode_attention(q, k, v, lengths),
                           tol[q_dtype])
        lines.append(f"decode_attention q (4, {h}, {d}) {str(q_dtype)[6:]} "
                     f"vs cache (4, {LONG_LEN}, {g}, {d}) "
                     f"{str(kv_dtype)[6:]}, lengths {lengths.tolist()}: "
                     f"max deviation {dev:.3g}")
    _sync(device)
    return lines


def lm_kernel_rows(cfg, decode_inputs, device) -> list[dict]:
    """Each LM kernel timed at the path's shapes beside its plain version,
    its bound and ``scaled_dot_product_attention`` (the yardstick the port
    never calls): flash at the prefill's bf16 shapes, decode against the
    long run's float32 cache at its first step's lengths."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    b, h, g, d, s = (PREFILL_BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, PREFILL_LEN)
    q, k, v = _attn_inputs(b, h, g, s, d, torch.bfloat16, gen, device)
    err = _check_close("flash_attention", fa.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v), 2e-2)
    rows = [_row("flash_attention", "flash_attention_sm90.cu",
                 "src/repro/kernels/flash_attention.py:70", err,
                 lambda: fa.flash_attention(q, k, v),
                 lambda: ref.flash_attention(q, k, v),
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True, enable_gqa=True),
                 2 * 2 * (b * h + b * g) * s * d,
                 f"q ({b}, {h}, {s}, {d}), k, v ({b}, {g}, {s}, {d}) bf16, "
                 f"causal", flops=2.0 * b * h * s * s * d,
                 peak=BF16_PEAK_FLOPS, agreement="within 2e-2 of its plain "
                 "version")]
    ck, cv, length = decode_inputs
    n = ck.shape[0]
    qd = torch.randn((n, h, d), generator=gen, device=device).to(
        torch.bfloat16)
    lengths = torch.full((n,), length, dtype=torch.int32, device=device)
    err = _check_close("decode_attention",
                       da.decode_attention(qd, ck, cv, lengths),
                       ref.decode_attention(qd, ck, cv, lengths), 2e-2)
    q4 = qd.float()[:, :, None]
    k4, v4 = (t[:, :length].transpose(1, 2) for t in (ck, cv))
    rows.append(_row("decode_attention", "decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:63", err,
                     lambda: da.decode_attention(qd, ck, cv, lengths),
                     lambda: ref.decode_attention(qd, ck, cv, lengths),
                     lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, enable_gqa=True),
                     2 * n * length * g * d * 4 + 2 * n * h * d * 2,
                     f"q ({n}, {h}, {d}) bf16 vs cache ({n}, "
                     f"{ck.shape[1]}, {g}, {d}) f32, lengths {length}",
                     flops=4.0 * n * length * h * d, peak=F32_PEAK_FLOPS,
                     agreement="within 2e-2 of its plain version"))
    return rows


def report_lm(lm: dict) -> None:
    """Print the LM phase's numbers and hold them to their limits."""
    cfg, pre, n = lm["cfg"], lm["prefill"], lm["layers"]
    launches = lm["launches"]
    p50 = float(np.percentile(pre["ms"], 50))
    print(f"LM serving: {cfg.name} at full width ({n} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, "
          f"vocab {cfg.vocab_size}), random weights from seed {SEED}; "
          f"params {lm['sizes']['param_bytes']} bytes, KV caches "
          f"{lm['sizes']['cache_bytes']} bytes, peak device memory "
          f"{lm['sizes'].get('peak_bytes')} bytes", flush=True)
    print(f"  prefill {PREFILL_BATCH} x {PREFILL_LEN} bf16: p50 {p50:.3f} ms "
          f"over {len(pre['ms'])} ({PREFILL_BATCH * PREFILL_LEN / p50 * 1e3:.0f}"
          f" tokens/s); flash_attention launches per forward "
          f"{pre['per_forward']} ({pre['forwards']} forwards on the kernel "
          f"path); logits vs the plain path: float32 max "
          f"deviation {pre['f32_dev']:.3g} (limit {F32_LOGIT_ATOL}), bf16 "
          f"{pre['bf16_dev']:.3g} (limit {BF16_LOGIT_BOUND}); greedy tokens "
          f"agree {pre['f32_agree']:.4f} (f32), {pre['bf16_agree']:.4f} "
          f"(bf16)")
    for label, run in (("launcher's run (max_len 64)", lm["serve"]),
                       (f"long cache (pos {LONG_POS} of {LONG_LEN})",
                        lm["long"])):
        lat = run["lat_ms"]
        print(f"  decode, {label}: {run['steps']} steps, p50 "
              f"{np.percentile(lat, 50):.3f} ms, p99 "
              f"{np.percentile(lat, 99):.3f} ms per step (4 tokens/step: "
              f"{4 / np.percentile(lat, 50) * 1e3:.1f} tokens/s), "
              f"{run['wall_s']:.2f} s with hot swaps; decode_attention "
              f"launches {run['launches']} ({run['launches'] / run['steps']:g}"
              f" per step); teacher-forced logits vs the plain path: max "
              f"deviation {run['max_dev']:.3g} (limit {BF16_LOGIT_BOUND}), "
              f"greedy tokens agree {run['agree']:.4f}", flush=True)
    print(_profile_line(f"bf16 prefill ({PREFILL_BATCH} x {PREFILL_LEN})",
                        pre["profile"]))
    print(_profile_line(f"decode step at length {LONG_POS + LONG_STEPS + 1}",
                        lm["long"]["profile"]))
    print(f"  launches in the LM path: {launches}")
    steps = lm["serve"]["steps"] + lm["long"]["steps"]
    want = {"flash_attention": n * pre["forwards"],
            "decode_attention": n * steps,
            "embedding_lookup": pre["forwards"] + steps}
    if pre["per_forward"] != n or {k: launches[k] for k in want} != want:
        raise AssertionError(f"LM launches {launches}, want {want} and "
                             f"{n} per forward")
    if pre["f32_dev"] > F32_LOGIT_ATOL:
        raise AssertionError(f"float32 prefill logits deviate by "
                             f"{pre['f32_dev']:.3g}")
    worst = max(pre["bf16_dev"], lm["serve"]["max_dev"],
                lm["long"]["max_dev"])
    if worst > BF16_LOGIT_BOUND:
        raise AssertionError(f"bf16 logits deviate by {worst:.3g}")


# ---------------------------------------------------------------------------
# LM training: qwen2-1.5b with Adam, streamed to a serving replica
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS_LM = 4, 1024, 8
# the launcher's flags; the sync clock is the step count (``clock`` below),
# so a period of 5 flushes after step 5 and the final flush follows
TRAIN_ARGV = ("--arch", LM_ARCH, "--steps", str(TRAIN_STEPS_LM), "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--codec", "cast16",
              "--sync-period", "5", "--seed", str(SEED), "--log-every", "4")
SWAP_DECODE_STEPS = 8
STALENESS_BOUND = 2e-3              # the reference's cast16 bound
F32_LOSS_RTOL = 1e-5                # float32 step, kernel vs plain path
# float32 gradients, kernel vs plain path: max |deviation| over the
# largest |gradient| of the leaf; the bound is set in PERF.md before the
# first run
F32_GRAD_BOUND = 1e-3
# (label, leaf path, layer of a stacked leaf)
GRAD_LEAVES = (("embed", "embed", None),
               ("layer 0 wq", "segments/0/pos0/mixer/wq", 0),
               ("last layer w_down", "segments/0/pos0/ffn/w_down", -1))


def _batch_ids(cfg, device):
    """The token ids of one ``lm_batches`` batch as the launcher draws
    them (its bigram structure repeats tokens)."""
    import torch

    from repro_torch.data import lm_batches
    tokens = next(lm_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                             seed=SEED))
    return torch.from_numpy(tokens).to(device)


def zipf_ids(n: int, vocab: int, seed, s: float = 1.0) -> np.ndarray:
    """``n`` token ids from a Zipf law of exponent ``s`` over ``vocab`` ids
    (rank r drawn with weight 1 / r^s, the ranks scattered over the ids):
    the skew of text, where a few ids repeat hundreds of times. ``seed``
    is a seed or a ``np.random.Generator`` to draw from."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** s
    ranks = rng.choice(vocab, size=n, p=p / p.sum())
    return rng.permutation(vocab)[ranks]


def check_scatter_add(cfg, device) -> list[str]:
    """``embedding_scatter_add`` against its plain version, bit-equal, and
    two calls equal, in float32 and bfloat16: on a (vocab, d_model) N(0, 1)
    table with N(0, 1) updates and three id mixes of 4096 ids: one
    batch's token ids, Zipf (s = 1.0) ids over the vocabulary, and 4096
    rows of one id. Each mix is then timed in bf16 (bf16 updates, as the
    embedding gradient has them)."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    ids = _batch_ids(cfg, device).reshape(-1)
    cases = (("one batch's tokens", ids),
             ("Zipf s = 1.0", torch.from_numpy(zipf_ids(
                 ids.shape[0], cfg.vocab_size, SEED)).to(device)),
             (f"{ids.shape[0]} rows of one id", torch.full_like(ids, 7)))
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                            device=device).to(dtype)
        for label, case in cases:
            upd = torch.randn((case.shape[0], cfg.d_model), generator=gen,
                              device=device)
            case32 = case.int()
            got = el.embedding_scatter_add(table.clone(), case32, upd)
            again = el.embedding_scatter_add(table.clone(), case, upd)
            want = ref.embedding_scatter_add(table.clone(), case, upd)
            if not (torch.equal(got, want) and torch.equal(again, got)):
                raise AssertionError(f"embedding_scatter_add {dtype} "
                                     f"({label}): not bit-equal")
            lines.append(f"embedding_scatter_add {tuple(table.shape)} "
                         f"{str(dtype)[6:]}, {case.shape[0]} ids "
                         f"({label}, {int(case.unique().numel())} distinct,"
                         f" longest segment "
                         f"{int(torch.bincount(case).max())}): bit-equal to "
                         f"its plain version, two calls equal")
            if dtype == torch.bfloat16:
                ub = upd.to(dtype)
                ms = _device_ms(lambda: el.embedding_scatter_add(
                    got, case32, ub))
                lines[-1] += f"; {ms:.5f} ms on the device"
            del got, again, want
        del table
    _sync(device)
    return lines


def scatter_add_row(cfg, device) -> dict:
    """``embedding_scatter_add`` timed as the embedding gradient runs it:
    one batch's ids into a zeros (vocab, d_model) bf16 table with bf16
    updates. Bound: the updates and ids read once, each distinct row read
    and written once. Then the call's split: the sort (``sort_ids``) and
    the kernel each timed alone, and one call profiled, which must list
    the sort and the kernel and no gather of the updates."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    ids = _batch_ids(cfg, device).reshape(-1)
    ids32, ids64 = ids.int(), ids.long()
    n, d = ids.shape[0], cfg.d_model
    table = torch.zeros((cfg.padded_vocab, d), dtype=torch.bfloat16,
                        device=device)
    upd = torch.randn((n, d), generator=gen, device=device).bfloat16()
    distinct = int(ids.unique().numel())
    got = el.embedding_scatter_add(table.clone(), ids32, upd)
    want = ref.embedding_scatter_add(table.clone(), ids64, upd)
    if not torch.equal(got, want):
        raise AssertionError("embedding_scatter_add: not bit-equal on the "
                             "timed inputs")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    row = _row("embedding_scatter_add", "embedding_lookup.cu",
               "src/repro/kernels/embedding_lookup.py:79", err,
               lambda: el.embedding_scatter_add(table, ids32, upd),
               lambda: ref.embedding_scatter_add(table, ids64, upd),
               lambda: table.index_add_(0, ids64, upd),
               n * d * 2 + 2 * distinct * d * 2 + n * 4,
               f"{n} ids ({distinct} distinct) x {d} bf16 into "
               f"({cfg.padded_vocab}, {d})")
    sorted_ids, order = el.sort_ids(ids32)
    sort_ms = _device_ms(lambda: el.sort_ids(ids32))
    kernel_ms = _device_ms(lambda: el.scatter_add_sorted(table, sorted_ids,
                                                         order, upd))
    prof = profile_call(lambda: el.embedding_scatter_add(table, ids32, upd),
                        device)
    names = [k for k, _ in prof["entries"]]
    if names and not (any(SCATTER_ADD_KERNEL in k for k in names)
                      and any("sort" in k.lower() for k in names)
                      and not any("gather" in k.lower() for k in names)):
        raise AssertionError(f"embedding_scatter_add: the profiled call is "
                             f"not the sort and {SCATTER_ADD_KERNEL} "
                             f"without a gather: {names}")
    seen = ("not visible to torch.profiler" if not names
            else ", ".join(f"{k[:60]} {ms:.5f}" for k, ms in prof["entries"]))
    print(f"  one call split (device ms, each part alone): the sort "
          f"{sort_ms:.5f} + {SCATTER_ADD_KERNEL} {kernel_ms:.5f}"
          f" (the whole call {row['ms']:.5f}); one call profiled: {seen}",
          flush=True)
    return row


def check_train_f32(cfg, device) -> dict:
    """One float32 train step's loss and gradients at full width from the
    seed, on the kernel path and on the plain path (``plain_attention``),
    each freed before the next: the loss within ``F32_LOSS_RTOL``, the
    ``GRAD_LEAVES`` gradients within ``F32_GRAD_BOUND`` of their largest
    magnitude."""
    import torch

    from repro_torch.core import tree
    from repro_torch.models import init_params
    from repro_torch.training import loss_and_grads
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = init_params(cfg32, torch.Generator(device=device).manual_seed(
        SEED))
    batch = {"tokens": _batch_ids(cfg, device)}
    out = {}
    for path in ("kernel", "plain"):
        with (plain_attention() if path == "plain"
              else contextlib.nullcontext()):
            loss, _, grads = loss_and_grads(params, cfg32, batch)
        flat = dict(tree.flatten_with_paths(grads))
        out[path] = (float(loss), {
            label: (flat[leaf] if layer is None else flat[leaf][layer]).clone()
            for label, leaf, layer in GRAD_LEAVES})
        del grads, flat
        _sync(device)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    devs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max())
            for k in gk}
    if abs(lk - lp) > F32_LOSS_RTOL * abs(lp):
        raise AssertionError(f"float32 loss {lk} vs plain {lp}")
    if max(devs.values()) > F32_GRAD_BOUND:
        raise AssertionError(f"float32 grads deviate: {devs}")
    return {"loss": lk, "plain_loss": lp, "grad_devs": devs}


def model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + backward, remat's
    recompute not counted): 6 per token per matmul parameter (the tied
    head included; the embedding gather does none) and causal attention's
    two products, 2 * B * H * S^2 * hd a layer forward, 3x in training."""
    d, f = cfg.d_model, cfg.d_ff
    h, g, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = 2 * d * h * hd + 2 * d * g * hd + 3 * d * f
    matmul = cfg.num_layers * per_layer + cfg.padded_vocab * d
    attn = cfg.num_layers * 6.0 * batch * h * seq * seq * hd
    return 6.0 * batch * seq * matmul + attn


INT8_STALENESS_BOUND = 2e-2         # the reference's int8 bound


def int8_flush(cfg, initial: dict, params: dict, device) -> dict:
    """The trained ``params`` streamed once through a ``ModelSyncEngine``
    with the int8 codec on ``device`` (``--codec int8``; every leaf ONE
    codec row) to one replica that starts from ``initial``: a
    ``collect_step`` bumps every leaf's version, one flush pushes them
    all. Returns the flush's time, records and bytes, the codec's launches
    in it and the launches its plans want, the replica's staleness before
    and after, and whether the largest leaf's codes and scale equal the
    plain version's on ``device``."""
    import torch

    from repro_torch.core import tree
    from repro_torch.core.sync_engine import ModelSyncEngine, SyncConfig
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    engine = ModelSyncEngine(cfg, initial, SyncConfig(
        gather_mode="period", period=1.0, codec="int8",
        codec_backend="torch", device=device.type))
    before = engine.replicas[0].staleness(params)
    engine.collect_step(np.zeros((1, 1), np.int64))
    ops.reset_launches()
    flush = train._tick(engine, params, 1e9)
    launches = ops.launch_counts()
    leaves = tree.flatten_with_paths(params)
    path, leaf = max(leaves, key=lambda e: e[1].numel())
    rec = next(r for p in range(engine.queue.num_partitions)
               for r in engine.queue.consume(p, 0)[0]
               if r.meta["path"] == path)
    pq, ps = ref.quantize_rows(leaf.detach().float().reshape(1, -1))
    equal = (torch.equal(torch.from_numpy(rec.payload["q"]).to(device), pq)
             and torch.equal(torch.from_numpy(rec.payload["scale"])
                             .to(device), ps))
    del pq, ps, rec
    return {**flush, "launches": launches,
            "want": {"quantize_rows": sum(
                dc.codec_plan(t.numel()).quantize_launches
                for _, t in leaves), "dequantize_rows": flush["records"]},
            "staleness_before": before,
            "staleness": engine.replicas[0].staleness(params),
            "largest": (path, leaf.numel()), "largest_equal": equal}


def drive_lm_train(device, train_argv, *, decode_steps: int) -> dict:
    """LM training through its entry points: ``launch.train`` builds the
    state, step and ``ModelSyncEngine`` from ``train_argv`` and runs
    them (the sync clock counting steps), with the launch counters reset
    before and read after; then a ``ServeDriver`` started on the initial
    params decodes, hot-swaps in the replica's ``device_params`` and
    decodes ``decode_steps`` more, counted on their own."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.serving.predictor import ServeDriver
    args = train.parse_args([*train_argv, "--device", device.type])
    cfg, state, step_fn, engine, batches = train.build(args)
    initial = _tree_map(lambda t: t.detach().clone(), state.params)
    driver = ServeDriver(cfg=cfg, params=initial, batch=TRAIN_BATCH,
                         max_len=64, cache_dtype=torch.float32,
                         device=device)
    logits: list = []
    driver.step_fn = _recording(driver.step_fn, logits)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, rec = train.run(args, cfg, state, step_fn, engine, batches,
                           clock=lambda i: float(i + 1))
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    if device.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    tok = torch.zeros((TRAIN_BATCH, 1), dtype=torch.int32, device=device)
    for _ in range(4):                        # serving before the swap
        tok = driver.step(tok)
    ops.reset_launches()
    t = time.perf_counter()
    driver.hot_swap(engine.replicas[0].device_params(cfg.param_dtype,
                                                     device=device))
    swap_s = time.perf_counter() - t
    for _ in range(decode_steps):
        tok = driver.step(tok)
    _sync(device)
    swapped = torch.stack([lg for *_, lg in logits[-decode_steps:]])
    rec["decode"] = {"launches": ops.launch_counts(), "steps": decode_steps,
                     "swap_s": swap_s,
                     "finite": bool(torch.isfinite(
                         swapped[..., :cfg.vocab_size]).all())}
    rec["metrics"] = engine.metrics()
    rec["int8"] = int8_flush(cfg, initial, state.params, device)
    # one more train step, profiled (after every count and comparison)
    batch = {"tokens": torch.from_numpy(next(batches)).to(device)}
    rec["profile"] = profile_call(lambda: step_fn(state, batch), device)
    return {"cfg": cfg, "args": args, "run": rec}


def report_lm_train(lm: dict, f32: dict) -> None:
    """Print the LM-training phase's numbers and hold them to their
    limits."""
    cfg, args, rec = lm["cfg"], lm["args"], lm["run"]
    n, steps = cfg.num_layers, args.steps
    step_ms = np.array(rec["step_s"]) * 1e3
    p50 = float(np.percentile(step_ms, 50))
    tokens = args.batch * args.seq
    flops = model_flops(cfg, args.batch, args.seq)
    print(f"LM training: {cfg.name} ({n} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}), random "
          f"weights from seed {SEED}; launcher {' '.join(TRAIN_ARGV)}, sync clock = steps",
          flush=True)
    print(f"  float32 step, kernel vs plain path: loss {f32['loss']:.6f} vs "
          f"{f32['plain_loss']:.6f} (limit rtol {F32_LOSS_RTOL}); grads max "
          f"|deviation| / max |grad|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in f32["grad_devs"].items())
          + f" (limit {F32_GRAD_BOUND})")
    print(f"  {steps} steps of {args.batch} x {args.seq}: step p50 "
          f"{p50:.3f} ms, p99 {np.percentile(step_ms, 99):.3f} ms "
          f"(first {step_ms[0]:.3f}); {tokens / p50 * 1e3:.0f} tokens/s; "
          f"model FLOPs {flops:.4g} a step, mfu {flops / (p50 / 1e3) / BF16_PEAK_FLOPS:.4f}"
          f" (of {BF16_PEAK_FLOPS:.4g}); loss {rec['losses'][0]:.4f} -> "
          f"{rec['losses'][-1]:.4f}; peak device memory "
          f"{rec.get('peak_bytes')} bytes; {rec['wall_s']:.1f} s in all",
          flush=True)
    for i, fl in enumerate(rec["flushes"]):
        print(f"  flush {i}: {fl['s']:.3f} s, {fl['records']} records, "
              f"{fl['bytes']} bytes")
    print(f"  sync {rec['metrics']}; replica staleness vs the trained "
          f"params {rec['staleness']:.3g} (limit {STALENESS_BOUND})")
    i8 = rec["int8"]
    print(f"  int8 flush (--codec int8, every leaf one codec row, from the "
          f"initial params' replica): {i8['s']:.3f} s, {i8['records']} "
          f"records, {i8['bytes']} bytes (the cast16 flushes above: "
          + ", ".join(f"{fl['s']:.3f} s" for fl in rec["flushes"])
          + f"); launches quantize_rows {i8['launches']['quantize_rows']}, "
          f"dequantize_rows {i8['launches']['dequantize_rows']} (the plans "
          f"want {i8['want']}); replica staleness vs the trained params "
          f"{i8['staleness_before']:.3g} -> {i8['staleness']:.3g} (limit "
          f"{INT8_STALENESS_BOUND}); largest leaf {i8['largest'][0]} "
          f"({i8['largest'][1]} elements) codes and scale equal to the plain "
          f"version's: {i8['largest_equal']}", flush=True)
    dec = rec["decode"]
    print(f"  hot swap of the replica's bf16 device params in "
          f"{dec['swap_s']:.3f} s, then {dec['steps']} decode steps: logits "
          f"finite {dec['finite']}; launches {dec['launches']}")
    print(_profile_line("train step", rec["profile"]))
    print(f"  launches in the training run: {rec['launches']}")
    want = {"embedding_scatter_add": steps, "embedding_lookup": steps,
            "flash_attention": 2 * n * steps}
    if {k: rec["launches"][k] for k in want} != want:
        raise AssertionError(f"training launches {rec['launches']}, want "
                             f"{want}")
    want_dec = {"decode_attention": n * dec["steps"],
                "embedding_lookup": dec["steps"]}
    if {k: dec["launches"][k] for k in want_dec} != want_dec:
        raise AssertionError(f"decode launches {dec['launches']}, want "
                             f"{want_dec}")
    if len(rec["flushes"]) < 2:
        raise AssertionError(f"{len(rec['flushes'])} flushes: want a "
                             f"periodic one before the final one")
    if not rec["staleness"] < STALENESS_BOUND:
        raise AssertionError(f"replica staleness {rec['staleness']}")
    if {k: i8["launches"][k] for k in i8["want"]} != i8["want"]:
        raise AssertionError(f"int8 flush launches {i8['launches']}, want "
                             f"{i8['want']}")
    if not (i8["staleness"] < INT8_STALENESS_BOUND and i8["largest_equal"]):
        raise AssertionError(f"int8 flush: staleness {i8['staleness']}, "
                             f"largest leaf equal {i8['largest_equal']}")
    if not (dec["finite"] and np.isfinite(rec["losses"]).all()):
        raise AssertionError("non-finite losses or decode logits")


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
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if ("registers" in line or "spill" in line
                    or (src in PTXAS_FULL and "ptxas" in line)):
                print(f"  ptxas {src}: {line.strip()}")
    counts = sass_counts("flash_attention_sm90")
    print(f"SASS of flash_attention_sm90 (cuobjdump -sass): "
          + ", ".join(f"{k} {n}" for k, n in counts.items()), flush=True)
    if not all(counts.values()):
        raise AssertionError(f"bf16 flash_attention has no tensor-core or "
                             f"TMA instructions: {counts}")

    rng = np.random.default_rng(SEED)
    kernels = phase_kernels(dev, rng)

    from repro_torch.configs.weips_ctr import FM_FTRL
    t = time.perf_counter()
    out = drive_loop(dev, feature_space=FM_FTRL.feature_space,
                     batch=REQ_BATCH, fields=FM_FTRL.fields,
                     warm_batches=WARM_BATCHES, warm_reps=WARM_REPS,
                     partial_rounds=PARTIAL_ROUNDS, train_steps=TRAIN_STEPS)
    res, tr, boot = out["serve"], out["train"], out["boot"]
    print(f"loop: FM_FTRL fields={FM_FTRL.fields} embed_dim="
          f"{FM_FTRL.embed_dim} feature_space={FM_FTRL.feature_space} "
          f"hashed ids, 4 masters, 2 slave shards x 2 replicas, int8 codec, "
          f"in {time.perf_counter() - t:.1f} s (state load "
          f"{out['load_s']:.1f} s for both paths)", flush=True)
    print(f"  bootstrap flush: {boot['records']} records, {boot['bytes']} "
          f"bytes, {boot['s']:.2f} s on the card's path, {boot['host_s']:.2f}"
          f" s on the host path; launches {boot['launches']}")
    print(f"serving over the streamed replicas: {res['requests']} requests; "
          f"served rows bit-equal to the host path, max prediction "
          f"deviation {res['max_pred_dev']:.3g}", flush=True)
    for label, v in res["latency_ms"].items():
        counts = sorted(set(res["launches_per_predict"][label]))
        print(f"  predict {label:>12}: p50 {np.percentile(v, 50):.3f} ms, "
              f"p99 {np.percentile(v, 99):.3f} ms over {len(v)}; launches "
              f"per predict ({', '.join(ops.KERNELS)}) {counts}")
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
    print(f"  launches in the serving predicts: {res['launches']}")
    missing = [k for k in SERVE_KERNELS if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the serving "
                             f"predicts: {missing}")
    if res["placements"] != {"vmem", "hbm"}:
        raise AssertionError(f"placements taken: {res['placements']}")

    cmp, m = out["compared"], tr["metrics"]
    print(f"train -> sync -> serve: {len(tr['train_ms'])} steps of "
          f"{REQ_BATCH} x {FM_FTRL.fields} ids; logloss {m[0]['logloss']:.4f}"
          f" -> {m[-1]['logloss']:.4f}; per-batch dedup ratio "
          f"{tr['dedup_ratio']:.4f}, gather dedup ratio "
          f"{tr['gather_dedup']:.4f}; pushed {tr['pushed_records']} records, "
          f"{tr['pushed_bytes']} bytes", flush=True)
    for what, v in (("train step", tr["train_ms"]),
                    ("sync tick", tr["tick_ms"])):
        print(f"  {what:>10}: p50 {np.percentile(v, 50):.3f} ms, p99 "
              f"{np.percentile(v, 99):.3f} ms over the {len(v)} unprofiled "
              f"steps")
    print(f"  event -> deployed staleness (scatter ring: train step's end "
          f"to the start of each replica's poll): p50 "
          f"{tr['staleness_ms']['p50']:.3f} ms, p99 "
          f"{tr['staleness_ms']['p99']:.3f} ms")
    prof = tr["profile"]
    busy = "not visible to torch.profiler" if prof["busy_ms"] is None \
        else (f"{prof['busy_ms']:.3f} ms "
              f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}% busy)")
    print(f"  profiled last step: train {prof['train_ms']:.3f} ms + tick "
          f"{prof['tick_ms']:.3f} ms, device {busy}; host time by function "
          f"(own ms): " + ", ".join(f"{k} {ms:.2f}" for k, ms in prof["top"]))
    for label, v in tr["predict_ms"].items():
        print(f"  predict {label:>16}: p50 {np.percentile(v, 50):.3f} ms "
              f"over {len(v)}")
    print(f"  launches in train -> sync -> serve: {tr['launches']}")
    missing = [k for k in TRAIN_KERNELS if tr["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in train -> sync -> "
                             f"serve: {missing}")
    print(f"  host path replayed the card's {len(tr['log'])} pushes in "
          f"{out['host_train_s']:.1f} s: {cmp['master_rows']} master rows "
          f"(w, z, n), {cmp['records']} queue records, every replica row and "
          f"the served rows bit-equal; max prediction deviation "
          f"{cmp['max_pred_dev']:.3g}; loss and row grads vs the CPU: max "
          f"deviation {out['loss_dev']:.3g}", flush=True)

    # launches on every path, each read after its own reset
    paths = {"serving predicts": res["launches"],
             "bootstrap flush": boot["launches"],
             "train -> sync -> serve": tr["launches"]}
    probes = res.pop("probe_inputs")
    kernels = [probe_row(k, *probes[k]) for k in PROBES] + kernels
    by_name = {row["name"]: row for row in kernels}
    # the hbm probe's other inputs ride on its entry: the result line keeps
    # one entry a kernel, timed on the replica's cold-request ids
    by_name["hashmap_probe_hbm"]["l2_cold"] = cold_probe_line(
        *probes["hashmap_probe_hbm"])
    del probes
    for row in kernels:
        row["launches"] = res["launches"][row["name"]]
    inputs = out.pop("train_inputs")
    name, probe = inputs.pop("probe")
    push = probe_row(name, *probe)
    by_name[name]["master_push"] = {
        k: push[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                             "max_abs_err")}
    del probe, push
    new_rows = train_kernel_rows(inputs, out["ftrl_kw"])
    for row in new_rows:
        row["launches"] = tr["launches"][row["name"]]
    kernels += new_rows
    print("codec kernels beyond the path's own shapes:", flush=True)
    check_codec_special(dev)
    codec_shape_lines(dev)
    del out
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths["cluster"] = run_cluster_phase()
    print(f"cluster phase in {time.perf_counter() - t:.1f} s (a child "
          f"process)", flush=True)
    t = time.perf_counter()
    paths["runtime"] = run_runtime_phase()
    print(f"runtime phase in {time.perf_counter() - t:.1f} s (a child "
          f"process and its workers)", flush=True)
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    lm_cfg = get_config(LM_ARCH)
    print(f"LM kernels against their plain versions at {LM_ARCH}'s shapes:",
          flush=True)
    for line in check_lm_kernels(lm_cfg, dev):
        print(f"  {line}")
    lm = drive_lm(dev, SERVE_ARGV, prefill_batch=PREFILL_BATCH,
                  prefill_len=PREFILL_LEN, prefill_reps=PREFILL_REPS,
                  long_len=LONG_LEN, long_pos=LONG_POS,
                  long_steps=LONG_STEPS)
    report_lm(lm)
    lm_rows = lm_kernel_rows(lm["cfg"], lm.pop("decode_inputs"), dev)
    for row in lm_rows:
        row["launches"] = lm["launches"][row["name"]]
    kernels += lm_rows
    paths["LM serving"] = lm["launches"]
    print(f"LM phase in {time.perf_counter() - t:.1f} s", flush=True)
    del lm, lm_rows
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print(f"LM training kernel against its plain version at {LM_ARCH}'s "
          f"shapes:", flush=True)
    for line in check_scatter_add(lm_cfg, dev):
        print(f"  {line}")
    # timed and profiled before the training run's own profile, after
    # which torch.profiler has listed no kernel of a later call
    row = scatter_add_row(lm_cfg, dev)
    f32 = check_train_f32(lm_cfg, dev)
    torch.cuda.empty_cache()
    lm_train = drive_lm_train(dev, TRAIN_ARGV,
                              decode_steps=SWAP_DECODE_STEPS)
    report_lm_train(lm_train, f32)
    row["launches"] = lm_train["run"]["launches"]["embedding_scatter_add"]
    kernels.append(row)
    paths["LM training run"] = lm_train["run"]["launches"]
    paths["LM hot-swap decode"] = lm_train["run"]["decode"]["launches"]
    del lm_train
    print(f"LM training phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name in PATH_KERNELS:
        counts = {path: c[name] for path, c in paths.items()}
        print(f"launches of {name} by path: "
              + ", ".join(f"{p} {c}" for p, c in counts.items())
              + f"; {sum(counts.values())} in all")
        for row in kernels:
            if row["name"] == name:
                row["launches"] = sum(counts.values())
    print("kernels: " + ", ".join(ops.KERNELS) + " (launches: the probes', "
          "the gather's, the scatter-set's, ftrl_row_update's and the "
          "codec's summed over every path above, ftrl_row_update's all "
          "ftrl_apply_slots, whose rows ride on its entry; the attention "
          "kernels' from the LM serving path, the scatter-add's from the LM "
          "training run)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--cluster-phase":
        sys.exit(cluster_child(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--runtime-phase":
        sys.exit(runtime_child(sys.argv[2]))
    sys.exit(main())
