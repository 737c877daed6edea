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
fault-free run; then serves qwen2-1.5b, the MoE granite-moe-3b-a800m,
the attention-free mamba2-1.3b and the sliding-window gemma3-4b at full
width (prefill and greedy decode with hot weight swaps) and checks each
against the same model on the plain path; then trains all four at full
width with Adam, streams them to a serving replica (the MoE's experts by
(repeat, expert) id) and hot-swaps the replica's params into a decoding
driver.

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
   Then the dropless MoE layer's grouped expert products
   (``torch._grouped_mm``) at the granite-4.0-h-small training cell's
   shapes against a float32 loop (``grouped_expert_line``), and
   ``decode_attention`` at the qwen2-1.5b decode cell's shape (bf16 q
   and cache, B 128, S 16,384, lengths 6,145-12,241): the tensor-core
   kernel within one bf16 ulp of its plain version (a planted fault, one
   cache row left out at a split boundary, fails that check), timed
   beside the CUDA-core kernel on the same cache (an fp32 query), the
   bound from the live rows, the plain version and SDPA
   (``decode_cell_line``).
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
6b. MoE serving, granite-moe-3b-a800m at full width (32 layers,
   d_model 1536, 24 / 8 heads of 64, 40 experts of d_ff 512, top-8;
   random weights from the seed), after printing the host's available
   memory. First both attentions against their plain versions at its
   shapes (q (4, 24, 2048, 64) causal in bf16 and f32, a ragged S =
   1000, a full case; decode q (4, 24, 64) against a (4, 4096, 8, 64)
   cache, lengths 1..4096; 2e-5 f32, 2e-2 bf16), and the MoE's two row
   gathers at 4 x 2048 tokens (the dispatch's E * C rows through the
   inverse slot map, the combine's T * k rows), bit-equal to their plain
   versions and timed (extra entries of the gather's JSON row). Then
   phase 6's path through ``launch.serve --arch granite-moe-3b-a800m``:
   prefill 4 x 2048 in float32 and bf16, the launcher's own run (batch
   4, 32 steps, a hot swap every 8) and a decode against a cache seeded
   to 4000 of 4096. Every layer's routes are recorded on both paths
   (``record_routes``): a token whose experts differ first flips where
   the plain path's k-th and (k+1)-th probabilities nearly tie; in
   float32 every such first flip must lie under ``NEAR_TIE`` (1e-5, each
   printed), and the logit bounds (float32 1e-3, bf16
   ``BF16_LOGIT_BOUND``) hold on the tokens whose routes agree in every
   layer (how many, and the share of assignments that differ, printed).
   Launches, each held exactly: ``flash_attention`` 32 a forward,
   ``decode_attention`` 32 a step, ``embedding_lookup`` 65 a forward
   and a step (the token gather and each layer's two MoE gathers). One
   bf16 forward with stream stamps around ``moe_ffn`` and its parts
   prints the MoE's share of the stream time (routing, the dispatch,
   the combine, the expert products) and layer 0's expert counts.
6c. SSM serving, mamba2-1.3b at full width (48 Mamba-2 layers, d_model
   2048, 64 heads of 64, state 128, chunk 256, no attention, no FFN;
   random weights from seed 0). The token gather at its shape (8,192
   ids x 2,048 bf16 from the 50,432-row table) bit-equal to its plain
   version, timed beside its bound and ``index_select``;
   ``ssd_chunked`` against ``ssd_decode_step`` in a loop at its heads
   (1 x 2048 tokens, float32, dt ≈ 1), forward and the gradients of x,
   dt, B and C finite and within ``SSD_REC_BOUND`` (2e-4) of the largest
   magnitude. Then, with the counters reset before and read after:
   ``make_prefill_step`` on 4 x 2048 tokens in float32 and bf16 against
   the plain path (bf16 timed, one forward with stream stamps around the
   Mamba parts); ``launch.serve``'s own run (batch 4, 32 steps, float32
   cache with bf16 params, a hot swap every 8) replayed on the plain
   path, logits finite; decode against forward over 64 tokens from a
   fresh cache in float32 and in bf16 (params and cache), each path also
   against a float64 forward: float32 within ``F32_LOGIT_ATOL``, the
   bf16 decode within ``BF16_DECODE_RATIO`` times the bf16 forward's own
   deviation (greedy agreement printed). Launches held exactly:
   ``embedding_lookup`` once a forward and a step, the attention kernels
   never. Prefill p50 and tokens/s, decode p50 / p99, the params' and
   the SSM cache's bytes and the peak memory are printed.
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
7b. MoE training, granite-moe-3b-a800m at full width (bf16, Adam,
   remat). One float32 train step against the plain path at full width
   and 4 of the 32 layers (the cut: two float32 gradient sets of the
   whole model do not fit beside each other), without remat: routes
   equal (near ties as in 6b), loss within ``F32_LOSS_RTOL``, the embed,
   layer-0 router and ``w_gate`` and last-layer ``w_down`` gradients
   within ``F32_GRAD_BOUND``. Then ``launch.train``'s own run
   (``MOE_TRAIN_ARGV``: 4 steps of 4 x 1024, cast16, a sync period of 3
   on the step clock, so one periodic flush and the final one): the
   three stacked expert leaves classified ``"experts"``, each (32, 40,
   ...) or 1,280 (repeat, expert) ids, the router ``"dense"``; each
   flush's expert records hold exactly the pairs the steps' counts
   routed to, cumulated (Adam); staleness under 2e-3; launches a step
   ``embedding_scatter_add`` 65 (the embedding and the MoE gathers'
   gradients), ``embedding_lookup`` 129 (remat recomputes the MoE
   gathers), ``flash_attention`` 64. Step p50, tokens/s, ``mfu`` on
   active-parameter FLOPs, peak memory, each flush's time, records and
   bytes and the share of experts dirty are printed. Then phase 7's int8
   flush (every (repeat, expert) id a codec row) and hot-swap decode.
7c. SSM training, mamba2-1.3b at full width (bf16, Adam, remat). The
   scatter-add timed at its shape (one batch's 4 x 1024 ids x 2,048
   bf16); one float32 train step against the plain path at all 48
   layers with remat (no cut: one float32 gradient set fits beside the
   params): loss within ``F32_LOSS_RTOL``, the embed, layer-0 ``wx`` and
   ``dt_bias`` and last-layer ``out_proj`` gradients within
   ``F32_GRAD_BOUND``, every gradient leaf finite. Then
   ``launch.train``'s own run (``SSM_TRAIN_ARGV``: 4 steps of 4 x 1024,
   cast16, a sync period of 3 on the step clock): launches a step
   ``embedding_lookup`` 1, ``embedding_scatter_add`` 1,
   ``flash_attention`` 0; staleness under 2e-3; ``mfu`` on model FLOPs
   that count the SSD's four products. Then phase 7's int8 flush and
   hot-swap decode (the replica's bf16 params against a float32 cache).
6d. Sliding-window serving, gemma3-4b at full width (34 layers: five
   6-layer periods of five sliding-window layers (W 1,024) and a global
   one, then 4 windowed layers; d_model 2,560, 8 / 4 heads of 256, d_ff
   10,240, a tied 262,144-row table; random weights from the seed),
   after printing the host's available memory. First the attentions at
   its shapes as in phase 6 (flash q (4, 8, 2048, 256) causal in bf16
   and f32, a ragged S = 1000, a full case; decode against a (4, 4096,
   4, 256) cache at mixed lengths), then ``decode_attention`` on a
   (4, 1024, 4, 256) ring at lengths ``min(pos + 1, 1024)`` for
   positions before, across and two wraps past the first wrap
   (``RING_POSITIONS``), within 2e-5 (f32) and 2e-2 (bf16); the token
   gather (8,192 ids x 2,560 bf16) bit-equal and timed; one windowed
   layer's ``self_attention`` on 1 x 2048 tokens in float32 (the
   block-local branch) against a float64 masked-softmax oracle within
   ``WINDOW_ORACLE_BOUND`` (1e-5) of the largest magnitude. Then phase
   6's path through ``launch.serve --arch gemma3-4b``: prefill 4 x 2048
   (the 29 windowed layers block-local in tensor ops, the 5 global ones
   through flash), the launcher's own run and a decode against a cache
   seeded to 4000 of 4096 (the rings wholly; decode writes slots
   928-959), each against the plain path; then decode against forward
   over 64 tokens with the window cut to ``GEMMA_CHECK_WINDOW`` (16: the
   forward block-local, each ring written four times over): float64
   within ``F64_DECODE_ATOL``, float32 and bf16 printed beside the
   float64 forward. Launches held exactly: ``flash_attention`` 5 a
   2048-token forward (and 5 a 64-token one), ``decode_attention`` 34 a
   step, ``embedding_lookup`` 1 a forward and a step. Prefill p50 and
   tokens/s, decode p50 / p99, the params' bytes, the global caches'
   and the rings' bytes and the peak memory (the float64 check's apart)
   are printed; flash, both decodes (the global cache at 4,001 and a
   ring at 1,024) are timed beside their bounds, plain versions and
   SDPA (entries of their JSON rows).
7d. Sliding-window training, gemma3-4b at full width (bf16, Adam,
   remat). The scatter-add at its shape (4,096 ids x 2,560 bf16)
   bit-equal and timed; one float32 train step against the plain path
   at all 34 layers with remat (its peak printed), the embed, layer-0
   ``wq`` and last-layer ``w_down`` gradients within ``F32_GRAD_BOUND``;
   ``launch.train``'s own run (``GEMMA_TRAIN_ARGV``: 4 steps of 4 x
   1024, cast16, a sync period of 3 on the step clock; at S = 1024 = W
   every windowed layer's window is void, so all 34 go through flash):
   launches a step ``embedding_lookup`` 1, ``embedding_scatter_add`` 1,
   ``flash_attention`` 68 (34 and 34 in remat's recompute); staleness
   under 2e-3. Then phase 7's int8 flush (the tied table one codec row
   of 671,088,640 floats) and hot-swap decode, 34 ``decode_attention``
   launches a step.
8. The launches of both probes, the gather, the scatter-set,
   ``ftrl_row_update`` and the codec on every path above (serving
   predicts, bootstrap flush, train -> sync -> serve, the cluster, the
   runtime's workers, LM serving, the LM training run and its hot-swap
   decode), each read
   after its own reset, granite's paths among them. A train push is the
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
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's figures, held in one place (H100 SXM5 80 GB datasheet)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_PEAK_FLOPS  # noqa: E402,E501
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as F32_PEAK_FLOPS  # noqa: E402,E501

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
TRAIN_KERNELS = ("ftrl_row_update", "quantize_rows", "dequantize_rows")
# sources whose whole ptxas report is printed (the redesigned attention)
PTXAS_FULL = ("flash_attention_sm90", "decode_attention")
# the attention kernels' symbols, whose device time each profile sums
ATTENTION_KERNELS = ("flash_attention_sm90_kernel", "flash_attention_kernel",
                     "decode_attention_kernel", "decode_attention_mma_kernel")
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
    grouped_expert_line(dev)
    decode_cell_line(dev)
    return rows


# A bf16 output against its plain version: both are float32 sums that
# agree to ~1e-6 of the largest term, each rounded to bf16 once, so they
# lie at most one bf16 ulp apart (2^-7 of |want| at most), plus 1e-5 for
# outputs near zero, whose ulps are finer than the sums' drift. At the
# decode cell's shape a typical output is ~0.017 and a cache row weighs
# ~1e-4 of it: a kernel that leaves out one row moves hundreds of outputs
# past this, where it stays inside a flat 2e-2.
BF16_ULP_RTOL, BF16_ULP_ATOL = 2 ** -7, 1e-5


def bf16_ulp_excess(got, want) -> float:
    """The largest ``|got - want| - (ATOL + RTOL |want|)``: > 0 fails."""
    want = want.float()
    return float(((got.float() - want).abs() - BF16_ULP_ATOL
                  - BF16_ULP_RTOL * want.abs()).max())


def plain_decode_without_row(q, k, v, lengths, i: int, r: int):
    """The plain ``decode_attention`` of sequence ``i`` with its cache row
    ``r`` left out: what a kernel that skips that row gives."""
    import torch

    from repro_torch.kernels import ref
    k1, v1 = (torch.cat([t[i:i + 1, :r], t[i:i + 1, r + 1:]], 1)
              for t in (k, v))
    return ref.decode_attention(q[i:i + 1], k1, v1, lengths[i:i + 1] - 1)


def decode_cell_line(dev) -> dict:
    """``decode_attention`` at the qwen2-1.5b decode cell's shape: q (128,
    12, 128) against a (128, 16,384, 2, 128) cache, both bf16, at the
    cell's first lengths (6,145-12,241, evenly spaced), on the
    tensor-core kernel, within one bf16 ulp of its plain version, where
    the plain version of the longest sequence with the last row of a
    split, or the first of the next, left out (a planted fault: a typical
    output is ~0.017 and a row weighs ~1e-4 of it) must fail; timed beside
    its bound (the live K and V rows, q and the output, over the memory
    rate), the plain version, SDPA over the valid rows (a boolean mask;
    the port never calls it) and the CUDA-core kernel on the same cache
    (an fp32 query: the pair that keeps that kernel, with the same cache
    bytes and inner loop as the bf16 query had there)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, h, g, d, s = 128, 12, 2, 128, 16384
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, g, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    n = 6144 + 6144 * np.arange(b) // b + 1
    lengths = torch.tensor(n, dtype=torch.int32, device=dev)
    before = da.decode_attention.tensor_core_launches
    got = da.decode_attention(q, k, v, lengths)
    if da.decode_attention.tensor_core_launches != before + 1:
        raise AssertionError("bf16 decode_attention did not take the "
                             "tensor-core kernel")
    want = ref.decode_attention(q, k, v, lengths)
    err = float((got.float() - want.float()).abs().max())
    if bf16_ulp_excess(got, want) > 0:
        raise AssertionError(f"decode_attention: deviates from its plain "
                             f"version by {err:.3g}, over one bf16 ulp")
    i, (_, rows) = int(n.argmax()), da.mma_split_plan(s, b, g)
    for r in (rows - 1, rows):
        fault = plain_decode_without_row(q, k, v, lengths, i, r)
        if bf16_ulp_excess(fault, want[i:i + 1]) <= 0:
            raise AssertionError(f"decode_attention's check passes the "
                                 f"plain version without row {r}")
    del got, want, fault
    q4, top = q[:, :, None], int(n.max())
    k4, v4 = (t[:, :top].transpose(1, 2) for t in (k, v))
    mask = (torch.arange(top, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    row = _row("decode_attention", "decode_attention.cu",
               "src/repro/kernels/decode_attention.py:63", err,
               lambda: da.decode_attention(q, k, v, lengths),
               lambda: ref.decode_attention(q, k, v, lengths),
               lambda: F.scaled_dot_product_attention(
                   q4, k4, v4, attn_mask=mask, enable_gqa=True),
               int(n.sum()) * 2 * g * d * 2 + 2 * b * h * d * 2,
               f"q ({b}, {h}, {d}) vs cache ({b}, {s}, {g}, {d}), both "
               f"bf16, lengths {n.min()}-{n.max()} (the decode cell's)",
               agreement="within one bf16 ulp of its plain version, which "
                         "a row left out at a split boundary is not")
    qf = q.float()
    row["cuda_core_ms"] = _device_ms(
        lambda: da.decode_attention(qf, k, v, lengths))
    print(f"kernel decode_attention, the CUDA-core kernel on the same cache "
          f"(fp32 q): {row['cuda_core_ms']:.5f} ms on the device, against "
          f"the tensor-core kernel's {row['ms']:.5f}", flush=True)
    return row


def grouped_expert_line(dev, rel_tol: float = 1e-2) -> dict:
    """The dropless MoE layer's grouped expert products
    (``models/moe._grouped``, one ``torch._grouped_mm`` a weight) at the
    granite-4.0-h-small training cell's shapes: 16,384 tokens routed
    top-10 over 72 experts, the 9 held experts' rows (~20,000) at the
    head of a 147,456-row buffer, 4,096 -> 768 bf16. The forward, the
    input gradient (against the weights' transpose) and the weight
    gradient, each against a float32 loop over the segments within
    ``rel_tol`` of its largest value (bf16 rounds the output once; a
    wrong segment or expert misses by the whole value), and the two
    gradients equal to what autograd gives. The buffer's rows past the
    held segments are NaN, so a product that read them would fail. Each
    timed beside its least time (the operations at the bf16 peak, or
    the bytes); the products are the library's, so the library time is
    the time."""
    import torch

    from repro_torch.models import moe
    g = torch.Generator(device=dev).manual_seed(SEED)
    t, k, experts, held, d, f = 16384, 10, 72, 9, 4096, 768
    logits = torch.randn((t, experts), generator=g, device=dev)
    idx = logits.topk(k, dim=-1).indices.reshape(-1)
    bounds = torch.searchsorted(torch.sort(idx).values, torch.arange(
        held + 1, device=dev)).to(torch.int32)
    rows, ends = t * min(k, held), bounds.tolist()
    n = ends[-1]
    a = torch.randn((rows, d), generator=g, device=dev).bfloat16()
    dy = torch.randn((rows, f), generator=g, device=dev).bfloat16()
    a[n:], dy[n:] = float("nan"), float("nan")
    w = (torch.randn((held, d, f), generator=g, device=dev)
         * d ** -0.5).bfloat16()
    wt = w.transpose(1, 2)

    def plain(x, wx):
        out = torch.zeros((n, wx.shape[-1]), device=dev)
        for e in range(held):
            lo, hi = ends[e], ends[e + 1]
            out[lo:hi] = x[lo:hi].float() @ wx[e].float()
        return out

    def plain_wgrad():
        return torch.stack([a[lo:hi].float().T @ dy[lo:hi].float()
                            for lo, hi in zip(ends[:-1], ends[1:])])

    cases = {"forward": (lambda: moe._grouped(a, w, bounds),
                         lambda: plain(a, w)),
             "input_grad": (lambda: moe._grouped(dy, wt, bounds),
                            lambda: plain(dy, wt)),
             "weight_grad": (lambda: torch._grouped_mm(a.T, dy, bounds[1:]),
                             plain_wgrad)}
    aa, ww = a.clone().requires_grad_(), w.clone().requires_grad_()
    auto = dict(zip(("input_grad", "weight_grad"), torch.autograd.grad(
        moe._grouped(aa, ww, bounds), (aa, ww), dy)))
    by_ops = 2.0 * n * d * f / BF16_PEAK_FLOPS * 1e3
    by_bytes = _bound_ms(2 * (n * d + held * d * f + n * f))
    bound = max(by_ops, by_bytes)
    bound_by = "ops" if by_ops >= by_bytes else "bytes"
    out = {"rows": n, "buffer_rows": rows, "bound_ms": bound}
    for name, (fn, want_fn) in cases.items():
        got, want = fn(), want_fn()
        got = got[:n] if got.dim() == 2 else got
        err = float((got.float() - want).abs().max() / want.abs().max())
        if name in auto and not torch.equal(auto[name][:n] if got.dim() == 2
                                            else auto[name], got):
            raise AssertionError(f"grouped product's {name}: autograd "
                                 f"differs from the direct call")
        if not err <= rel_tol:
            raise AssertionError(f"grouped product's {name} at {n} of "
                                 f"{rows} rows: {err:.3g} of the largest "
                                 f"value from the float32 loop, over "
                                 f"{rel_tol}")
        ms = _device_ms(fn)
        out[name] = {"max_rel_err": err, "ms": ms, "library_ms": ms,
                     "plain_ms": _call_ms(want_fn, iters=3, warmup=1),
                     "roofline_pct": 100 * bound / ms}
        print(f"grouped expert product {name} (torch._grouped_mm) at {n} "
              f"of {rows} rows, {d}->{f}, {held} experts: {err:.3g} of "
              f"the largest value from the float32 loop; {ms:.5f} ms on "
              f"the device (the library's), bound {bound:.5f} ({bound_by}), "
              f"plain {out[name]['plain_ms']:.5f}", flush=True)
    return out


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
F32_LOGIT_ATOL = 1e-3               # float32 logits, kernel vs plain path
# bfloat16 logits, kernel vs plain path: the two attentions agree to fp32
# rounding, but a bf16 rounding of an attention output can flip and travel
# through 28 layers; the bound is set in PERF.md before the first run
BF16_LOGIT_BOUND = 1.0


LM_PLAIN = ("flash_attention", "decode_attention", "embedding_lookup",
            "embedding_scatter_add", "dequantize_rows")


@contextlib.contextmanager
def plain_attention():
    """Route the LM's kernels — both attentions, the token gather and its
    gradient, the int8 KV cache's dequantize — through their plain
    versions, on any device: the path the
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


NEAR_TIE = 1e-5                     # a flipped route with a smaller gap


@contextlib.contextmanager
def record_routes(log: list, gaps: bool = True):
    """Every ``models.moe.route`` call inside appends ``(idx (T, k), top)``
    to ``log``: the chosen experts and, with ``gaps``, the k + 1 largest
    router probabilities sorted (recomputed from the same inputs; else
    None). The model looks ``route`` up on the module at each call, so
    wrapping it there is enough."""
    import torch

    from repro_torch.models import moe
    route = moe.route

    def recording(router_w, x, cfg):
        idx, gate, aux = route(router_w, x, cfg)
        top = None
        if gaps:
            with torch.no_grad():
                probs = torch.softmax(x.detach().float()
                                      @ router_w.detach().float(), dim=-1)
                top = torch.topk(probs, min(cfg.experts_per_token + 1,
                                            cfg.num_experts), dim=-1).values
        log.append((idx.detach(), top))
        return idx, gate, aux

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = route


@contextlib.contextmanager
def replay_routes(kernel: list, log: list):
    """Every ``models.moe.route`` call inside takes the kernel path's
    experts: the n-th call routes by ``kernel[n]``'s (``record_routes``)
    with its gates taken from this path's own router probabilities at
    those experts, as ``route`` computes them; it appends its own choice
    and the k + 1 largest probabilities to ``log``, as ``record_routes``
    does. A bf16 path held against the kernel path then differs from it
    by the kernels' rounding alone: a flipped route, and every later
    token it reaches through attention or an SSM state, stays out."""
    import torch

    from repro_torch.models import moe
    route, calls = moe.route, iter(kernel)

    def replaying(router_w, x, cfg):
        own, _, aux = route(router_w, x, cfg)
        idx = next(calls)[0]
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        gate = probs.gather(-1, idx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        top = torch.topk(probs, min(cfg.experts_per_token + 1,
                                    cfg.num_experts), dim=-1).values
        log.append((own.detach(), top.detach()))
        return idx, gate, aux

    moe.route = replaying
    try:
        yield log
    finally:
        moe.route = route


def compare_routes(kernel: list, plain: list):
    """Layer by layer, the kernel path's routes (``record_routes``)
    against the plain path's. For each token, the first layer whose
    experts differ is its flip: the gap there is the plain path's
    probability at the first differing position minus the next one
    (the k-th minus the (k+1)-th for a changed expert); later layers of
    that token follow from the flip and are not counted again. Returns
    None without MoE layers, else the flips ``(layer, token, gap)``, the
    share of assignments whose expert differs, and ``agree``: the tokens
    whose routes agree in every layer."""
    import torch
    if not kernel and not plain:
        return None
    if len(kernel) != len(plain):
        raise AssertionError(f"{len(kernel)} routed layers on the kernel "
                             f"path, {len(plain)} on the plain path")
    seen = None
    flips, differ, total = [], 0, 0
    for layer, ((ki, _), (pi, top)) in enumerate(zip(kernel, plain)):
        diff = (ki != pi).cpu()
        differ += int(diff.sum())
        total += diff.numel()
        row = diff.any(-1)
        new = row if seen is None else row & ~seen
        if bool(new.any()):
            toks = new.nonzero()[:, 0]
            j = diff[toks].int().argmax(-1)
            top = top.cpu()
            gap = top[toks, j] - top[toks, torch.clamp(j + 1,
                                                       max=top.shape[1] - 1)]
            flips += [(layer, int(t), float(g)) for t, g in zip(toks, gap)]
        seen = row if seen is None else seen | row
    agree = ~seen
    return {"layers": len(kernel), "rows": int(agree.numel()),
            "held": int(agree.sum()), "assignments": total,
            "differ": differ, "flips": flips, "agree": agree}


def merge_routes(parts: list):
    """``compare_routes`` of several calls (decode steps) summed; None
    without MoE layers."""
    parts = [r for r in parts if r is not None]
    if not parts:
        return None
    return {"layers": parts[0]["layers"],
            "rows": sum(r["rows"] for r in parts),
            "held": sum(r["held"] for r in parts),
            "assignments": sum(r["assignments"] for r in parts),
            "differ": sum(r["differ"] for r in parts),
            "flips": [(i, *f) for i, r in enumerate(parts)
                      for f in r["flips"]]}


def _agree(routes, shape):
    """The rows to hold a logit bound on: those whose routes agree in
    every layer (every row without MoE layers)."""
    return None if routes is None else routes["agree"].view(shape)


def _routes_line(label: str, r) -> str:
    worst = max((f[-1] for f in r["flips"]), default=0.0)
    return (f"  routes, {label}: {r['layers']} routed layers, "
            f"{r['differ']} of {r['assignments']} assignments differ from "
            f"the plain path ({r['differ'] / r['assignments']:.3g}); "
            f"{len(r['flips'])} tokens flip first at a gap of at most "
            f"{worst:.3g}; {r['held']} of {r['rows']} tokens take the same "
            f"experts in every layer")


def _stamp(device):
    """A point on the device's stream (a CUDA event), or the host clock
    off the card."""
    import torch
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _span_ms(a, b) -> float:
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def stamped_forward(module, names, cfg, params, tokens, device):
    """One forward of ``tokens`` with a stream stamp before and after the
    whole forward and around every call of each function ``names`` of
    ``module`` (wrapped there, where the model looks them up at each
    call). Returns the forward's stream time, each function's stream
    time summed over its calls, and the forward's metrics."""
    import torch

    from repro_torch.models import forward
    saved = {n: getattr(module, n) for n in names}
    spans: dict = {n: [] for n in names}

    def timed(name):
        def call(*args, **kw):
            a = _stamp(device)
            out = saved[name](*args, **kw)
            spans[name].append((a, _stamp(device)))
            return out
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        with torch.no_grad():
            t0 = _stamp(device)
            _, metrics = forward(params, cfg, tokens)
            t1 = _stamp(device)
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    _sync(device)
    ms = {n: sum(_span_ms(a, b) for a, b in v) for n, v in spans.items()}
    return _span_ms(t0, t1), ms, metrics


def moe_share(cfg, params, tokens, device) -> dict:
    """One forward of ``tokens`` with stream stamps (``stamped_forward``)
    around every call of ``moe_ffn``, ``route``, ``_dispatch`` (the slot
    map and the dispatch gather) and ``_combine`` (the combine gather,
    the gates and the sum over k): each part's stream time summed over
    the layers; the expert products (three ``bmm`` and the SiLU) are the
    rest of ``moe_ffn``. Also layer 0's expert counts."""
    from repro_torch.models import moe
    total, ms, metrics = stamped_forward(
        moe, ("moe_ffn", "route", "_dispatch", "_combine"), cfg, params,
        tokens, device)
    ms["expert products"] = ms["moe_ffn"] - ms["route"] - ms["_dispatch"] \
        - ms["_combine"]
    return {"forward_ms": total, "ms": ms,
            "layer0_counts": metrics["expert_counts_per_layer"][0]["pos0"][
                0].tolist()}


def ssm_share(cfg, params, tokens, device) -> dict:
    """One forward of ``tokens`` with stream stamps (``stamped_forward``)
    around every call of ``mamba_block`` and its parts: ``_projections``
    (the five in-projections), ``_causal_conv``, ``ssd_chunked`` and
    ``_gate_out`` (the gated norm and out_proj); the rest of
    ``mamba_block`` (the SiLU, softplus, the D skip) is ``other``."""
    from repro_torch.models import ssm
    parts = ("_projections", "_causal_conv", "ssd_chunked", "_gate_out")
    total, ms, _ = stamped_forward(ssm, ("mamba_block", *parts), cfg,
                                   params, tokens, device)
    ms["other"] = ms["mamba_block"] - sum(ms[n] for n in parts)
    return {"forward_ms": total, "ms": ms}


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


def _logit_dev(a, b, vocab: int, keep=None) -> tuple[float, float]:
    """Largest |a - b| over the real vocabulary columns, and the share of
    rows whose greedy token agrees; with ``keep`` (a bool mask of a's
    leading shape), over the kept rows only (0.0 and 1.0 when none is)."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    if keep is not None:
        a, b = a[keep], b[keep]
        if not a.numel():
            return 0.0, 1.0
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


def prefill_phase(cfg, params, tokens, reps: int, device,
                  frames=None, f32: bool = True,
                  replay: bool = False) -> dict:
    """``make_prefill_step`` on ``tokens`` (and ``frames``, a model with
    context's (B, T, D)): once in float32 (the params cast; not with
    ``f32`` False, where a float32 copy would not fit beside the bf16
    params) and ``reps`` timed times in the config's bf16 on the kernel
    path, each against the plain path on the same params and inputs, then
    once more profiled. The bf16 deviation is taken over the tokens whose
    routes agree in every layer, or, with ``replay``, over every token,
    the plain path taking the kernel path's routes (``replay_routes``).
    ``forwards`` counts the kernel path's forwards (a warm-up
    included)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import make_prefill_step
    fa = ops.KERNELS["flash_attention"]
    batch = {"tokens": tokens}
    if frames is not None:
        batch["enc_context"] = frames
    per_forward = f32_routes = f32_dev = f32_agree = None
    if f32:
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        p32 = _tree_map(lambda t: t.float(), params)
        step32 = make_prefill_step(cfg32)
        kr, pr = [], []
        before = fa.launches
        with record_routes(kr, gaps=False):
            kernel = step32(p32, batch)
        _sync(device)
        per_forward = fa.launches - before
        with plain_attention(), record_routes(pr):
            plain = step32(p32, batch)
        f32_routes = compare_routes(kr, pr)
        f32_dev, f32_agree = _logit_dev(kernel, plain, cfg.vocab_size,
                                        _agree(f32_routes, tokens.shape))
        del p32, kernel, plain, kr, pr
    step = make_prefill_step(cfg)
    ms = []
    for _ in range(reps + 1):                   # the first warms up
        before = fa.launches
        t0 = time.perf_counter()
        kernel = step(params, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if per_forward is None:
            per_forward = fa.launches - before
    forwards = len(ms) + (2 if f32 else 1)
    kr, pr = [], []
    if cfg.num_experts:          # the compared forward, its routes recorded
        with record_routes(kr, gaps=False):
            kernel = step(params, batch)
        forwards += 1
    with plain_attention(), (replay_routes(kr, pr) if replay
                             else record_routes(pr)):
        plain = step(params, batch)
    bf16_routes = compare_routes(kr, pr)
    bf16_dev, bf16_agree = _logit_dev(
        kernel, plain, cfg.vocab_size,
        None if replay else _agree(bf16_routes, tokens.shape))
    bf16_all = _logit_dev(kernel, plain, cfg.vocab_size)
    if not (torch.isfinite(kernel[..., :cfg.vocab_size]).all()
            and kernel.shape == (*tokens.shape, cfg.padded_vocab)):
        raise AssertionError("prefill logits not finite of shape (B, S, V)")
    del kernel, plain, kr, pr
    prof = profile_call(lambda: step(params, batch), device)
    moe = ssm_parts = None
    if cfg.num_experts:
        moe = moe_share(cfg, params, tokens, device)
        forwards += 1
    if cfg.ssm_state:
        ssm_parts = ssm_share(cfg, params, tokens, device)
        forwards += 1
    return {"per_forward": per_forward, "forwards": forwards,
            "f32_dev": f32_dev, "f32_agree": f32_agree, "bf16_dev": bf16_dev,
            "bf16_agree": bf16_agree, "ms": ms[1:], "profile": prof,
            "f32_routes": f32_routes, "bf16_routes": bf16_routes,
            "bf16_all": bf16_all, "moe": moe, "ssm": ssm_parts}


def _recording(step_fn, records: list, caches: Optional[list] = None):
    """``step_fn`` that also keeps each step's params, tokens, positions
    and logits, so the plain path can replay the kernel path's steps;
    with ``caches``, a copy of the cache before each step there too. The
    tokens and positions are copied: the driver's buffers change in
    place from step to step."""
    def step(params, cache, tokens, pos):
        if caches is not None:
            caches.append(_tree_map(lambda t: t.clone(), cache))
        logits, cache = step_fn(params, cache, tokens, pos)
        records.append((params, tokens.clone(), pos.clone(), logits))
        return logits, cache
    return step


def decode_run(cfg, driver, params, args, gen, device,
               local: bool = False) -> dict:
    """``launch.serve.run`` on ``driver`` (hot swaps and all), then the
    plain path teacher-forced: each recorded step replayed with the same
    params, tokens and positions on a copy of the cache as it stood before
    the run, its logits compared with the kernel path's (and whether the
    kernel path's are finite) on the rows whose routes agree that step.
    With ``local``, each step is held alone, on every row: the plain step
    runs on a copy of the kernel path's cache before it (kept as the run
    goes) and takes the kernel path's routes (``replay_routes``)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models import decode_step
    records: list = []
    inner = driver.step_fn
    befores: Optional[list] = [] if local else None
    driver.step_fn = _recording(inner, records, befores)
    plain_cache = None if local else _tree_map(lambda t: t.clone(),
                                               driver.cache)
    kr: list = []
    tensor_core = da.decode_attention.tensor_core_launches
    t0 = time.perf_counter()
    with record_routes(kr, gaps=False):
        tokens, lat = serve.run(driver, params, args, gen)
    wall = time.perf_counter() - t0
    tensor_core = da.decode_attention.tensor_core_launches - tensor_core
    layers = len(kr) // max(1, len(records))       # MoE layers a step
    devs, agree, routes, every = [], [], [], []
    finite = all(bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
                 for *_, lg in records)
    with plain_attention():
        for i, (p, tok, pos, logits) in enumerate(records):
            pr: list = []
            own = kr[i * layers:(i + 1) * layers]
            if local:
                plain_cache = befores[i]
                befores[i] = None
            with (replay_routes(own, pr) if local else record_routes(pr)):
                plain, plain_cache = decode_step(p, cfg, plain_cache, tok,
                                                 pos)
            routes.append(compare_routes(own, pr))
            d, a = _logit_dev(logits, plain, cfg.vocab_size, None if local
                              else _agree(routes[-1], tok.shape[:1]))
            devs.append(d)
            agree.append(a)
            every.append(_logit_dev(logits, plain, cfg.vocab_size))
    # the records hold every hot-swapped copy of the params: unwrap the
    # step so that they go with this call
    driver.step_fn = inner
    if tokens.shape != (args.batch, args.steps) or not (
            (0 <= tokens) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"decode tokens of shape {tokens.shape} or out "
                             f"of the vocabulary")
    _sync(device)
    return {"lat_ms": [x * 1e3 for x in lat], "wall_s": wall,
            "max_dev": max(devs), "agree": float(np.mean(agree)),
            "steps": len(records), "routes": merge_routes(routes),
            "finite": finite, "max_len": driver.max_len,
            "all_dev": max(d for d, _ in every),
            "all_agree": float(np.mean([a for _, a in every])),
            "tensor_core_launches": tensor_core}


def drive_lm(device, serve_argv, *, prefill_batch: int, prefill_len: int,
             prefill_reps: int, long_len: int, long_pos: int,
             long_steps: int, seed: int = SEED,
             consistency_window: Optional[int] = None) -> dict:
    """The LM serving path through its entry points: ``launch.serve``
    builds the model and its ``ServeDriver`` from ``serve_argv`` (a
    model with context: its cross cache precomputed from the launcher's
    frames); ``make_prefill_step`` runs a prefill of ``prefill_batch`` x
    ``prefill_len`` tokens (float32 and bf16; with context, on frames
    drawn from the seed); the launcher's own decode run follows, then a
    decode against a long cache whose self-attention K/V are seeded up
    to ``long_pos`` of ``long_len`` (a sliding-window layer's ring
    wholly; a cross cache precomputed from frames, before the counters
    are reset). Each is held against the plain path. Unless
    ``consistency_window`` is None, ``decode_vs_forward`` follows over
    the prefill's first ``CONSISTENCY_LEN`` tokens (and its frames), a
    nonzero ``consistency_window`` cutting the config's window to that
    many rows (its launches and peak memory counted apart). The launch
    counters are reset before and read after the whole path."""
    import torch

    from repro_torch.configs.base import ATTN, CROSS_ATTN, LOCAL_ATTN
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import precompute_cross_cache
    from repro_torch.serving.predictor import ServeDriver

    args = serve.parse_args([*serve_argv, "--device", device.type])
    cfg, params, driver, gen = serve.build(args)
    data = torch.Generator(device=device).manual_seed(seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (prefill_batch, prefill_len),
                           generator=data, device=device)
    frames = None
    if cfg.has_encoder_context:
        frames = torch.randn((prefill_batch, cfg.encoder_len, cfg.d_model),
                             generator=data, device=device)
    long_args = serve.parse_args([*serve_argv, "--device", device.type,
                                  "--steps", str(long_steps),
                                  "--max-len", str(long_len)])
    long_driver = ServeDriver(cfg=cfg, params=params, batch=long_args.batch,
                              max_len=long_len, cache_dtype=torch.float32,
                              device=device)
    for seg in long_driver.cache["segments"]:       # K/V of a long context
        for kv in seg.values():
            for t in (kv[k] for k in ("k", "v") if k in kv):
                t[:, :, :long_pos] = torch.randn(
                    t[:, :, :long_pos].shape, generator=data,
                    device=device)
    if cfg.has_encoder_context:
        precompute_cross_cache(params, cfg, long_driver.cache, torch.randn(
            (long_args.batch, cfg.encoder_len, cfg.d_model), generator=data,
            device=device))
    long_driver.pos = torch.full((long_args.batch,), long_pos,
                                 dtype=torch.int32, device=device)
    sizes = {"param_bytes": _tree_bytes(params),
             "cache_bytes": _tree_bytes(driver.cache)
             + _tree_bytes(long_driver.cache)}
    by_mixer: dict = {}             # each mixer kind's first cache entry
    for si, seg in enumerate(cfg.segments):
        for i, spec in enumerate(seg.pattern):
            entries = [c["segments"][si][f"pos{i}"]
                       for c in (long_driver.cache, driver.cache)]
            by_mixer.setdefault(spec.mixer, entries[0])
            if spec.mixer == LOCAL_ATTN:
                sizes["ring_bytes"] = sizes.get("ring_bytes", 0) + sum(
                    map(_tree_bytes, entries))
            if spec.mixer == CROSS_ATTN:
                sizes["cross_bytes"] = sizes.get("cross_bytes", 0) + sum(
                    map(_tree_bytes, entries))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    prefill = prefill_phase(cfg, params, tokens, prefill_reps, device,
                            frames)
    after_prefill = ops.launch_counts()
    serve_run = decode_run(cfg, driver, params, args, gen, device)
    driver.hot_swap(params)             # frees its last swapped-in copy
    after_serve = ops.launch_counts()
    long_run = decode_run(cfg, long_driver, params, long_args, gen, device)
    launches = ops.launch_counts()
    serve_run["launches"] = after_serve["decode_attention"] \
        - after_prefill["decode_attention"]
    long_run["launches"] = launches["decode_attention"] \
        - after_serve["decode_attention"]
    if device.type == "cuda":
        sizes["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    consistency = None
    if consistency_window is not None:
        consistency = decode_vs_forward(
            dataclasses.replace(cfg, window_size=consistency_window or
                                cfg.window_size),
            params, tokens[:, :CONSISTENCY_LEN], device, frames)
        if consistency_window:
            consistency["window"] = consistency_window
        after = ops.launch_counts()
        consistency["launches"] = {k: after[k] - launches[k]
                                   for k in after}
        launches = after
        if device.type == "cuda":
            consistency["peak_bytes"] = torch.cuda.max_memory_allocated()
    # one more step of the long run, profiled (after the comparisons)
    tok = torch.zeros((long_args.batch, 1), dtype=torch.int32, device=device)
    long_run["profile"] = profile_call(lambda: long_driver.step(tok), device)
    # the path's own attention inputs for the kernels' timing rows: a
    # layer's q, k, v at the prefill's shapes, and a global layer's cache
    # of the long run with its first step's lengths (a windowed layer's
    # ring apart, at its lengths)
    glob, ring = by_mixer[ATTN], by_mixer.get(LOCAL_ATTN)
    return {"cfg": cfg, "prefill": prefill, "serve": serve_run,
            "long": long_run, "launches": launches, "sizes": sizes,
            "layers": cfg.num_layers, "consistency": consistency,
            "long_pos": long_pos, "long_len": long_len,
            "prefill_shape": tuple(tokens.shape),
            "decode_inputs": (glob["k"][0], glob["v"][0], long_pos + 1),
            "cross_inputs": None if CROSS_ATTN not in by_mixer else (
                by_mixer[CROSS_ATTN]["xk"][0], by_mixer[CROSS_ATTN]["xv"][0]),
            "ring_inputs": None if ring is None else (
                ring["k"][0], ring["v"][0],
                min(long_pos + 1, ring["k"].shape[2]))}


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
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    b, h, g, d, s = (PREFILL_BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, PREFILL_LEN)
    q, k, v = _attn_inputs(b, h, g, s, d, torch.bfloat16, gen, device)
    return [flash_row(q, k, v, True, "causal"),
            decode_row(cfg, decode_inputs, gen, device)]


def flash_row(q, k, v, causal: bool, label: str) -> dict:
    """``flash_attention`` on bf16 q (B, H, S, D), k, v (B, G, T, D),
    held within 2e-2 of its plain version and timed beside it, its bound
    and ``scaled_dot_product_attention``. Bound: q, k, v read and the
    output written once; the products' 4 * B * H * S * T * D operations
    (half of them where ``causal`` masks, S = T)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    (b, h, s, d), (g, t) = q.shape, k.shape[1:3]
    err = _check_close("flash_attention",
                       fa.flash_attention(q, k, v, causal=causal),
                       ref.flash_attention(q, k, v, causal=causal), 2e-2)
    return _row("flash_attention", "flash_attention_sm90.cu",
                "src/repro/kernels/flash_attention.py:70", err,
                lambda: fa.flash_attention(q, k, v, causal=causal),
                lambda: ref.flash_attention(q, k, v, causal=causal),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True),
                2 * (2 * b * h * s + 2 * b * g * t) * d,
                f"q ({b}, {h}, {s}, {d}), k, v ({b}, {g}, {t}, {d}) bf16, "
                f"{label}",
                flops=(2.0 if causal else 4.0) * b * h * s * t * d,
                peak=BF16_PEAK_FLOPS,
                agreement="within 2e-2 of its plain version")


def decode_row(cfg, decode_inputs, gen, device) -> dict:
    """``decode_attention`` timed against ``decode_inputs`` (a layer's
    float32 cache of the long run and the length of its first step) with
    a bf16 query, beside its plain version, its bound and
    ``scaled_dot_product_attention`` over the cache's valid rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    h, g, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
    return _row("decode_attention", "decode_attention.cu",
                "src/repro/kernels/decode_attention.py:63", err,
                lambda: da.decode_attention(qd, ck, cv, lengths),
                lambda: ref.decode_attention(qd, ck, cv, lengths),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, enable_gqa=True),
                2 * n * length * g * d * 4 + 2 * n * h * d * 2,
                f"q ({n}, {h}, {d}) bf16 vs cache ({n}, "
                f"{ck.shape[1]}, {g}, {d}) f32, lengths {length}",
                flops=4.0 * n * length * h * d, peak=F32_PEAK_FLOPS,
                agreement="within 2e-2 of its plain version")


def _attn_layers(cfg) -> int:
    """The decoder's attention layers, global, sliding-window and cross:
    each launches ``decode_attention`` once a decode step."""
    from repro_torch.configs.base import ATTN, CROSS_ATTN, LOCAL_ATTN
    return sum(spec.mixer in (ATTN, LOCAL_ATTN, CROSS_ATTN)
               for spec in cfg.layer_specs())


def _encoder_layers(cfg) -> int:
    """The encoder's bidirectional layers: each launches the flash kernel
    once an ``encode`` (a forward of an encoder-decoder, and a
    ``precompute_cross_cache``)."""
    from repro_torch.configs.base import ENC_ATTN
    return sum(spec.mixer == ENC_ATTN for seg in cfg.encoder_segments
               for spec in seg.pattern * seg.repeats)


def _flash_layers(cfg, seq: int) -> int:
    """The layers a forward over ``seq`` tokens runs through the flash
    kernel: every global and cross one, the encoder's, and a
    sliding-window one whose window masks nothing at ``seq`` (seq <=
    window); past its window a windowed layer takes a tensor-op
    branch."""
    from repro_torch.configs.base import ATTN, CROSS_ATTN, LOCAL_ATTN
    return _encoder_layers(cfg) + sum(
        spec.mixer in (ATTN, CROSS_ATTN) or (spec.mixer == LOCAL_ATTN
                                            and seq <= cfg.window_size)
        for spec in cfg.layer_specs())


def _moe_layers(cfg) -> int:
    from repro_torch.configs.base import MOE
    return sum(spec.ffn == MOE for spec in cfg.layer_specs())


def check_near_ties(label: str, routes) -> None:
    """Fail when a float32 route flips at a gap of ``NEAR_TIE`` or more:
    that is a fault, not rounding. Each flip is printed."""
    if routes is None:
        return
    for flip in routes["flips"]:
        print(f"  {label}: route flip (layer, token, gap) {flip}")
    bad = [f for f in routes["flips"] if f[-1] >= NEAR_TIE]
    if bad:
        raise AssertionError(f"{label}: routes flip at gaps >= {NEAR_TIE}: "
                             f"{bad[:8]}")


def report_lm(lm: dict) -> None:
    """Print the LM phase's numbers and hold them to their limits."""
    cfg, pre, n = lm["cfg"], lm["prefill"], lm["layers"]
    launches, sizes, cons = lm["launches"], lm["sizes"], lm["consistency"]
    pb, pl = lm["prefill_shape"]
    flash, dec = _flash_layers(cfg, pl), _attn_layers(cfg)
    p50 = float(np.percentile(pre["ms"], 50))
    rings = "" if "ring_bytes" not in sizes else (
        f" (global {sizes['cache_bytes'] - sizes['ring_bytes']}, "
        f"sliding-window rings of min({cfg.window_size}, max_len) rows "
        f"{sizes['ring_bytes']})")
    if "cross_bytes" in sizes:
        rings += (f" (cross caches of {cfg.encoder_len} frames "
                  f"{sizes['cross_bytes']}, self-attention "
                  f"{sizes['cache_bytes'] - sizes['cross_bytes']})")
    print(f"LM serving: {cfg.name} at full width ({n} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV "
          f"of {cfg.head_dim}, vocab {cfg.vocab_size}"
          + (f", window {cfg.window_size}" if cfg.window_size else "")
          + (f", {_encoder_layers(cfg)} encoder layers over "
             f"{cfg.encoder_len} frames" if cfg.encoder_segments else "")
          + f"), random weights from seed {SEED}; params "
          f"{sizes['param_bytes']} bytes, KV caches {sizes['cache_bytes']}"
          f" bytes{rings}, peak device memory {sizes.get('peak_bytes')} "
          f"bytes", flush=True)
    print(f"  prefill {pb} x {pl} bf16: p50 {p50:.3f} ms "
          f"over {len(pre['ms'])} ({pb * pl / p50 * 1e3:.0f}"
          f" tokens/s); flash_attention launches per forward "
          f"{pre['per_forward']} ({pre['forwards']} forwards on the kernel "
          f"path); logits vs the plain path: float32 max "
          f"deviation {pre['f32_dev']:.3g} (limit {F32_LOGIT_ATOL}), bf16 "
          f"{pre['bf16_dev']:.3g} (limit {BF16_LOGIT_BOUND}); greedy tokens "
          f"agree {pre['f32_agree']:.4f} (f32), {pre['bf16_agree']:.4f} "
          f"(bf16)")
    for label, run in ((f"launcher's run (max_len "
                        f"{lm['serve']['max_len']})", lm["serve"]),
                       (f"long cache (pos {lm['long_pos']} of "
                        f"{lm['long_len']})", lm["long"])):
        lat = run["lat_ms"]
        print(f"  decode, {label}: {run['steps']} steps, p50 "
              f"{np.percentile(lat, 50):.3f} ms, p99 "
              f"{np.percentile(lat, 99):.3f} ms per step (4 tokens/step: "
              f"{4 / np.percentile(lat, 50) * 1e3:.1f} tokens/s), "
              f"{run['wall_s']:.2f} s with hot swaps; decode_attention "
              f"launches {run['launches']} ({run['launches'] / run['steps']:g}"
              f" per step, {run['tensor_core_launches']} on the tensor-core "
              f"kernel); teacher-forced logits vs the plain path: max "
              f"deviation {run['max_dev']:.3g} (limit {BF16_LOGIT_BOUND}), "
              f"greedy tokens agree {run['agree']:.4f}", flush=True)
    print(_profile_line(f"bf16 prefill ({pb} x {pl})",
                        pre["profile"]))
    print(_profile_line(f"decode step at length "
                        f"{lm['long_pos'] + lm['long']['steps'] + 1}",
                        lm["long"]["profile"]))
    if pre["f32_routes"] is not None:
        print("  (the logit bounds above hold on the tokens whose routes "
              "agree with the plain path's in every layer; over every "
              "token, bf16 max deviation / greedy agreement: prefill "
              f"{pre['bf16_all'][0]:.3g} / {pre['bf16_all'][1]:.4f}, "
              f"launcher's decode {lm['serve']['all_dev']:.3g} / "
              f"{lm['serve']['all_agree']:.4f}, long-cache decode "
              f"{lm['long']['all_dev']:.3g} / {lm['long']['all_agree']:.4f})")
    for label, r in (("float32 prefill", pre["f32_routes"]),
                     ("bf16 prefill", pre["bf16_routes"]),
                     ("launcher's decode", lm["serve"]["routes"]),
                     ("long-cache decode", lm["long"]["routes"])):
        if r is not None:
            print(_routes_line(label, r))
    if pre["moe"] is not None:
        moe = pre["moe"]
        print(f"  MoE share of one bf16 prefill's stream time "
              f"({moe['forward_ms']:.3f} ms, stamps around each part): "
              + ", ".join(f"{k} {v:.3f} ms ({100 * v / moe['forward_ms']:.1f}"
                          f"%)" for k, v in moe["ms"].items())
              + f"; layer 0's expert counts {moe['layer0_counts']}")
    if cons is not None:
        report_consistency(cons)
    print(f"  launches in the LM path: {launches}")
    steps = lm["serve"]["steps"] + lm["long"]["steps"]
    gathers = 1 + 2 * _moe_layers(cfg)      # the token gather, 2 a MoE
    want = {"flash_attention": flash * pre["forwards"],
            "decode_attention": dec * steps,
            "embedding_lookup": gathers * (pre["forwards"] + steps)}
    if cons is not None:
        own = {"flash_attention": cons["forwards"] * _flash_layers(
                   dataclasses.replace(cfg, window_size=cons.get(
                       "window", cfg.window_size)), CONSISTENCY_LEN)
               + cons["encodes"] * _encoder_layers(cfg),
               "decode_attention": dec * cons["steps"],
               "embedding_lookup": gathers * (cons["forwards"]
                                              + cons["steps"])}
        if {k: cons["launches"][k] for k in own} != own:
            raise AssertionError(f"decode vs forward launches "
                                 f"{cons['launches']}, want {own}")
        want = {k: want[k] + own[k] for k in want}
    if pre["per_forward"] != flash or \
            {k: launches[k] for k in want} != want:
        raise AssertionError(f"LM launches {launches}, want {want} and "
                             f"{flash} per forward")
    if pre["f32_dev"] > F32_LOGIT_ATOL:
        raise AssertionError(f"float32 prefill logits deviate by "
                             f"{pre['f32_dev']:.3g}")
    check_near_ties("float32 prefill", pre["f32_routes"])
    worst = max(pre["bf16_dev"], lm["serve"]["max_dev"],
                lm["long"]["max_dev"])
    if worst > BF16_LOGIT_BOUND:
        raise AssertionError(f"bf16 logits deviate by {worst:.3g}")


def report_consistency(cons: dict) -> None:
    """Print ``decode_vs_forward``'s figures (with a windowed model's cut,
    ``cons["window"]``: the forward block-local and every ring wrapping)
    and hold the float64 run to ``F64_DECODE_ATOL`` and the float32 and
    bf16 runs to finite logits."""
    w = cons.get("window")
    cut = "" if w is None else (
        f" with the window cut to {w} (the forward block-local, each ring "
        f"of {w} rows wrapping {CONSISTENCY_LEN // w - 1} times)")
    peak = "" if "peak_bytes" not in cons else (
        f"; peak device memory {cons['peak_bytes']} bytes")
    c = cons["float64"]
    print(f"  decode against forward over {CONSISTENCY_LEN} tokens{cut}, "
          f"float64 (params, cache and every float32 step; plain path): "
          f"max deviation {c['dev'][0]:.3g} (limit {F64_DECODE_ATOL}), "
          f"greedy tokens agree {c['dev'][1]:.4f}{peak}")
    for label in ("float32", "bf16"):
        c = cons[label]
        print(f"  decode against forward over {CONSISTENCY_LEN} tokens, "
              f"{label} (params and cache): max deviation {c['dev'][0]:.3g},"
              f" greedy tokens agree {c['dev'][1]:.4f}; from the float64 "
              f"forward: decode {c['dec']:.3g}, forward {c['fwd']:.3g}",
              flush=True)
    if not cons["float64"]["dev"][0] <= F64_DECODE_ATOL:
        raise AssertionError(f"float64 decode deviates from the forward by "
                             f"{cons['float64']['dev'][0]:.3g}")
    if not all(np.isfinite(cons[k][m]) for k in ("float32", "bf16")
               for m in ("dec", "fwd")):
        raise AssertionError(f"decode or forward logits not finite: {cons}")


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


def _batch_ids(cfg, device, seq: int = TRAIN_SEQ):
    """The token ids of one ``lm_batches`` batch as the launcher draws
    them (its bigram structure repeats tokens)."""
    import torch

    from repro_torch.data import lm_batches
    tokens = next(lm_batches(cfg.vocab_size, TRAIN_BATCH, seq,
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


def scatter_add_row(cfg, device, split: bool = True,
                    seq: int = TRAIN_SEQ) -> dict:
    """``embedding_scatter_add`` timed as the embedding gradient runs it:
    one batch's ids (``TRAIN_BATCH`` x ``seq``) into a zeros (vocab,
    d_model) bf16 table with bf16 updates. Bound: the updates and ids
    read once, each distinct row read and written once. Then, with
    ``split``, the call's split: the sort
    (``sort_ids``) and the kernel each timed alone, and one call
    profiled, which must list the sort and the kernel and no gather of
    the updates (``split=False`` where an earlier profiler session in the
    process may hide kernels from a later one)."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    ids = _batch_ids(cfg, device, seq).reshape(-1)
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
    if not split:
        return row
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


def check_train_f32(cfg, device, leaves=GRAD_LEAVES,
                    layers=None, seq: int = TRAIN_SEQ) -> dict:
    """One float32 train step's loss and gradients at full width from the
    seed over ``TRAIN_BATCH`` x ``seq`` tokens (a model with context on
    N(0, 1) frames from the seed), on the kernel path and on the plain
    path (``plain_attention``), each freed before the next: the loss
    within ``F32_LOSS_RTOL``, the ``leaves``' gradients within
    ``F32_GRAD_BOUND`` of their largest magnitude, every gradient leaf
    finite on both paths. ``layers`` cuts each segment to that many
    repeats, without remat (for a MoE, whose routes are recorded once a
    layer: they must agree on both paths, near ties apart)."""
    import torch

    from repro_torch.configs.base import Segment
    from repro_torch.core import tree
    from repro_torch.models import init_params
    from repro_torch.training import loss_and_grads
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    if layers:
        cfg32 = dataclasses.replace(cfg32, remat=False, segments=tuple(
            Segment(seg.pattern, layers) for seg in cfg.segments))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg32, torch.Generator(device=device).manual_seed(
        SEED))
    batch = {"tokens": _batch_ids(cfg, device, seq)}
    if cfg.has_encoder_context:
        batch["enc_context"] = torch.randn(
            (TRAIN_BATCH, cfg.encoder_len, cfg.d_model),
            generator=torch.Generator(device=device).manual_seed(SEED + 47),
            device=device)
    out, routes, finite = {}, {}, {}
    for path in ("kernel", "plain"):
        routes[path] = []
        with (plain_attention() if path == "plain"
              else contextlib.nullcontext()), \
                record_routes(routes[path], gaps=path == "plain"):
            loss, _, grads = loss_and_grads(params, cfg32, batch)
        flat = dict(tree.flatten_with_paths(grads))
        finite[path] = all(bool(torch.isfinite(g).all())
                           for g in flat.values())
        out[path] = (float(loss), {
            label: (flat[leaf] if layer is None else flat[leaf][layer]).clone()
            for label, leaf, layer in leaves})
        del grads, flat
        _sync(device)
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    devs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max())
            for k in gk}
    route_cmp = compare_routes(routes["kernel"], routes["plain"])
    check_near_ties("float32 train step", route_cmp)
    if not all(finite.values()):
        raise AssertionError(f"float32 grads not finite: {finite}")
    if abs(lk - lp) > F32_LOSS_RTOL * abs(lp):
        raise AssertionError(f"float32 loss {lk} vs plain {lp}")
    if max(devs.values()) > F32_GRAD_BOUND:
        raise AssertionError(f"float32 grads deviate: {devs}")
    return {"loss": lk, "plain_loss": lp, "grad_devs": devs,
            "layers": cfg32.num_layers, "routes": route_cmp,
            "peak_bytes": torch.cuda.max_memory_allocated()
            if device.type == "cuda" else None}


def model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + backward, remat's
    recompute not counted): 6 per token per matmul parameter a token
    uses (the head included; the embedding gather does none; an
    attention layer counts its q, k, v and o projections, a Mamba layer
    its in-projections to z, x, B, C and dt and its out_proj; a MoE layer
    counts its router and its k active experts, not the capacity's
    padding), plus 3x the forward's products that have no parameters:
    causal attention's two, 2 * B * H * S^2 * hd a layer (a
    sliding-window layer 2 * B * H * S * min(S, W) * hd), and the SSD's
    four a chunk of l = ``ssm_chunk`` positions (nc = ceil(S / l) chunks,
    H heads of P, state N), counted over the whole (l, l) square the
    port computes: CB 2 * l^2 * N, y_diag 2 * H * l^2 * P, states and
    y_off 2 * H * l * P * N each, a Mamba layer B * nc * (2 l^2 N + 2 H
    l^2 P + 4 H l P N). A model with context of T = ``encoder_len``
    frames: 6 per frame per matmul parameter a frame uses (the
    encoder's layers, its q, k, v, o and FFN, over B * T frames; a cross
    layer's k and v projections), a cross layer's q and o over the
    tokens, and 3x the full products, 4 * B * H * T^2 * hd an encoder
    layer and 4 * B * H * S * T * hd a cross layer."""
    from repro_torch.configs.base import (ATTN, CROSS_ATTN, ENC_ATTN,
                                          LOCAL_ATTN, MAMBA, MLP, MOE)
    d, f = cfg.d_model, cfg.d_ff
    h, g, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    di, n, nh, hp, l = (cfg.d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                        cfg.ssm_head_dim, cfg.ssm_chunk)
    t = cfg.encoder_len
    matmul, per_frame, other = cfg.padded_vocab * d, 0, 0.0
    for spec in cfg.layer_specs() + [spec for seg in cfg.encoder_segments
                                     for spec in seg.pattern * seg.repeats]:
        if spec.mixer == ENC_ATTN:
            per_frame += 2 * d * h * hd + 2 * d * g * hd
            other += 4.0 * batch * h * t * t * hd
            if spec.ffn == MLP:
                per_frame += 3 * d * f
            continue
        if spec.mixer == CROSS_ATTN:
            matmul += 2 * d * h * hd
            per_frame += 2 * d * g * hd
            other += 4.0 * batch * h * seq * t * hd
        elif spec.mixer in (ATTN, LOCAL_ATTN):
            keys = min(seq, cfg.window_size) if spec.mixer == LOCAL_ATTN \
                else seq
            matmul += 2 * d * h * hd + 2 * d * g * hd
            other += 2.0 * batch * h * seq * keys * hd
        elif spec.mixer == MAMBA:
            matmul += d * (2 * di + 2 * n + nh) + di * d
            other += batch * -(-seq // l) * (2.0 * l * l * n
                                             + 2.0 * nh * l * l * hp
                                             + 4.0 * nh * l * hp * n)
        if spec.ffn == MLP:
            matmul += 3 * d * f
        elif spec.ffn == MOE:
            matmul += d * cfg.num_experts + cfg.experts_per_token * 3 * d * f
    return 6.0 * batch * (seq * matmul + t * per_frame) + 3.0 * other


INT8_STALENESS_BOUND = 2e-2         # the reference's int8 bound


def _all_experts(cfg) -> list:
    """``expert_counts_per_layer`` with every (repeat, expert) routed."""
    from repro_torch.configs.base import MOE
    return [{f"pos{i}": np.ones((seg.repeats, cfg.num_experts), np.int32)
             for i, spec in enumerate(seg.pattern) if spec.ffn == MOE}
            for seg in cfg.segments]


def _records(engine) -> list:
    return [r for p in range(engine.queue.num_partitions)
            for r in engine.queue.consume(p, 0)[0]]


def int8_flush(cfg, initial: dict, params: dict, device,
               zero: bool = False) -> dict:
    """The trained ``params`` streamed once through a ``ModelSyncEngine``
    with the int8 codec on ``device`` (``--codec int8``) to one replica
    that starts from ``initial`` (with ``zero``, its host arrays zeroed
    after the engine's bootstrap: its staleness is then 1, and a leaf,
    row or expert that the flush misses keeps it there): a
    ``collect_step`` marks everything dirty (every leaf's version, every
    token row, the padding's too with ``zero``, every (repeat, expert)
    id of a MoE), one flush pushes it all: a dense leaf ONE codec row, an
    expert leaf one row a (repeat, expert) id, embedding rows in chunks.
    Returns the flush's time, records and bytes, the codec's launches in
    it and the launches the plans of its records' row widths want, the
    replica's staleness after it, and whether the largest leaf's codes
    and scales equal the plain version's on ``device``."""
    import torch

    from repro_torch.core import tree
    from repro_torch.core.sync_engine import ModelSyncEngine, SyncConfig
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train
    engine = ModelSyncEngine(cfg, initial, SyncConfig(
        gather_mode="period", period=1.0, codec="int8",
        codec_backend="torch", device=device.type))
    if zero:
        for arr in engine.replicas[0].host.values():
            arr.fill(0.0)
    engine.collect_step(np.arange(cfg.padded_vocab if zero
                                  else cfg.vocab_size)[None],
                        {"expert_counts_per_layer": _all_experts(cfg)})
    ops.reset_launches()
    flush = train._tick(engine, params, 1e9)
    launches = ops.launch_counts()
    records = _records(engine)
    path, leaf = max(tree.flatten_with_paths(params),
                     key=lambda e: e[1].numel())
    rec = next(r for r in records if r.meta["path"] == path)
    rows = leaf.detach().reshape(1, -1)
    if rec.meta["kind"] == "rows":          # an untied table's first chunk
        rows = leaf.detach()[torch.from_numpy(rec.ids).to(device)]
    if rec.meta["kind"] == "experts":
        rows = leaf.detach().reshape(-1, rows.numel() // (
            leaf.shape[0] * leaf.shape[1]))[torch.from_numpy(rec.ids)
                                            .to(device)]
    pq, ps = ref.quantize_rows(rows.float())
    equal = (torch.equal(torch.from_numpy(rec.payload["q"]).to(device), pq)
             and torch.equal(torch.from_numpy(rec.payload["scale"])
                             .to(device), ps))
    del pq, ps, rows
    return {**flush, "launches": launches,
            "want": {"quantize_rows": sum(
                dc.codec_plan(r.payload["q"].shape[1]).quantize_launches
                for r in records), "dequantize_rows": flush["records"]},
            "staleness": engine.replicas[0].staleness(params),
            "largest": (path, leaf.numel(), tuple(rec.payload["q"].shape)),
            "largest_equal": equal}


def drive_lm_train(device, train_argv, *, decode_steps: int, cfg=None,
                   keep_initial: bool = True, min_flushes: int = 2) -> dict:
    """LM training through its entry points: ``launch.train`` builds the
    state, step, ``ModelSyncEngine`` and batches (a model with context:
    with the launcher's N(0, 1) frames) from ``train_argv`` (and ``cfg``,
    a cut of its config, where given) and runs them (the sync clock
    counting steps), with the launch counters reset before and read
    after; then a ``ServeDriver`` started on the initial params (a model
    with context: its cross cache precomputed from them on frames from
    the seed) decodes, hot-swaps in the replica's ``device_params`` (the
    cross cache left as it was, as the reference's driver leaves it) and
    decodes ``decode_steps`` more, counted on their own. Without
    ``keep_initial`` no copy of the initial params is kept (the card
    holds no second copy): the driver starts on the trained params and
    the int8 flush's replica is zeroed before its flush. ``min_flushes``:
    the cast16 flushes the run must make."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import precompute_cross_cache
    from repro_torch.serving.predictor import ServeDriver
    args = train.parse_args([*train_argv, "--device", device.type])
    t0 = time.perf_counter()
    cfg, state, step_fn, engine, batches = train.build(args, cfg=cfg)
    build_s = time.perf_counter() - t0
    routed: list = []       # each step's expert counts, read to the host
    collect = engine.collect_step

    def logging_collect(tokens, metrics=None):
        if metrics and "expert_counts_per_layer" in metrics:
            routed.append([{k: v.cpu().numpy() for k, v in seg.items()}
                           for seg in metrics["expert_counts_per_layer"]])
        collect(tokens, metrics)

    engine.collect_step = logging_collect
    initial = _tree_map(lambda t: t.detach().clone() if keep_initial
                        else t.detach(), state.params)
    driver = ServeDriver(cfg=cfg, params=initial, batch=TRAIN_BATCH,
                         max_len=64, cache_dtype=torch.float32,
                         device=device)
    if cfg.has_encoder_context:
        precompute_cross_cache(initial, cfg, driver.cache, torch.randn(
            (TRAIN_BATCH, cfg.encoder_len, cfg.d_model),
            generator=torch.Generator(device=device).manual_seed(SEED + 53),
            device=device))
    logits: list = []
    driver.step_fn = _recording(driver.step_fn, logits)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, rec = train.run(args, cfg, state, step_fn, engine, batches,
                           clock=lambda i: float(i + 1))
    rec["wall_s"] = time.perf_counter() - t0
    rec["build_s"] = build_s
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
    if cfg.num_experts:
        rec["experts"] = expert_flushes(cfg, engine, routed, min_flushes)
    # its replica's host arrays; the driver's swapped-in params
    del engine, collect, logging_collect, driver, logits, swapped
    gc.collect()
    rec["int8"] = int8_flush(cfg, initial, state.params, device,
                             zero=not keep_initial)
    rec["int8"]["from"] = "the initial params'" if keep_initial \
        else "a zeroed"
    del initial
    # one more train step, profiled (after every count and comparison)
    batch = next(batches)
    batch = {**batch, "tokens": torch.from_numpy(batch["tokens"]).to(device)}
    rec["profile"] = profile_call(lambda: step_fn(state, batch), device)
    return {"cfg": cfg, "args": args, "run": rec, "argv": train_argv,
            "min_flushes": min_flushes}


def expert_flushes(cfg, engine, routed: list, min_flushes: int = 2) -> dict:
    """The expert leaves' classification and records against the counts
    each step reported (``routed``): each flush's expert record of a leaf
    holds the (repeat, expert) ids, ``rep * E + expert``, routed to in
    that layer since the last flush, or since the start under Adam /
    Momentum (cumulative mode). The flush at the sync clock's time ``t``
    follows the first ``t`` steps; the final one all of them. ``ok``
    wants at least ``min_flushes`` flushes with expert records."""
    from repro_torch.configs.base import MOE
    e = cfg.num_experts
    experts = sorted(p for p, k in engine.kinds.items() if k == "experts")
    shapes = {p: engine.replicas[0].host[p].shape for p in experts}
    routers = {p: k for p, k in engine.kinds.items()
               if p.endswith("/router")}
    by_t: dict = {}
    for r in _records(engine):
        if r.meta["kind"] == "experts":
            by_t.setdefault(r.meta["t"], {})[r.meta["path"]] = r.ids
    mode = engine._embed_mode
    match, dirty, last = True, [], 0
    for t in sorted(by_t):
        upto = min(int(t), len(routed))
        since = 0 if mode == "cumulative" else last
        for path, ids in by_t[t].items():
            si, pos = path.split("/")[1:3]
            c = sum(step[int(si)][pos] for step in routed[since:upto])
            reps, ex = np.nonzero(c > 0)
            match &= np.array_equal(np.sort(ids), reps * e + ex)
        dirty.append(sum(map(len, by_t[t].values()))
                     / sum(s[0] * s[1] for s in shapes.values()))
        last = upto
    positions = sum(spec.ffn == MOE for seg in cfg.segments
                    for spec in seg.pattern)
    ok = (match and len(experts) == 3 * positions
          and all(s[1] == e for s in shapes.values())
          and set(routers.values()) == {"dense"}
          and len(by_t) >= min_flushes)
    return {"leaves": {p: tuple(s) for p, s in shapes.items()},
            "ids": sorted({s[0] * s[1] for s in shapes.values()}),
            "routers": routers, "mode": mode, "match": match,
            "dirty": [round(d, 4) for d in dirty], "ok": ok}


# ---------------------------------------------------------------------------
# The MoE family: granite-moe-3b-a800m served and trained at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE_ARGV = ("--arch", MOE_ARCH, *SERVE_ARGV[2:])
MOE_TRAIN_STEPS = 4
# a sync period of 3 on the step clock: one flush after step 3, the final
MOE_TRAIN_ARGV = ("--arch", MOE_ARCH, "--steps", str(MOE_TRAIN_STEPS),
                  "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                  "--codec", "cast16", "--sync-period", "3", "--seed",
                  str(SEED), "--log-every", "2")
# the float32 step against the plain path runs 4 of the 32 layers: two
# float32 gradient sets of the whole model do not fit beside each other
MOE_F32_LAYERS = 4
MOE_GRAD_LEAVES = (("embed", "embed", None),
                   ("layer 0 router", "segments/0/pos0/ffn/router", 0),
                   ("layer 0 w_gate", "segments/0/pos0/ffn/w_gate", 0),
                   ("last layer w_down", "segments/0/pos0/ffn/w_down", -1))


def host_available() -> int:
    """The host's available memory in bytes (``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return -1


def moe_gather_rows(cfg, device) -> dict:
    """The MoE's two row gathers at the bf16 prefill's shapes (4 x 2048
    tokens from the seed, routed by a router at the model's init scale):
    the dispatch's, E * C buffer rows through the inverse slot map (an
    empty slot reads the zero row appended to the tokens), and the
    combine's, T * k assignment rows of the experts' output. Each is
    bit-equal to its plain version and timed beside its bound (the rows
    read once, the ids, the rows written), its plain version and
    ``index_select``. Returns them as extra entries of the gather's
    row."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    t, d, e, k = (PREFILL_BATCH * PREFILL_LEN, cfg.d_model, cfg.num_experts,
                  cfg.experts_per_token)
    xt = torch.randn((t, d), generator=gen, device=device).bfloat16()
    router = torch.randn((d, e), generator=gen, device=device) * d ** -0.5
    idx, _, _ = moe.route(router, xt, cfg)
    cap = moe.moe_capacity(t, cfg)
    buf, rows, keep, _ = moe._dispatch(xt, idx, cap, cfg)
    xt0 = torch.cat([xt, xt.new_zeros((1, d))])
    src = torch.full((e * cap,), t, device=device)
    src[rows[keep]] = torch.arange(t * k, device=device)[keep] // k
    flat = buf.reshape(-1, d)
    out = {}
    for what, table, ids in (("moe_dispatch", xt0, src.int()),
                             ("moe_combine", flat, rows.int())):
        got = ops.embedding_lookup(table, ids)
        if not torch.equal(got, ref.embedding_lookup(table, ids)):
            raise AssertionError(f"{what} gather: not bit-equal")
        distinct = int(ids.unique().numel())
        ids64 = ids.long()
        row = _row("embedding_lookup", "embedding_lookup.cu",
                   "src/repro/kernels/embedding_lookup.py:30", 0.0,
                   lambda: ops.embedding_lookup(table, ids),
                   lambda: ref.embedding_lookup(table, ids),
                   lambda: torch.index_select(table, 0, ids64),
                   (distinct + ids.numel()) * d * 2 + ids.numel() * 4,
                   f"{what}: {ids.numel()} ids ({distinct} distinct) x {d} "
                   f"bf16 from ({table.shape[0]}, {d})")
        out[what] = {key: row[key] for key in (
            "ms", "call_ms", "plain_ms", "bound_ms", "library_ms")}
    print(f"  MoE gathers at {t} tokens, capacity {cap} an expert: "
          f"{int(keep.sum())} of {t * k} assignments kept", flush=True)
    return out


def report_lm_train(lm: dict, f32: dict) -> None:
    """Print the LM-training phase's numbers and hold them to their
    limits."""
    cfg, args, rec = lm["cfg"], lm["args"], lm["run"]
    n, steps = cfg.num_layers, args.steps
    step_ms = np.array(rec["step_s"]) * 1e3
    p50 = float(np.percentile(step_ms, 50))
    tokens = args.batch * args.seq
    frames = args.batch * cfg.encoder_len
    flops = model_flops(cfg, args.batch, args.seq)
    print(f"LM training: {cfg.name} ({n} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {cfg.optimizer}, remat {cfg.remat}), random "
          f"weights from seed {SEED}; launcher {' '.join(lm['argv'])}, "
          f"sync clock = steps"
          + (f"; {cfg.encoder_len} frames a sequence, N(0, 1) from the "
             f"launcher's seed" if cfg.has_encoder_context else ""),
          flush=True)
    if f32 is not None:
        print(f"  float32 step ({f32['layers']} layers), kernel vs plain "
              f"path: loss {f32['loss']:.6f} vs {f32['plain_loss']:.6f} "
              f"(limit rtol {F32_LOSS_RTOL}); grads max |deviation| / max "
              f"|grad|: "
              + ", ".join(f"{k} {v:.3g}" for k, v in f32["grad_devs"].items())
              + f" (limit {F32_GRAD_BOUND}); peak device memory "
              f"{f32['peak_bytes']} bytes")
        if f32["routes"] is not None:
            print(_routes_line("float32 train step", f32["routes"]))
    print(f"  {steps} steps of {args.batch} x {args.seq}: step p50 "
          f"{p50:.3f} ms, p99 {np.percentile(step_ms, 99):.3f} ms "
          f"(first {step_ms[0]:.3f}); {tokens / p50 * 1e3:.0f} tokens/s"
          + (f" ({frames / p50 * 1e3:.0f} frames/s of {cfg.encoder_len} "
             f"a sequence)" if frames else "") + "; "
          f"model FLOPs {flops:.4g} a step, mfu {flops / (p50 / 1e3) / BF16_PEAK_FLOPS:.4f}"
          f" (of {BF16_PEAK_FLOPS:.4g}); loss {rec['losses'][0]:.4f} -> "
          f"{rec['losses'][-1]:.4f}; peak device memory "
          f"{rec.get('peak_bytes')} bytes; {rec['wall_s']:.1f} s in all "
          f"(build and replica bootstrap before it: {rec['build_s']:.1f} s)",
          flush=True)
    for i, fl in enumerate(rec["flushes"]):
        print(f"  flush {i}: {fl['s']:.3f} s, {fl['records']} records, "
              f"{fl['bytes']} bytes")
    print(f"  sync {rec['metrics']}; replica staleness vs the trained "
          f"params {rec['staleness']:.3g} (limit {STALENESS_BOUND})")
    if "experts" in rec:
        ex = rec["experts"]
        print(f"  experts: {ex['leaves']} classified \"experts\", each "
              f"{ex['ids']} (repeat, expert) ids; router leaves "
              f"{ex['routers']}; each flush's expert records hold the routed "
              f"pairs ({ex['mode']}): {ex['match']}; share of experts dirty "
              f"per flush {ex['dirty']}", flush=True)
    i8 = rec["int8"]
    print(f"  int8 flush (--codec int8, a dense leaf one codec row, an "
          f"expert leaf one a (repeat, expert) id, from "
          f"{i8['from']} replica): {i8['s']:.3f} s, {i8['records']} "
          f"records, {i8['bytes']} bytes (the cast16 flushes above: "
          + ", ".join(f"{fl['s']:.3f} s" for fl in rec["flushes"])
          + f"); launches quantize_rows {i8['launches']['quantize_rows']}, "
          f"dequantize_rows {i8['launches']['dequantize_rows']} (the plans "
          f"want {i8['want']}); replica staleness vs the trained params "
          f"{i8['staleness']:.3g} (limit "
          f"{INT8_STALENESS_BOUND}); largest leaf {i8['largest'][0]} "
          f"({i8['largest'][1]} elements, codes {i8['largest'][2]}) codes "
          f"and scales equal to the plain version's: {i8['largest_equal']}",
          flush=True)
    dec = rec["decode"]
    print(f"  hot swap of the replica's bf16 device params in "
          f"{dec['swap_s']:.3f} s, then {dec['steps']} decode steps: logits "
          f"finite {dec['finite']}; launches {dec['launches']}")
    print(_profile_line("train step", rec["profile"]))
    print(f"  launches in the training run: {rec['launches']}")
    moe, passes = _moe_layers(cfg), 2 if cfg.remat else 1
    attn = _attn_layers(cfg)
    # the token gather and its gradient, and a MoE's two row gathers a
    # pass (remat's recompute runs them again) and their two gradients
    want = {"embedding_scatter_add": steps * (1 + 2 * moe),
            "embedding_lookup": steps * (1 + 2 * passes * moe),
            "flash_attention": passes * _flash_layers(cfg, args.seq)
            * steps}
    if {k: rec["launches"][k] for k in want} != want:
        raise AssertionError(f"training launches {rec['launches']}, want "
                             f"{want}")
    want_dec = {"decode_attention": attn * dec["steps"],
                "embedding_lookup": dec["steps"] * (1 + 2 * moe)}
    if {k: dec["launches"][k] for k in want_dec} != want_dec:
        raise AssertionError(f"decode launches {dec['launches']}, want "
                             f"{want_dec}")
    if len(rec["flushes"]) < lm["min_flushes"]:
        raise AssertionError(f"{len(rec['flushes'])} flushes, want "
                             f"{lm['min_flushes']}")
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
    if "experts" in rec and not rec["experts"]["ok"]:
        raise AssertionError(f"expert records: {rec['experts']}")



# ---------------------------------------------------------------------------
# The SSM family: mamba2-1.3b served and trained at full width
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
SSM_SERVE_ARGV = ("--arch", SSM_ARCH, *SERVE_ARGV[2:])
# 4 steps and a sync period of 3 on the step clock, as MOE_TRAIN_ARGV
SSM_TRAIN_ARGV = ("--arch", SSM_ARCH, *MOE_TRAIN_ARGV[2:])
SSM_GRAD_LEAVES = (("embed", "embed", None),
                   ("layer 0 wx", "segments/0/pos0/mixer/wx", 0),
                   ("layer 0 dt_bias", "segments/0/pos0/mixer/dt_bias", 0),
                   ("last layer out_proj", "segments/0/pos0/mixer/out_proj",
                    -1))
CONSISTENCY_LEN = 64                # decode against forward, tokens
# Decode against forward at full depth: 48 layers of random weights
# amplify rounding ~10^4-fold, so in float32 and bf16 the two paths differ
# by as much as each differs from exact arithmetic (on the H100 float32
# decode vs forward 1.04e-3, each vs a float64 forward 1.33e-3 and
# 4.5e-4; bf16 1.49, 2.41 and 2.44; the reference's own bf16 decode
# deviates from its forward by 1.55, greedy 0.80, at d_model 512 and 48
# layers on the CPU: scripts/ssm_decode_drift.py). Decode and forward
# are held to each other in float64, where that amplification leaves
# ~1e-12; the float32 and bf16 runs are printed beside the float64
# forward.
F64_DECODE_ATOL = 1e-9
# the SSD against the step-by-step recurrence at mamba2's heads, float32
SSD_SHAPE = dict(batch=1, seq=2048, heads=64, head_dim=64, state=128,
                 chunk=256)
SSD_REC_BOUND = 2e-4                # of the largest magnitude


def _rel_dev(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def ssd_recurrence_check(device, *, batch: int, seq: int, heads: int,
                         head_dim: int, state: int, chunk: int,
                         seed: int = SEED + 29) -> dict:
    """``ssd_chunked`` against the step-by-step recurrence
    (``ssd_decode_step`` in a loop) in float32 on ``device``, forward and
    gradient: x, B, C from N(0, 1), dt through softplus from ``dt_bias``'s
    init log(e - 1) plus N(0, 0.5) (dt ≈ 1, where the reference's
    gradient overflows at a chunk of 256), A = -exp(0.3 N(0, 1)). The
    gradients are of ``sum(wy * y) + sum(wf * final_state)`` with
    respect to x, dt, B and C. Deviations are the largest |difference|
    over the recurrence's largest magnitude; also the chunked forward's
    time (the host clock around calls that end in a synchronize)."""
    import math

    import torch

    from repro_torch.models import ssm
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, B, C = (randn(batch, seq, heads, head_dim), randn(batch, seq, state),
               randn(batch, seq, state))
    dt = torch.logaddexp(math.log(math.e - 1) + 0.5 * randn(batch, seq,
                                                            heads),
                         torch.zeros((), device=device))
    A = -torch.exp(0.3 * randn(heads))
    wy, wf = randn(batch, seq, heads, head_dim), randn(batch, heads,
                                                       head_dim, state)

    def recurrence(x, dt, A, B, C):
        st = x.new_zeros((batch, heads, head_dim, state))
        ys = []
        for t in range(seq):
            y, st = ssm.ssd_decode_step(st, x[:, t], dt[:, t], A, B[:, t],
                                        C[:, t])
            ys.append(y)
        return torch.stack(ys, 1), st

    out = {}
    for name, fn in (("chunked", lambda *a: ssm.ssd_chunked(*a, chunk)),
                     ("recurrence", recurrence)):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, B, C)]
        y, fin = fn(ins[0], ins[1], A, ins[2], ins[3])
        ((y * wy).sum() + (fin * wf).sum()).backward()
        out[name] = (y.detach(), fin.detach(), [t.grad for t in ins])
        del y, fin, ins
    (yc, fc, gc_), (yr, fr, gr) = out["chunked"], out["recurrence"]
    grad_devs = {k: _rel_dev(a, b) for k, a, b in zip(("x", "dt", "B", "C"),
                                                      gc_, gr)}
    with torch.no_grad():
        ms = []
        for _ in range(4):                      # the first warms up
            t0 = time.perf_counter()
            ssm.ssd_chunked(x, dt, A, B, C, chunk)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"y_dev": _rel_dev(yc, yr), "state_dev": _rel_dev(fc, fr),
            "grad_devs": grad_devs, "grad_dev": max(grad_devs.values()),
            "finite": all(bool(torch.isfinite(g).all()) for g in gc_),
            "bound": SSD_REC_BOUND, "chunked_ms": float(np.median(ms[1:])),
            "shape": (batch, seq, heads, head_dim, state, chunk)}


def token_gather_row(cfg, device,
                     n: int = PREFILL_BATCH * PREFILL_LEN) -> dict:
    """The token gather at the bf16 prefill's shape: ``n`` (4 x 2048) ids
    from the (padded_vocab, d_model) bf16 table, bit-equal to its plain
    version and timed beside its bound and ``index_select``; returned as
    an extra entry of the gather's row."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                        device=device).bfloat16()
    ids = torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                        device=device, dtype=torch.int32)
    row = gather_row(table, ids, f"{cfg.padded_vocab}x{cfg.d_model} bf16, "
                     f"{n} token ids ({cfg.name}'s token gather)")
    return {k: row[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                "library_ms", "max_abs_err")}


@contextlib.contextmanager
def float64_math():
    """Inside, ``Tensor.float()`` widens to float64, the model takes
    ``dtype="float64"`` and its kernels run their plain versions
    (``plain_attention``): a forward or decode of float64 params then
    runs every float32 step of the model in float64, the exact
    arithmetic the float32 and bf16 paths are held against."""
    import torch

    from repro_torch.models import model
    plain = torch.Tensor.float
    torch.Tensor.float = lambda t: t.double() if t.is_floating_point() \
        else plain(t)
    model._DTYPES["float64"] = torch.float64
    try:
        with plain_attention():
            yield
    finally:
        torch.Tensor.float = plain
        del model._DTYPES["float64"]


def _decode_logits(cfg, params, tokens, cache_dtype, device, frames=None,
                   kv_quant: bool = False, keep: Optional[list] = None):
    """Logits (B, T, V) of decoding ``tokens`` (B, T) one at a time from
    a fresh cache of ``cache_dtype`` (float64: the SSM state too, which is
    float32 otherwise; ``kv_quant``: the int8 K/V cache), its cross
    entries first filled from ``frames`` (``precompute_cross_cache``) for
    a model with context; the cache at the end appended to ``keep``."""
    import torch

    from repro_torch.models import (decode_step, init_cache,
                                    precompute_cross_cache)
    b, t = tokens.shape
    cache = init_cache(cfg, b, t, dtype=cache_dtype, device=device,
                       kv_quant=kv_quant)
    if cache_dtype == torch.float64:
        cache = _tree_map(lambda x: x.double(), cache)
    if frames is not None:
        precompute_cross_cache(params, cfg, cache, frames)
    steps = []
    for i in range(t):
        logits, cache = decode_step(
            params, cfg, cache, tokens[:, i:i + 1],
            torch.full((b,), i, dtype=torch.int32, device=device))
        steps.append(logits)
    if keep is not None:
        keep.append(cache)
    return torch.stack(steps, 1)


def decode_vs_forward(cfg, params, tokens, device, frames=None) -> dict:
    """Decode ``tokens`` (B, T) one at a time from a fresh cache (a model
    with context's cross cache precomputed from ``frames``) and hold
    each step's logits against a forward over the same T tokens: in
    float64 (``float64_math``: params, cache and every float32 step
    widened, the plain path), where the two must agree to
    ``F64_DECODE_ATOL``; then on the kernel path in float32 (params and
    cache) and in bf16 (params and a bf16 cache), each path also against
    the float64 forward. Returns for each dtype the largest |deviation|
    and greedy agreement of decode vs forward (``dev``) over the real
    vocabulary, for float32 and bf16 the largest |deviation| of the
    decode (``dec``) and of the forward (``fwd``) from float64, and the
    forwards, cross-cache fills (``encodes``) and steps run on the
    kernel path."""
    import torch

    from repro_torch.models import forward
    out = {"forwards": 0, "steps": 0, "encodes": 0}
    runs = [("float64", torch.float64), ("float32", torch.float32),
            ("bf16", torch.bfloat16)]
    with torch.no_grad():
        for label, dt in runs:
            c = dataclasses.replace(cfg, dtype=str(dt)[6:],
                                    param_dtype=str(dt)[6:])
            p = params if c.param_dtype == cfg.param_dtype \
                else _tree_map(lambda x: x.to(dt), params)
            enc = None if frames is None else (
                frames.double() if dt == torch.float64 else frames)
            with (float64_math() if dt == torch.float64
                  else contextlib.nullcontext()):
                full, _ = forward(p, c, tokens, enc_context=enc)
                dec = _decode_logits(c, p, tokens, dt, device, enc)
            out[label] = {"dev": _logit_dev(dec, full, cfg.vocab_size)}
            if dt == torch.float64:        # the deviation in float64 too
                out[label]["dev"] = (float((dec - full)[
                    ..., :cfg.vocab_size].abs().max()),
                    out[label]["dev"][1])
                exact = full
            else:
                out[label]["dec"] = _logit_dev(dec, exact,
                                               cfg.vocab_size)[0]
                out[label]["fwd"] = _logit_dev(full, exact,
                                               cfg.vocab_size)[0]
                out["forwards"] += 1
                out["steps"] += tokens.shape[1]
                out["encodes"] += frames is not None
            del p, full, dec
    return out


def drive_ssm(device, serve_argv, *, prefill_batch: int, prefill_len: int,
              prefill_reps: int, seed: int = SEED) -> dict:
    """An attention-free model's serving path through its entry points:
    ``launch.serve`` builds the model and its ``ServeDriver`` (float32
    cache) from ``serve_argv``; ``make_prefill_step`` runs ``prefill_len``
    tokens float32 and bf16 against the plain path; the launcher's own
    decode run (hot swaps and all) is replayed on the plain path; then
    decode against forward over the prefill's first ``CONSISTENCY_LEN``
    tokens. The launch counters are reset before and read after the
    whole path."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args([*serve_argv, "--device", device.type])
    cfg, params, driver, gen = serve.build(args)
    data = torch.Generator(device=device).manual_seed(seed + 7)
    tokens = torch.randint(0, cfg.vocab_size, (prefill_batch, prefill_len),
                           generator=data, device=device)
    cache = driver.cache["segments"]
    sizes = {"param_bytes": _tree_bytes(params),
             "conv_bytes": sum(_tree_bytes(pos["conv"]) for seg in cache
                               for pos in seg.values()),
             "state_bytes": sum(_tree_bytes(pos["state"]) for seg in cache
                                for pos in seg.values())}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prefill = prefill_phase(cfg, params, tokens, prefill_reps, device)
    serve_run = decode_run(cfg, driver, params, args, gen, device)
    driver.hot_swap(params)             # frees its last swapped-in copy
    consistency = decode_vs_forward(cfg, params,
                                    tokens[:, :CONSISTENCY_LEN], device)
    launches = ops.launch_counts()
    if device.type == "cuda":
        sizes["peak_bytes"] = torch.cuda.max_memory_allocated()
    return {"cfg": cfg, "prefill": prefill, "serve": serve_run,
            "consistency": consistency, "launches": launches,
            "sizes": sizes}


def report_ssm(lm: dict, ssd: dict) -> None:
    """Print the SSM serving phase's numbers and hold them to their
    limits."""
    cfg, pre, run, cons = lm["cfg"], lm["prefill"], lm["serve"], \
        lm["consistency"]
    launches, sizes = lm["launches"], lm["sizes"]
    p50 = float(np.percentile(pre["ms"], 50))
    lat = run["lat_ms"]
    steps = run["steps"] + cons["steps"]
    forwards = pre["forwards"] + cons["forwards"]
    print(f"SSM serving: {cfg.name} at full width ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
          f"{cfg.ssm_num_heads} heads of {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}),"
          f" random weights from seed {SEED}; params "
          f"{sizes['param_bytes']} bytes, SSM cache (batch "
          f"{PREFILL_BATCH}, float32) conv {sizes['conv_bytes']} + state "
          f"{sizes['state_bytes']} bytes, peak device memory "
          f"{sizes.get('peak_bytes')} bytes", flush=True)
    print(f"  ssd_chunked vs the step-by-step recurrence at (batch, seq, "
          f"heads, head_dim, state, chunk) {ssd['shape']}, float32: y "
          f"{ssd['y_dev']:.3g}, final state {ssd['state_dev']:.3g}, grads "
          + ", ".join(f"{k} {v:.3g}" for k, v in ssd["grad_devs"].items())
          + f" of the largest magnitude (limit {ssd['bound']}); grads "
          f"finite {ssd['finite']}; the chunked forward "
          f"{ssd['chunked_ms']:.3f} ms")
    print(f"  prefill {PREFILL_BATCH} x {PREFILL_LEN} bf16: p50 {p50:.3f} ms "
          f"over {len(pre['ms'])} "
          f"({PREFILL_BATCH * PREFILL_LEN / p50 * 1e3:.0f} tokens/s); "
          f"logits vs the plain path: float32 max deviation "
          f"{pre['f32_dev']:.3g} (limit {F32_LOGIT_ATOL}), bf16 "
          f"{pre['bf16_dev']:.3g} (limit {BF16_LOGIT_BOUND}); greedy tokens "
          f"agree {pre['f32_agree']:.4f} (f32), {pre['bf16_agree']:.4f} "
          f"(bf16)")
    print(f"  decode, launcher's run (float32 cache, bf16 params): "
          f"{run['steps']} steps, p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms per step (4 tokens/step: "
          f"{4 / np.percentile(lat, 50) * 1e3:.1f} tokens/s), "
          f"{run['wall_s']:.2f} s with hot swaps; embedding_lookup once a "
          f"step, no attention kernel; logits finite "
          f"{run['finite']}; teacher-forced logits vs the plain path: max "
          f"deviation {run['max_dev']:.3g} (limit {BF16_LOGIT_BOUND}), "
          f"greedy tokens agree {run['agree']:.4f}", flush=True)
    report_consistency(cons)
    print(_profile_line(f"bf16 prefill ({PREFILL_BATCH} x {PREFILL_LEN})",
                        pre["profile"]))
    share = pre["ssm"]
    print(f"  Mamba share of one bf16 prefill's stream time "
          f"({share['forward_ms']:.3f} ms, stamps around each part): "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / share['forward_ms']:.1f}"
                      f"%)" for k, v in share["ms"].items()))
    print(f"  launches in the SSM path: {launches} ({forwards} forwards "
          f"and {steps} decode steps on the kernel path)", flush=True)
    want = {"flash_attention": 0, "decode_attention": 0,
            "embedding_lookup": forwards + steps}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"SSM launches {launches}, want {want}")
    if not (ssd["finite"] and max(ssd["y_dev"], ssd["state_dev"],
                                  ssd["grad_dev"]) <= ssd["bound"]):
        raise AssertionError(f"ssd_chunked vs the recurrence: {ssd}")
    if pre["f32_dev"] > F32_LOGIT_ATOL:
        raise AssertionError(f"float32 prefill logits deviate from the "
                             f"plain path by {pre['f32_dev']:.3g}")
    worst = max(pre["bf16_dev"], run["max_dev"])
    if worst > BF16_LOGIT_BOUND or not run["finite"]:
        raise AssertionError(f"bf16 logits deviate from the plain path by "
                             f"{worst:.3g} or the launcher's are not finite")


# ---------------------------------------------------------------------------
# Sliding-window attention: gemma3-4b served and trained at full width
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma3-4b"
GEMMA_SERVE_ARGV = ("--arch", GEMMA_ARCH, *SERVE_ARGV[2:])
# 4 steps and a sync period of 3 on the step clock, as MOE_TRAIN_ARGV
GEMMA_TRAIN_ARGV = ("--arch", GEMMA_ARCH, *MOE_TRAIN_ARGV[2:])
GEMMA_GRAD_LEAVES = (("embed", "embed", None),
                     ("layer 0 wq", "segments/0/pos0/mixer/wq", 0),
                     ("last layer w_down", "segments/1/pos0/ffn/w_down",
                      -1))
# decode against forward over CONSISTENCY_LEN tokens with the window cut to
# 16 rows: the forward takes the block-local branch (64 % 16 == 0) and
# every ring wraps three times; at the published 1024 neither happens
GEMMA_CHECK_WINDOW = 16
# one sliding-window layer at full width against a float64 oracle: S
# spans two windows, so the block-local branch runs, float32
WINDOW_ORACLE_LEN = 2048
WINDOW_ORACLE_BOUND = 1e-5          # of the largest magnitude
# decode positions of a batch of 4 against the 1,024-row ring: before the
# first wrap, across it, and two wraps on
RING_POSITIONS = ((0, 511, 1022, 1023), (1024, 1500, 2047, 2048),
                  (2600, 3071, 3072, 4000))


def check_ring_decode(cfg, device) -> list[str]:
    """``decode_attention`` against its plain version on a sliding-window
    layer's ring of ``window_size`` rows at lengths ``min(pos + 1, W)``
    for ``RING_POSITIONS``, within 2e-5 (float32) and 2e-2 (bf16)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 37)
    h, g, d, w = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.window_size
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    lines = []
    for q_dtype, kv_dtype in ((torch.float32, torch.float32),
                              (torch.bfloat16, torch.float32),
                              (torch.bfloat16, torch.bfloat16)):
        k, v = (torch.randn((4, w, g, d), generator=gen, device=device)
                .to(kv_dtype) for _ in range(2))
        worst = 0.0
        for pos in RING_POSITIONS:
            lengths = torch.clamp(torch.tensor(pos, device=device,
                                               dtype=torch.int32) + 1, max=w)
            q = torch.randn((4, h, d), generator=gen, device=device).to(
                q_dtype)
            worst = max(worst, _check_close(
                "decode_attention on the ring",
                da.decode_attention(q, k, v, lengths),
                ref.decode_attention(q, k, v, lengths), tol[q_dtype]))
        lines.append(f"decode_attention q (4, {h}, {d}) {str(q_dtype)[6:]} "
                     f"vs a ring (4, {w}, {g}, {d}) {str(kv_dtype)[6:]} at "
                     f"lengths min(pos + 1, {w}), positions "
                     f"{RING_POSITIONS}: max deviation {worst:.3g}")
    _sync(device)
    return lines


def window_oracle_check(cfg, device, seq: int) -> dict:
    """One sliding-window layer's ``self_attention`` at full width on 1 x
    ``seq`` tokens in float32 (seq > window, a multiple of it: the
    block-local branch) against a float64 oracle written from the
    definition: a causal softmax over the keys ``i - W < j <= i``,
    computed over the whole (seq, seq) square. Projections, scores,
    softmax and output run in float64; the rotation is the model's own
    (float32 angles, as the reference's). Weights at the model's init
    scale from the seed. Returns the largest deviation over the oracle's
    largest magnitude and the layer's time (host clock around calls that
    end in a synchronize)."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models.common import dense_init, rope
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    d, h, g, e, w = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.window_size)
    f32 = torch.float32
    p = {"wq": dense_init(gen, (d, h, e), d, f32),
         "wk": dense_init(gen, (d, g, e), d, f32),
         "wv": dense_init(gen, (d, g, e), d, f32),
         "wo": dense_init(gen, (h, e, d), h * e, f32)}
    x = torch.randn((1, seq, d), generator=gen, device=device)
    pos = torch.arange(seq, device=device)[None]
    with torch.no_grad():
        got = attn.self_attention(p, x, pos, cfg=cfg, window=w)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            attn.self_attention(p, x, pos, cfg=cfg, window=w)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        p64, x64 = {k: v.double() for k, v in p.items()}, x.double()
        q = rope(torch.einsum("bsd,dhe->bshe", x64, p64["wq"]), pos,
                 cfg.rope_theta)
        k = rope(torch.einsum("bsd,dge->bsge", x64, p64["wk"]), pos,
                 cfg.rope_theta).repeat_interleave(h // g, dim=2)
        v = torch.einsum("bsd,dge->bsge", x64, p64["wv"]).repeat_interleave(
            h // g, dim=2)
        scores = torch.einsum("bshe,bthe->bhst", q, k) * e ** -0.5
        i, j = pos[0][:, None], pos[0][None, :]
        scores.masked_fill_(~((j <= i) & (j > i - w)), float("-inf"))
        out = torch.einsum("bhst,bthe->bshe", torch.softmax(scores, -1), v)
        want = torch.einsum("bshe,hed->bsd", out, p64["wo"])
    return {"dev": _rel_dev(got, want), "bound": WINDOW_ORACLE_BOUND,
            "finite": bool(torch.isfinite(got).all()),
            "ms": float(np.median(ms)), "shape": (1, seq, d), "window": w}


def window_serving_phase(dev, by_name: dict) -> dict:
    """Phase 6d: gemma3-4b served at full width. The kernels at its
    shapes against their plain versions (flash and the global decode as
    ``check_lm_kernels``, the decode on a ring, the token gather timed),
    one block-local layer against the float64 oracle, then ``drive_lm``
    with ``GEMMA_SERVE_ARGV`` and decode against forward at a window of
    ``GEMMA_CHECK_WINDOW``. The kernels' timing rows at its shapes ride
    on ``by_name``'s entries; returns the path's launches."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(GEMMA_ARCH)
    print(f"Sliding-window serving: host memory available "
          f"{host_available()} bytes; LM kernels against their plain "
          f"versions at {GEMMA_ARCH}'s shapes:", flush=True)
    for line in check_lm_kernels(cfg, dev) + check_ring_decode(cfg, dev):
        print(f"  {line}")
    by_name["embedding_lookup"][GEMMA_ARCH] = token_gather_row(cfg, dev)
    oracle = window_oracle_check(cfg, dev, seq=WINDOW_ORACLE_LEN)
    print(f"  one sliding-window layer's self_attention at {oracle['shape']},"
          f" window {oracle['window']}, float32 (the block-local branch) vs "
          f"a float64 masked-softmax oracle: {oracle['dev']:.3g} of the "
          f"largest magnitude (limit {oracle['bound']}), finite "
          f"{oracle['finite']}; {oracle['ms']:.3f} ms a call", flush=True)
    if not (oracle["finite"] and oracle["dev"] <= oracle["bound"]):
        raise AssertionError(f"block-local attention vs the oracle: {oracle}")
    lm = drive_lm(dev, GEMMA_SERVE_ARGV, prefill_batch=PREFILL_BATCH,
                  prefill_len=PREFILL_LEN, prefill_reps=PREFILL_REPS,
                  long_len=LONG_LEN, long_pos=LONG_POS, long_steps=LONG_STEPS,
                  consistency_window=GEMMA_CHECK_WINDOW)
    report_lm(lm)
    timed = lm_kernel_rows(cfg, lm.pop("decode_inputs"), dev)
    timed.append(decode_row(cfg, lm.pop("ring_inputs"), torch.Generator(
        device=dev).manual_seed(SEED + 43), dev))
    for row, key in zip(timed, (GEMMA_ARCH, GEMMA_ARCH,
                                f"{GEMMA_ARCH} ring")):
        by_name[row["name"]][key] = {k: row[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}
    return lm["launches"]


def window_training_phase(dev, by_name: dict) -> tuple[dict, dict]:
    """Phase 7d: gemma3-4b trained at full width (bf16, Adam, remat): the
    scatter-add at its shape (its timing row rides on ``by_name``'s
    entry), one float32 step against the plain path at all 34 layers,
    ``drive_lm_train`` with ``GEMMA_TRAIN_ARGV`` on its depth cut
    (``TRAIN_DEPTH_CUTS``). Returns the launches of the training run and
    of its hot-swap decode."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(GEMMA_ARCH)
    print(f"Sliding-window training: host memory available "
          f"{host_available()} bytes; the embedding gradient at "
          f"{GEMMA_ARCH}'s shape:", flush=True)
    sa = scatter_add_row(cfg, dev, split=False)
    by_name["embedding_scatter_add"][GEMMA_ARCH] = {k: sa[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err")}
    f32 = check_train_f32(cfg, dev, GEMMA_GRAD_LEAVES)
    torch.cuda.empty_cache()
    lm = drive_lm_train(dev, GEMMA_TRAIN_ARGV, decode_steps=SWAP_DECODE_STEPS,
                        cfg=train_cut(GEMMA_ARCH))
    report_lm_train(lm, f32)
    return lm["run"]["launches"], lm["run"]["decode"]["launches"]


# ---------------------------------------------------------------------------
# The encoder-decoder: whisper-medium served and trained at full width
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-medium"
# the decoder's context is bounded at 448 tokens: prefill 4 x 448 on 4 x
# 1500 frames; the launcher's run at --max-len 448; the long run's self
# caches seeded to 384 of the 448 rows
ENCDEC_LEN, ENCDEC_LONG_POS, ENCDEC_STEPS = 448, 384, 32
ENCDEC_SERVE_ARGV = ("--arch", ENCDEC_ARCH, "--batch", "4", "--steps", "32",
                     "--max-len", str(ENCDEC_LEN), "--hot-swap-every", "8",
                     "--seed", str(SEED))
# 4 steps of 4 x 448 tokens on the launcher's 4 x 1500 N(0, 1) frames from
# the seed (the reference's launcher's zero frames overflow the encoder's
# backward to NaN: ROADMAP queue 3), a sync period of 3 on the step clock,
# as MOE_TRAIN_ARGV
ENCDEC_TRAIN_ARGV = ("--arch", ENCDEC_ARCH, "--steps", str(MOE_TRAIN_STEPS),
                     "--batch", str(TRAIN_BATCH), "--seq", str(ENCDEC_LEN),
                     "--codec", "cast16", "--sync-period", "3", "--seed",
                     str(SEED), "--log-every", "2")
# an encoder layer's wq (its gradient through the whole non-causal
# backward), the first cross layer's wk and wv (through the cross
# attention's dk and dv), the encoder's final norm (the frames' every
# path to the loss) and the last layer's w_down
ENCDEC_GRAD_LEAVES = (
    ("embed", "embed", None),
    ("encoder layer 0 wq", "encoder/segments/0/pos0/mixer/wq", 0),
    ("cross layer 0 wk", "segments/0/pos1/mixer/wk", 0),
    ("cross layer 0 wv", "segments/0/pos1/mixer/wv", 0),
    ("encoder final_norm", "encoder/final_norm", None),
    ("last layer w_down", "segments/0/pos1/ffn/w_down", -1))


def check_encdec_kernels(cfg, device) -> list[str]:
    """Both attention kernels against their plain versions at the
    encoder-decoder's shapes, within 2e-5 (float32) and 2e-2 (bf16):
    flash causal over the decoder's 448 tokens, full over the encoder's
    T frames, and full of 448 queries against T frames (cross); decode
    against a 448-row self cache at mixed lengths and against a T-row
    cross cache at T."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(SEED + 59)
    h, g, d, t = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.encoder_len
    b, s = PREFILL_BATCH, ENCDEC_LEN
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    lines = []
    for label, sq, skv, causal in (("causal (self)", s, s, True),
                                   ("full (encoder)", t, t, False),
                                   ("full (cross)", s, t, False)):
        for dtype in (torch.bfloat16, torch.float32):
            q = _attn_inputs(b, h, g, sq, d, dtype, gen, device)[0]
            _, k, v = _attn_inputs(b, h, g, skv, d, dtype, gen, device)
            dev = _check_close("flash_attention",
                               fa.flash_attention(q, k, v, causal=causal),
                               ref.flash_attention(q, k, v, causal=causal),
                               tol[dtype])
            lines.append(f"flash_attention q ({b}, {h}, {sq}, {d}), k, v "
                         f"({b}, {g}, {skv}, {d}) {label} "
                         f"{str(dtype)[6:]}: max deviation {dev:.3g}")
    for label, rows, lengths in (
            ("a self cache", s, [1, 64, ENCDEC_LONG_POS + 1, s]),
            ("a cross cache", t, [t] * 4)):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
        for q_dtype, kv_dtype in ((torch.float32, torch.float32),
                                  (torch.bfloat16, torch.float32),
                                  (torch.bfloat16, torch.bfloat16)):
            q = torch.randn((4, h, d), generator=gen, device=device).to(
                q_dtype)
            k, v = (torch.randn((4, rows, g, d), generator=gen,
                                device=device).to(kv_dtype)
                    for _ in range(2))
            dev = _check_close("decode_attention",
                               da.decode_attention(q, k, v, lengths),
                               ref.decode_attention(q, k, v, lengths),
                               tol[q_dtype])
            lines.append(f"decode_attention q (4, {h}, {d}) "
                         f"{str(q_dtype)[6:]} vs {label} (4, {rows}, {g}, "
                         f"{d}) {str(kv_dtype)[6:]}, lengths "
                         f"{lengths.tolist()}: max deviation {dev:.3g}")
    _sync(device)
    return lines


def encdec_kernel_rows(cfg, cross_inputs, device) -> dict:
    """The two attention kernels timed at the encoder-decoder's own
    modes: flash full over the encoder's (4, H, T, hd) bf16 (row 9w),
    flash of the decoder's 448 bf16 queries against (4, Kv, T, hd) (9x),
    and decode of a bf16 query against ``cross_inputs``, a layer's
    float32 cross cache of the long run, at T (10x). Returns ``{row:
    entry}``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    b, h, g, d, t = (PREFILL_BATCH, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.encoder_len)
    rows = {}
    for key, sq in (("encoder", t), ("cross", ENCDEC_LEN)):
        q = _attn_inputs(b, h, g, sq, d, torch.bfloat16, gen, device)[0]
        _, k, v = _attn_inputs(b, h, g, t, d, torch.bfloat16, gen, device)
        rows[key] = flash_row(q, k, v, False, f"full ({key})")
    rows["cross decode"] = decode_row(cfg, (*cross_inputs, t), gen, device)
    return rows


def encdec_serving_phase(dev, by_name: dict) -> dict:
    """Phase 6e: whisper-medium served at full width. The attention
    kernels at its shapes against their plain versions, then
    ``drive_lm`` with ``ENCDEC_SERVE_ARGV`` (prefill 4 x 448 on 4 x 1500
    frames; the launcher's run, which precomputes the cross cache; a
    long run from position 384 of 448) and decode against forward over
    ``CONSISTENCY_LEN`` tokens after ``precompute_cross_cache``. The
    kernels' timing rows 9w, 9x and 10x ride on ``by_name``'s entries;
    returns the path's launches."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    print(f"Encoder-decoder serving: host memory available "
          f"{host_available()} bytes; LM kernels against their plain "
          f"versions at {ENCDEC_ARCH}'s shapes:", flush=True)
    for line in check_encdec_kernels(cfg, dev):
        print(f"  {line}")
    by_name["embedding_lookup"][ENCDEC_ARCH] = token_gather_row(
        cfg, dev, PREFILL_BATCH * ENCDEC_LEN)
    torch.cuda.empty_cache()
    lm = drive_lm(dev, ENCDEC_SERVE_ARGV, prefill_batch=PREFILL_BATCH,
                  prefill_len=ENCDEC_LEN, prefill_reps=PREFILL_REPS,
                  long_len=ENCDEC_LEN, long_pos=ENCDEC_LONG_POS,
                  long_steps=ENCDEC_STEPS, consistency_window=0)
    report_lm(lm)
    pre = lm["prefill"]
    frames_s = PREFILL_BATCH * cfg.encoder_len / float(
        np.percentile(pre["ms"], 50)) * 1e3
    print(f"  encoder-decoder prefill: {_encoder_layers(cfg)} encoder, "
          f"{_attn_layers(cfg) // 2} self and {_attn_layers(cfg) // 2} "
          f"cross flash launches a forward ({pre['per_forward']} in all), "
          f"{_encoder_layers(cfg)} a precompute_cross_cache, "
          f"{_attn_layers(cfg)} decode launches a step; "
          f"{frames_s:.0f} frames/s beside the tokens/s above", flush=True)
    for key, row in encdec_kernel_rows(cfg, lm.pop("cross_inputs"),
                                       dev).items():
        by_name[row["name"]][f"{ENCDEC_ARCH} {key}"] = {k: row[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}
    lm.pop("decode_inputs")
    return lm["launches"]


def encdec_training_phase(dev, by_name: dict) -> tuple[dict, dict]:
    """Phase 7e: whisper-medium trained at full width (bf16, Adam,
    remat): the scatter-add at its shape (its timing row rides on
    ``by_name``'s entry), one float32 step against the plain path at all
    72 sub-layers on frames from the seed (``ENCDEC_GRAD_LEAVES``),
    ``drive_lm_train`` with ``ENCDEC_TRAIN_ARGV`` (the launcher's
    frames). Returns the launches of the training run and of its
    hot-swap decode."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC_ARCH)
    print(f"Encoder-decoder training: host memory available "
          f"{host_available()} bytes; the embedding gradient at "
          f"{ENCDEC_ARCH}'s shape:", flush=True)
    sa = scatter_add_row(cfg, dev, split=False, seq=ENCDEC_LEN)
    by_name["embedding_scatter_add"][ENCDEC_ARCH] = {k: sa[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err")}
    f32 = check_train_f32(cfg, dev, ENCDEC_GRAD_LEAVES, seq=ENCDEC_LEN)
    torch.cuda.empty_cache()
    lm = drive_lm_train(dev, ENCDEC_TRAIN_ARGV,
                        decode_steps=SWAP_DECODE_STEPS)
    report_lm_train(lm, f32)
    return lm["run"]["launches"], lm["run"]["decode"]["launches"]


# ---------------------------------------------------------------------------
# The hybrid family: jamba-1.5-large-398b served and trained at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-1.5-large-398b"
# Every published width (d_model 8,192, 64 heads of 128, 8 KV, d_ff 24,576,
# vocab 65,536, SSM state 128 in 256 heads of 64, conv 4, top-2, capacity
# 1.25); one period (8 of 72 layers) and fewer of the 16 experts: 8 to
# serve in bf16 (25.82B params, 51.6 GB); 2 (11.32B) for the float32
# checks (45.3 GB), for the launcher's run with hot swaps (it holds the
# drawn params, the driver's swapped-in copy and the next one: 3 x 22.6 GB
# of bf16) and for training (params and grads 45.3 GB on the card; on the
# host the replica's float32 params, 45.3 GB, beside a cast16 flush's
# records, 22.6 GB: 4 experts would need 64.6 + 32.3 GB, more than the
# host's 96 GiB holds with the process beside them)
HYBRID_SERVE_EXPERTS, HYBRID_SMALL_EXPERTS = 8, 2
HYBRID_DECODE_STEPS = 16            # each long-cache decode: bf16, int8
HYBRID_F32_BATCH = 2                # the float32 per-position check, x 2048
# float32 kernel path vs plain path after each of the period's positions,
# of the position's largest |x|; and float32 decode vs forward logits
# over CONSISTENCY_LEN tokens (set in PERF.md before the first run)
HYBRID_POSITION_BOUND = 1e-4
HYBRID_DECODE_BOUND = 1e-3
# bf16 at 8 experts, the prefill's inputs: each position's output on the
# kernel path from the plain path's input to it, of its largest |x|: the
# kernels' own bf16 tolerance
HYBRID_BF16_POSITION_BOUND = 2e-2
# float32 decode against forward with the int8 cache: twice the reference's
# own divergence on reduced jamba (1.12; its one attention layer feeds
# seven Mamba layers, whose states carry a token's int8 error onward), the
# CPU test's rule; 0.873 at full width on the card
HYBRID_INT8_DECODE_BOUND = 2.24
# Adafactor's transient at a leaf, in float32 slices: one buffer, plus the
# CUDA reduction workspace of the mean over rows (measured 1.125 and 1.17
# slices at jamba's tables and expert leaves; PERF.md predicted one); the
# whole-leaf update held about six float32 copies of the leaf
ADAFACTOR_SLICES = 1.5
HYBRID_SERVE_ARGV = ("--arch", HYBRID_ARCH, *SERVE_ARGV[2:])
# one cast16 flush: the sync clock counts steps, and a period of 5 over 4
# steps leaves only the final flush
HYBRID_TRAIN_ARGV = ("--arch", HYBRID_ARCH, "--steps", str(MOE_TRAIN_STEPS),
                     "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                     "--codec", "cast16", "--sync-period", "5", "--seed",
                     str(SEED), "--log-every", "1")


# Depth cuts of three earlier paths' training runs, so that the whole
# smoke with the hybrid phases stays within its time (their host flushes
# take ~5 s a GB of params): the repeats every segment keeps, every width
# as published (granite 8 of 32 layers, mamba2 12 of 48, gemma3 one
# period and one tail layer, 7 of 34). Their float32 checks and serving
# paths stay at full depth; qwen2-1.5b and whisper-medium train at full
# depth.
TRAIN_DEPTH_CUTS = {"granite-moe-3b-a800m": 8, "mamba2-1.3b": 12,
                    "gemma3-4b": 1}


def train_cut(arch: str):
    """``arch``'s config with its training run's depth cut
    (``TRAIN_DEPTH_CUTS``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Segment
    cfg, keep = get_config(arch), TRAIN_DEPTH_CUTS[arch]
    cut = lambda segs: tuple(Segment(seg.pattern, min(seg.repeats, keep))
                             for seg in segs)
    return dataclasses.replace(cfg, segments=cut(cfg.segments),
                               encoder_segments=cut(cfg.encoder_segments))


def hybrid_config(experts: int, dtype: str = "bfloat16"):
    """jamba cut to one period and ``experts`` experts, every width the
    published one; ``dtype`` its activations' and params' dtype."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Segment
    full = get_config(HYBRID_ARCH)
    return dataclasses.replace(
        full, segments=(Segment(full.segments[0].pattern, 1),),
        num_experts=experts, dtype=dtype, param_dtype=dtype)


def hybrid_reduced(cfg) -> str:
    """The cut of ``cfg`` against the published config, as printed."""
    from repro_torch.configs import get_config
    full = get_config(HYBRID_ARCH)
    return (f"reduced: depth {cfg.num_layers} of {full.num_layers} layers "
            f"(one period), experts {cfg.num_experts} of "
            f"{full.num_experts}; {cfg.param_counts()['total']} params")


@contextlib.contextmanager
def record_blocks(log: list):
    """Every layer's call inside appended to ``log``, in order: the
    arguments of ``models.model._block`` and its output x.
    ``_run_segments`` looks ``_block`` up on the module at each call, so
    wrapping it there is enough."""
    from repro_torch.models import model
    block = model._block

    def recording(*args):
        out = block(*args)
        log.append((args, out[0].detach()))
        return out

    model._block = recording
    try:
        yield log
    finally:
        model._block = block


def hybrid_positions_check(cfg, tokens, device) -> dict:
    """Float32 at full width (``cfg`` at 2 experts: every token takes both,
    so no route can flip): one forward of ``tokens`` on the kernel path
    and one on the plain path, their logits held within
    ``F32_LOGIT_ATOL``; each position of the period run again on the
    kernel path from the plain path's input to it, its output within
    ``HYBRID_POSITION_BOUND`` of the largest |x| of the plain path's
    (position-local: the paths differ only in a kernel, so a position
    without one must agree exactly), and the two forwards' outputs
    after each position printed (the deviation each position passes
    on); then decode against forward over the first ``CONSISTENCY_LEN``
    tokens of each row from fresh float32 caches, float and int8, the
    float one within ``HYBRID_DECODE_BOUND``. Returns the deviations,
    the kernel path's forwards, decode steps and position reruns, and
    the peak memory; and, the period's first layer being its attention
    layer (whose K/V rows come from the token alone, the same in both
    decodes), whether the int8 cache's codes and scales there equal
    ``attention._quantize_row`` of the float cache's rows."""
    import torch

    from repro_torch.configs.base import ATTN, MAMBA
    from repro_torch.models import attention, forward, init_params, model
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    params = init_params(cfg, gen)
    out = {"param_bytes": _tree_bytes(params)}
    kernel, plain = [], []
    with torch.no_grad():
        with record_blocks(kernel):
            logits, _ = forward(params, cfg, tokens)
        with plain_attention(), record_blocks(plain):
            plain_logits, _ = forward(params, cfg, tokens)
    specs = cfg.layer_specs()
    names = [f"pos{i} {spec.mixer}+{spec.ffn}" for i, spec in
             enumerate(specs)]
    out["carried"] = [(n, float((a - b).abs().max() / b.abs().max()))
                      for n, (_, a), (_, b) in zip(names, kernel, plain)]
    with torch.no_grad():
        out["positions"] = [
            (n, float((model._block(*args)[0] - b).abs().max()
                      / b.abs().max()))
            for n, (args, b) in zip(names, plain)]
    out["logits"] = _logit_dev(logits, plain_logits, cfg.vocab_size)
    out["finite"] = bool(torch.isfinite(logits).all())
    del kernel, plain, logits, plain_logits
    short = tokens[:, :CONSISTENCY_LEN]
    caches: list = []
    with torch.no_grad():
        full, _ = forward(params, cfg, short)
        for key, quant in (("decode", False), ("int8 decode", True)):
            dec = _decode_logits(cfg, params, short, torch.float32, device,
                                 kv_quant=quant, keep=caches)
            out[key] = _logit_dev(dec, full, cfg.vocab_size)
    if specs[0].mixer != ATTN:
        raise AssertionError("the int8 cache check wants the period's "
                             "attention layer first")
    fl, q8 = (c["segments"][0]["pos0"] for c in caches)
    out["int8 rows"] = {}
    for k in ("k", "v"):
        codes, scale = attention._quantize_row(fl[k])
        out["int8 rows"][k] = (torch.equal(codes, q8[k]),
                               torch.equal(scale, q8[k + "_scale"]))
    del caches, fl, q8
    out["forwards"], out["steps"] = 2, 2 * short.shape[1]
    out["int8_steps"] = short.shape[1]
    out["mamba"] = sum(s.mixer == MAMBA for s in specs)
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def hybrid_bf16_positions(cfg, params, tokens) -> list:
    """bf16 at ``cfg``'s experts on ``tokens``: one forward on the plain
    path with each position's input, output and routes recorded, then
    each position run again on the kernel path from the plain path's
    input to it, its MoE on the plain path's routes there
    (``replay_routes``). Returns each position's largest deviation from
    the plain path's output over the latter's largest |x|. Held
    position by position: over a whole bf16 forward a rounding carries
    through the Mamba states to every later token, and the logits
    measure that carry, not the kernels."""
    import torch

    from repro_torch.configs.base import MOE
    from repro_torch.models import forward, model
    plain, routes = [], []
    with torch.no_grad(), plain_attention(), \
            record_routes(routes, gaps=False), record_blocks(plain):
        forward(params, cfg, tokens)
    out, j = [], 0
    with torch.no_grad():
        for i, (args, want) in enumerate(plain):
            spec, n = args[0], int(args[0].ffn == MOE)
            with replay_routes(routes[j:j + n], []):
                got = model._block(*args)[0]
            j += n
            out.append((f"pos{i} {spec.mixer}+{spec.ffn}",
                        float((got.float() - want.float()).abs().max()
                              / want.float().abs().max())))
            plain[i] = None
    return out


def hybrid_long_decode(cfg, params, kv_quant: bool, device) -> dict:
    """The launcher's decode (``decode_run``, no hot swap, each step held
    alone against the plain path) of batch 4 from
    a bf16 cache of ``LONG_LEN`` rows whose attention K/V are seeded to
    ``LONG_POS`` (N(0, 1) from the seed; with ``kv_quant`` the int8 cache,
    the same rows quantized by ``attention._quantize_row``), then one
    more step profiled. Returns ``decode_run``'s figures, the cache's
    bytes and its attention entry."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import attention, init_cache
    from repro_torch.serving.predictor import ServeDriver
    args = serve.parse_args([*HYBRID_SERVE_ARGV, "--device", device.type,
                             "--steps", str(HYBRID_DECODE_STEPS),
                             "--max-len", str(LONG_LEN),
                             "--hot-swap-every", "0"])
    driver = ServeDriver(cfg=cfg, params=params, batch=args.batch,
                         max_len=LONG_LEN, cache_dtype=torch.bfloat16,
                         device=device)
    if kv_quant:
        driver.cache = init_cache(cfg, args.batch, LONG_LEN,
                                  dtype=torch.bfloat16, device=device,
                                  kv_quant=True)
    data = torch.Generator(device=device).manual_seed(SEED + 31)
    entry = None
    for seg in driver.cache["segments"]:
        for e in seg.values():
            if "k" not in e:
                continue
            entry = entry or e
            for k in ("k", "v"):
                rows = torch.randn(e[k][:, :, :LONG_POS].shape,
                                   generator=data, device=device)
                if kv_quant:
                    e[k][:, :, :LONG_POS], e[k + "_scale"][
                        :, :, :LONG_POS] = attention._quantize_row(rows)
                else:
                    e[k][:, :, :LONG_POS] = rows
    driver.pos = torch.full((args.batch,), LONG_POS, dtype=torch.int32,
                            device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 37)
    run = decode_run(cfg, driver, params, args, gen, device, local=True)
    run["cache_bytes"] = _tree_bytes(driver.cache)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    run["profile"] = profile_call(lambda: driver.step(tok), device)
    run["entry"] = {k: v[0] for k, v in entry.items()}
    return run


def hybrid_launcher_run(cfg, device) -> dict:
    """``launch.serve``'s build and run for ``cfg`` (batch 4, 32 steps, a
    hot swap every 8, a float32 cache of 64 rows), each step held to the
    plain path as it runs: the step's cache copied before it, the plain
    step run on the copy with the same params, tokens and positions
    (``decode_run`` keeps every swapped-in copy of the params for its
    replay afterwards: five of 22.6 GB here). Each step's kernel-path
    time is taken around the step and a device sync, the plain step
    outside it."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import decode_step
    args = serve.parse_args([*HYBRID_SERVE_ARGV, "--device", device.type])
    cfg, params, driver, gen = serve.build(args, cfg=cfg)
    inner, devs, ms = driver.step_fn, [], []
    finite = [True]

    def step(p, cache, tokens, pos):
        before = _tree_map(lambda t: t.clone(), cache)
        t0 = time.perf_counter()
        logits, cache = inner(p, cache, tokens, pos)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        with plain_attention():
            plain, _ = decode_step(p, cfg, before, tokens, pos)
        devs.append(_logit_dev(logits, plain, cfg.vocab_size))
        finite[0] &= bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        return logits, cache

    driver.step_fn = step
    t0 = time.perf_counter()
    tokens, _ = serve.run(driver, params, args, gen)
    wall = time.perf_counter() - t0
    driver.step_fn = inner
    if tokens.shape != (args.batch, args.steps):
        raise AssertionError(f"launcher tokens of shape {tokens.shape}")
    return {"ms": ms, "wall_s": wall, "steps": len(ms), "finite": finite[0],
            "max_dev": max(d for d, _ in devs),
            "agree": float(np.mean([a for _, a in devs])),
            "param_bytes": _tree_bytes(params),
            "swaps": args.steps // args.hot_swap_every}


def dequantize_cache_row(entry, device) -> dict:
    """Row 8k: ``dequantize_rows`` as the int8 cache's read runs it, one
    row a (token, head) of ``entry``'s ``v`` (B, S, Kv, hd) with its
    float32 scales, bit-equal to its plain version and timed beside its
    bound (codes and scales read, float32 written), its plain version and
    ``torch.mul``."""
    from repro_torch.kernels import ops, ref
    codes = entry["v"].reshape(-1, entry["v"].shape[-1])
    scale = entry["v_scale"].reshape(-1, 1)
    got = ops.dequantize_rows(codes, scale)
    if not bool((got == ref.dequantize_rows(codes, scale)).all()):
        raise AssertionError("dequantize_rows at the int8 cache's shape: "
                             "not bit-equal")
    n, d = codes.shape
    return _row("dequantize_rows", "delta_codec.cu",
                "src/repro/kernels/delta_codec.py:58", 0.0,
                lambda: ops.dequantize_rows(codes, scale),
                lambda: ref.dequantize_rows(codes, scale),
                lambda: codes * scale, n * d * (1 + 4) + n * 4,
                f"the int8 KV cache: {n} rows x {d} (B {entry['v'].shape[0]}"
                f", S {entry['v'].shape[1]}, Kv {entry['v'].shape[2]})")


def hybrid_serving_phase(dev, by_name: dict) -> dict:
    """Phase 6f: jamba served at full width. The attention kernels at its
    shapes against their plain versions and the MoE gathers at D = 8,192;
    then, with the launch counters reset, at 8 experts: a bf16 prefill of
    4 x 2048 against the plain path, decodes from a cache seeded to 4,000
    of 4,096 (bf16, then int8); at 2 experts: the launcher's run with hot
    swaps, the float32 check of every position and decode against
    forward; the counters read. The timing rows 9j, 10j, 3j and 8k ride
    on ``by_name``'s entries; returns the path's launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = hybrid_config(HYBRID_SERVE_EXPERTS)
    print(f"Hybrid serving: host memory available {host_available()} bytes; "
          f"{HYBRID_ARCH} {hybrid_reduced(cfg)}; LM kernels against their "
          f"plain versions at its shapes:", flush=True)
    for line in check_lm_kernels(cfg, dev):
        print(f"  {line}")
    by_name["embedding_lookup"][HYBRID_ARCH] = moe_gather_rows(cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    data = torch.Generator(device=dev).manual_seed(SEED + 7)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=data, device=dev)
    ops.reset_launches()
    t = time.perf_counter()
    pre = prefill_phase(cfg, params, tokens, PREFILL_REPS, dev, f32=False,
                        replay=True)
    pre["positions"] = hybrid_bf16_positions(cfg, params, tokens)
    pre["s"] = time.perf_counter() - t
    t = time.perf_counter()
    long = {}
    for key, quant in (("bf16", False), ("int8", True)):
        long[key] = hybrid_long_decode(cfg, params, quant, dev)
    long_s = time.perf_counter() - t
    serve_peak = torch.cuda.max_memory_allocated()
    param_bytes = _tree_bytes(params)
    del params
    torch.cuda.empty_cache()
    small = hybrid_config(HYBRID_SMALL_EXPERTS)
    t = time.perf_counter()
    launcher = hybrid_launcher_run(small, dev)
    launcher["s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    check = hybrid_positions_check(
        hybrid_config(HYBRID_SMALL_EXPERTS, "float32"),
        tokens[:HYBRID_F32_BATCH], dev)
    check["s"] = time.perf_counter() - t
    launches = ops.launch_counts()
    report_hybrid_serving(cfg, pre, long, launcher, check, launches,
                          param_bytes, serve_peak, long_s)
    rows = {"9j": flash_row(*_attn_inputs(
        PREFILL_BATCH, cfg.num_heads, cfg.num_kv_heads, PREFILL_LEN,
        cfg.head_dim, torch.bfloat16, torch.Generator(
            device=dev).manual_seed(SEED + 41), dev), True, "causal")}
    e = long["bf16"]["entry"]
    rows["10j"] = decode_row(cfg, (e["k"].float(), e["v"].float(),
                                   LONG_POS + 1), torch.Generator(
                                       device=dev).manual_seed(SEED + 43),
                             dev)
    rows["8k"] = dequantize_cache_row(long["int8"]["entry"], dev)
    step_ms = float(np.percentile(long["int8"]["lat_ms"], 50))
    print(f"  the int8 cache's read: 2 dequantize_rows a step of "
          f"{rows['8k']['ms']:.5f} ms each on the device, "
          f"{100 * 2 * rows['8k']['ms'] / step_ms:.3f}% of the int8 decode "
          f"step's p50 {step_ms:.3f} ms", flush=True)
    for key, row in rows.items():
        by_name[row["name"]][f"{HYBRID_ARCH} {key}"] = {k: row[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}
    return launches


def report_hybrid_serving(cfg, pre, long, launcher, check, launches,
                          param_bytes, serve_peak, long_s) -> None:
    """Print phase 6f's numbers and hold them to their limits."""
    moe = _moe_layers(cfg)
    gathers = 1 + 2 * moe
    p50 = float(np.percentile(pre["ms"], 50))
    tps = PREFILL_BATCH * PREFILL_LEN / p50 * 1e3
    print(f"Hybrid serving: {HYBRID_ARCH} at full width, {cfg.num_layers} "
          f"layers ({_attn_layers(cfg)} attention + {moe} MoE, Mamba and "
          f"MLP), {cfg.num_experts} experts, random weights from seed "
          f"{SEED}; params {param_bytes} bytes; peak device memory "
          f"{serve_peak} bytes", flush=True)
    print(f"  prefill {PREFILL_BATCH} x {PREFILL_LEN} bf16: p50 {p50:.3f} ms"
          f" over {len(pre['ms'])} ({tps:.0f} tokens/s); flash_attention "
          f"launches per forward "
          f"{pre['per_forward']} ({pre['forwards']} forwards on the kernel "
          f"path); bf16 logits vs the plain path on the kernel path's "
          f"routes, every token: max deviation {pre['bf16_dev']:.3g} (not "
          f"held: the carry through the Mamba states), greedy tokens agree "
          f"{pre['bf16_agree']:.4f}; each position on the plain path's "
          f"input to it and its routes (of its largest |x|, limit "
          f"{HYBRID_BF16_POSITION_BOUND}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in pre["positions"])
          + f"; {pre['s']:.1f} s", flush=True)
    print(_routes_line("bf16 prefill, the plain path's own choice",
                       pre["bf16_routes"]))
    print(_profile_line(f"bf16 prefill ({PREFILL_BATCH} x {PREFILL_LEN})",
                        pre["profile"]))
    for key, share in (("MoE", pre["moe"]), ("Mamba", pre["ssm"])):
        print(f"  {key} share of one bf16 prefill's stream time "
              f"({share['forward_ms']:.3f} ms): "
              + ", ".join(f"{k} {v:.3f} ms "
                          f"({100 * v / share['forward_ms']:.1f}%)"
                          for k, v in share["ms"].items()), flush=True)
    for key, run in long.items():
        lat = run["lat_ms"]
        print(f"  decode from a {key} cache (pos {LONG_POS} of {LONG_LEN}, "
              f"cache {run['cache_bytes']} bytes): {run['steps']} steps, p50"
              f" {np.percentile(lat, 50):.3f} ms, p99 "
              f"{np.percentile(lat, 99):.3f} ms per step (every expert read "
              f"a step: {param_bytes} bytes, bound "
              f"{_bound_ms(param_bytes):.3f} ms); decode_attention launches "
              f"on the tensor-core kernel {run['tensor_core_launches']}; "
              f"teacher-forced logits vs "
              f"the plain path, each step from the kernel path's cache "
              f"before it and on its routes: max deviation "
              f"{run['max_dev']:.3g} (limit {BF16_LOGIT_BOUND}), greedy "
              f"tokens agree {run['agree']:.4f}; finite {run['finite']}",
              flush=True)
        print(_routes_line(f"{key} long-cache decode, the plain path's own "
                           f"choice", run["routes"]))
        print(_profile_line(f"{key}-cache decode step", run["profile"]))
    dq = sum(ms for k, ms in long["int8"]["profile"]["entries"]
             if "dequantize" in k)
    print(f"  int8 cache: dequantize_rows in the profiled step {dq:.4f} ms "
          f"of {long['int8']['profile']['wall_ms']:.3f} ms wall; the two "
          f"long decodes {long_s:.1f} s", flush=True)
    lat = launcher["ms"]
    print(f"  the launcher's run at {HYBRID_SMALL_EXPERTS} experts "
          f"({launcher['param_bytes']} bytes of bf16 params, "
          f"{launcher['swaps']} hot swaps): {launcher['steps']} steps, p50 "
          f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f}"
          f" ms per step (kernel path, a sync after each); logits vs the "
          f"plain path: max deviation {launcher['max_dev']:.3g} (limit "
          f"{BF16_LOGIT_BOUND}), greedy "
          f"tokens agree {launcher['agree']:.4f}; finite "
          f"{launcher['finite']}; {launcher['s']:.1f} s", flush=True)
    print(f"  float32 at {HYBRID_SMALL_EXPERTS} experts "
          f"({check['param_bytes']} bytes of params), {HYBRID_F32_BATCH} "
          f"x {PREFILL_LEN}, kernel vs plain path, each position on the "
          f"plain path's input to it (of "
          f"its largest |x|, limit {HYBRID_POSITION_BOUND}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in check["positions"])
          + "; the two forwards after each position: "
          + ", ".join(f"{k} {v:.3g}" for k, v in check["carried"])
          + f"; logits {check['logits'][0]:.3g} (limit {F32_LOGIT_ATOL}), "
          f"greedy agree {check['logits'][1]:.4f}", flush=True)
    print(f"  decode against forward over {CONSISTENCY_LEN} tokens, float32"
          f": max deviation {check['decode'][0]:.3g} (limit "
          f"{HYBRID_DECODE_BOUND}), greedy agree {check['decode'][1]:.4f}; "
          f"with the int8 cache {check['int8 decode'][0]:.3g} (limit "
          f"{HYBRID_INT8_DECODE_BOUND}) / {check['int8 decode'][1]:.4f}; the "
          f"int8 cache's first-layer codes and scales equal _quantize_row "
          f"of the float cache's rows (K, V): {check['int8 rows']}; peak "
          f"device memory {check['peak_bytes']} bytes; {check['s']:.1f} s",
          flush=True)
    print(f"  launches in the hybrid serving path: {launches}")
    # each long decode's steps and its one profiled step
    steps = (sum(r["steps"] + 1 for r in long.values()) + launcher["steps"]
             + check["steps"])
    # the two checks' position reruns (bf16, float32) each launch a
    # forward's layers' kernels, the token gather apart
    forwards = pre["forwards"] + check["forwards"]
    want = {"flash_attention": _flash_layers(cfg, PREFILL_LEN)
            * (forwards + 2),
            "decode_attention": _attn_layers(cfg) * steps,
            "embedding_lookup": gathers * (forwards + steps) + 4 * moe,
            "dequantize_rows": 2 * _attn_layers(cfg) * (
                long["int8"]["steps"] + 1 + check["int8_steps"])}
    if pre["per_forward"] != _flash_layers(cfg, PREFILL_LEN) or \
            {k: launches[k] for k in want} != want:
        raise AssertionError(f"hybrid serving launches {launches}, want "
                             f"{want}")
    worst = max(v for _, v in check["positions"])
    if not (worst <= HYBRID_POSITION_BOUND and check["finite"]
            and check["logits"][0] <= F32_LOGIT_ATOL):
        raise AssertionError(f"float32 kernel path vs plain path: "
                             f"{check['positions']}, logits "
                             f"{check['logits']}")
    if not (check["decode"][0] <= HYBRID_DECODE_BOUND
            and check["int8 decode"][0] <= HYBRID_INT8_DECODE_BOUND):
        raise AssertionError(f"float32 decode vs forward "
                             f"{check['decode'][0]:.3g}, with the int8 "
                             f"cache {check['int8 decode'][0]:.3g}")
    if not all(all(v) for v in check["int8 rows"].values()):
        raise AssertionError(f"int8 cache rows against _quantize_row: "
                             f"{check['int8 rows']}")
    if not (launcher["finite"] and all(r["finite"] for r in long.values())):
        raise AssertionError("non-finite decode logits")
    worst = max(launcher["max_dev"], *(r["max_dev"] for r in long.values()))
    if worst > BF16_LOGIT_BOUND:
        raise AssertionError(f"bf16 decode logits deviate from the plain "
                             f"path by {worst:.3g}")
    if max(v for _, v in pre["positions"]) > HYBRID_BF16_POSITION_BOUND:
        raise AssertionError(f"bf16 kernel path vs plain path by position: "
                             f"{pre['positions']}")


def moe_scatter_add_row(cfg, device) -> dict:
    """Row 5j: ``embedding_scatter_add`` as the MoE dispatch's gradient
    runs it at the training batch (``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens
    from the seed, routed by a router at the init scale): the E * C
    buffer rows' bf16 gradients added onto (T + 1, D) zeros at their
    tokens (an empty slot's at the appended zero row), bit-equal to its
    plain version and timed beside its bound, plain version and
    ``index_add_``."""
    import torch

    from repro_torch.kernels import embedding_lookup as el
    from repro_torch.kernels import ref
    from repro_torch.models import moe
    gen = torch.Generator(device=device).manual_seed(SEED + 47)
    t, d, e, k = (TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.num_experts,
                  cfg.experts_per_token)
    xt = torch.randn((t, d), generator=gen, device=device).bfloat16()
    router = torch.randn((d, e), generator=gen, device=device) * d ** -0.5
    idx, _, _ = moe.route(router, xt, cfg)
    cap = moe.moe_capacity(t, cfg)
    _, rows, keep, _ = moe._dispatch(xt, idx, cap, cfg)
    src = torch.full((e * cap,), t, device=device)
    src[rows[keep]] = torch.arange(t * k, device=device)[keep] // k
    ids32, ids64 = src.int(), src.long()
    upd = torch.randn((e * cap, d), generator=gen, device=device).bfloat16()
    table = torch.zeros((t + 1, d), dtype=torch.bfloat16, device=device)
    if not torch.equal(el.embedding_scatter_add(table.clone(), ids32, upd),
                       ref.embedding_scatter_add(table.clone(), ids64,
                                                 upd)):
        raise AssertionError("the dispatch's scatter-add: not bit-equal")
    distinct = int(src.unique().numel())
    return _row("embedding_scatter_add", "embedding_lookup.cu",
                "src/repro/kernels/embedding_lookup.py:79", 0.0,
                lambda: el.embedding_scatter_add(table, ids32, upd),
                lambda: ref.embedding_scatter_add(table, ids64, upd),
                lambda: table.index_add_(0, ids64, upd),
                e * cap * d * 2 + 2 * distinct * d * 2 + e * cap * 4,
                f"the dispatch's gradient: {e * cap} rows ({distinct} "
                f"distinct ids) x {d} bf16 into ({t + 1}, {d})")


def adafactor_peaks(cfg, device) -> dict:
    """Adafactor's ``update_`` on the card at jamba's two largest leaf
    shapes, bf16 with a bf16 gradient: the (vocab, d_model) tables and an
    expert leaf (1, E, d_model, d_ff). Each update's peak device memory
    over what the leaf, its gradient and its slots hold, against one
    float32 buffer of a slice (the leaf's last two axes): the design's
    transient, beside the means' reduction workspace (under
    ``ADAFACTOR_SLICES`` slices in all)."""
    import torch

    from repro_torch.optim import get_optimizer
    opt = get_optimizer("adafactor")
    gen = torch.Generator(device=device).manual_seed(SEED + 53)
    out = {}
    for key, shape in (("table", (cfg.padded_vocab, cfg.d_model)),
                       ("expert", (1, cfg.num_experts, cfg.d_model,
                                   cfg.d_ff))):
        p = torch.randn(shape, generator=gen, device=device).bfloat16()
        g = torch.randn(shape, generator=gen, device=device).bfloat16()
        slots = opt.init_slots(p)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt.update_(p, slots, g, 0)
        torch.cuda.synchronize()
        out[key] = {"shape": shape, "s": time.perf_counter() - t0,
                    "peak": torch.cuda.max_memory_allocated() - base,
                    "slice_f32": 4 * shape[-2] * shape[-1],
                    "finite": bool(torch.isfinite(p).all())}
        del p, g, slots
    torch.cuda.empty_cache()
    return out


def hybrid_training_phase(dev, by_name: dict) -> tuple[dict, dict]:
    """Phase 7f: jamba trained at full width at 2 experts (bf16,
    Adafactor, remat): the dispatch's scatter-add at D = 8,192 (row 5j,
    on ``by_name``'s entry), Adafactor's transient at the largest leaves,
    ``drive_lm_train`` with ``HYBRID_TRAIN_ARGV`` on the cut config: the
    replica's bootstrap, 4 steps, one cast16 flush, one int8 flush, a
    hot swap of the replica's params into a driver on the trained ones.
    Returns the launches of the training run and of its hot-swap
    decode."""
    import torch
    cfg = hybrid_config(HYBRID_SMALL_EXPERTS)
    print(f"Hybrid training: host memory available {host_available()} "
          f"bytes; {HYBRID_ARCH} {hybrid_reduced(cfg)}; the dispatch's "
          f"gradient at D = {cfg.d_model}:", flush=True)
    row = moe_scatter_add_row(cfg, dev)
    by_name["embedding_scatter_add"][f"{HYBRID_ARCH} 5j"] = {
        k: row[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                            "library_ms", "max_abs_err")}
    peaks = adafactor_peaks(cfg, dev)
    for key, v in peaks.items():
        print(f"  Adafactor update_ of a bf16 {key} leaf {v['shape']}: peak "
              f"{v['peak']} bytes over the leaf, its gradient and slots "
              f"(one float32 slice: {v['slice_f32']} bytes), {v['s']:.3f} s"
              f", finite {v['finite']}", flush=True)
    if not all(v["finite"] and v["peak"] <= ADAFACTOR_SLICES * v["slice_f32"]
               for v in peaks.values()):
        raise AssertionError(f"Adafactor's transient: {peaks}")
    torch.cuda.empty_cache()
    lm = drive_lm_train(dev, HYBRID_TRAIN_ARGV, decode_steps=SWAP_DECODE_STEPS,
                        cfg=cfg, keep_initial=False, min_flushes=1)
    report_lm_train(lm, None)
    return lm["run"]["launches"], lm["run"]["decode"]["launches"]


# ---------------------------------------------------------------------------
# Phase 8: sharding and cost (launch/dryrun, cost_model, hlo_analysis)
# ---------------------------------------------------------------------------

# each LM kernel at a zoo shape of PERF.md's kernel table, with that
# table's bound (ms): the row, its arguments' maker and the table's bound
ABSTRACT_KERNEL_ROWS = ("9", "10", "3m", "5m", "8k")
TABLE_BOUND_MS = {"9": 0.05211, "10": 0.00979, "3m": 0.02004,
                  "5m": 0.01458, "8k": 0.02520}
LOCAL_PASS_SHAPE = ("prefill", 2048, 4)     # qwen2-1.5b, 4 x 2048 bf16
LOCAL_PASS_REPS = 5
# (arch, shape, multi_pod, opt): each must be ok, or an ``applicable`` skip
PRODUCTION_PAIRS = (("qwen2-1.5b", "train_4k", False, False),
                    ("qwen2-1.5b", "decode_32k", False, False),
                    ("granite-moe-3b-a800m", "prefill_32k", False, True),
                    ("jamba-1.5-large-398b", "long_500k", True, False),
                    ("whisper-medium", "train_4k", False, False))


def _abstract_kernel_args(row: str, device):
    """``(wrapper, args, label)`` of a kernel table row's shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(SEED + 81)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def ids(n, hi):
        return torch.randint(0, hi, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    if row == "9":
        cfg = get_config(LM_ARCH)
        q, k, v = _attn_inputs(PREFILL_BATCH, cfg.num_heads,
                               cfg.num_kv_heads, PREFILL_LEN, cfg.head_dim,
                               torch.bfloat16, gen, device)
        return (lambda *a: ops.flash_attention(*a, causal=True), (q, k, v),
                f"q {tuple(q.shape)}, k, v {tuple(k.shape)} bf16 causal")
    if row == "10":
        cfg = get_config(LM_ARCH)
        n, h, g, d = 4, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = randn(n, h, d)
        ck, cv = (randn(n, LONG_LEN, g, d, dtype=torch.float32)
                  for _ in range(2))
        lengths = torch.full((n,), LONG_POS + 1, dtype=torch.int32,
                             device=device)
        return (ops.decode_attention, (q, ck, cv, lengths),
                f"q {tuple(q.shape)} bf16 vs cache {tuple(ck.shape)} f32 "
                f"at {LONG_POS + 1}")
    if row == "3m":
        cfg = get_config(SSM_ARCH)
        table = randn(cfg.padded_vocab, cfg.d_model)
        return (ops.embedding_lookup, (table, ids(8192, cfg.vocab_size)),
                f"8192 ids x {cfg.d_model} bf16 from {tuple(table.shape)}")
    if row == "5m":
        cfg = get_config(SSM_ARCH)
        table = randn(cfg.padded_vocab, cfg.d_model)
        upd = randn(4096, cfg.d_model)
        return (ops.embedding_scatter_add,
                (table, ids(4096, cfg.vocab_size), upd),
                f"4096 ids x {cfg.d_model} bf16 into {tuple(table.shape)}")
    codes = torch.randint(-127, 128, (131072, 128), generator=gen,
                          device=device, dtype=torch.int8)
    return (ops.dequantize_rows, (codes, randn(131072, 1,
                                               dtype=torch.float32)),
            "131072 rows x 128 int8")


def abstract_kernel_checks(device) -> list[str]:
    """Phase 8 (a): each LM kernel's fake path against the kernel at a
    zoo shape — the fake output's shape, dtype and strides equal the
    kernel's real output's — and the bound from its registered FLOPs
    and bytes (``CostMode`` on the fake call) beside the table's."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import CostMode
    lines = []
    for row in ABSTRACT_KERNEL_ROWS:
        fn, args, label = _abstract_kernel_args(row, device)
        fm = FakeTensorMode()
        fake_args = [fm.from_tensor(a) for a in args]
        real = fn(*[a.clone() for a in args])
        with fm, CostMode() as mode:
            fake = fn(*fake_args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        got = (tuple(fake.shape), fake.dtype, fake.stride())
        want = (tuple(real.shape), real.dtype, real.stride())
        if got != want:
            raise AssertionError(f"row {row}: the fake output {got} is not "
                                 f"the kernel's {want}")
        (op, _), = [(k, v) for k, v in mode.op_counts.items()
                    if k.startswith("repro_torch.")]
        peak = BF16_PEAK_FLOPS if args[0].dtype == torch.bfloat16 \
            else F32_PEAK_FLOPS
        bound = max(mode.bytes / HBM_BYTES_PER_S, mode.flops / peak) * 1e3
        lines.append(f"row {row} {op}: {label}; fake out == kernel out "
                     f"{got[0]} {str(got[1])[6:]} strides {got[2]}; "
                     f"registered {mode.flops} FLOPs, {mode.bytes} bytes: "
                     f"bound {bound:.5f} ms (table {TABLE_BOUND_MS[row]})")
        del real, fake, args, fake_args
    return lines


def local_pass_report(device) -> dict:
    """Phase 8 (b): qwen2-1.5b's 4 x 2048 bf16 prefill at full width,
    counted on real ``DTensor``s on ``make_local_mesh(1, 1)`` and on fake
    ones (``dryrun.local_pass``): FLOPs, bytes, collectives and every
    op's count must be equal. Prints the plain step's p50 beside the
    roofline terms. Returns the pass's launch counts."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    cfg = get_config(LM_ARCH)
    kind, s, b = LOCAL_PASS_SHAPE
    ops.reset_launches()
    r = dryrun.local_pass(cfg, InputShape("local", s, b, kind),
                          device_type=device.type, reps=LOCAL_PASS_REPS)
    launches = ops.launch_counts()
    real, fake = r["real"], r["fake"]
    if real != fake or r["real_mode"].op_counts != r["fake_mode"].op_counts:
        diff = set(r["real_mode"].op_counts.items()) ^ set(
            r["fake_mode"].op_counts.items())
        raise AssertionError(f"local pass: real {real} != fake {fake}; "
                             f"ops differing: {sorted(diff)[:10]}")
    mf = dryrun.model_flops(cfg, InputShape("local", s, b, kind))
    print(f"  local pass {cfg.name} {kind} {b} x {s} bf16 on "
          f"make_local_mesh(1, 1): real == fake: {real.flops_per_device:.6g}"
          f" FLOPs, {real.bytes_per_device:.6g} bytes (no fusion), "
          f"collectives {real.collective_counts}; "
          f"{sum(r['real_mode'].op_counts.values())} ops; FLOPs by op "
          f"{dict(r['real_mode'].flops_by_op)}", flush=True)
    print(f"  p50 {r['p50_ms']:.3f} ms (plain tensors, {LOCAL_PASS_REPS} "
          f"calls) vs compute {real.flops_per_device / BF16_PEAK_FLOPS * 1e3:.3f}"
          f" ms, no-fusion memory {real.bytes_per_device / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms, model FLOPs {mf:.6g} = {mf / BF16_PEAK_FLOPS * 1e3:.3f} ms; "
          f"launches {launches}", flush=True)
    return launches


def production_pairs() -> list[dict]:
    """Phase 8 (c): the listed production-mesh pairs through
    ``dryrun.run_pair`` on fake CUDA tensors, each printing the
    reference's one-line summary; each must be ``ok`` or an
    ``applicable`` skip. JSONs under ``build/dryrun/smoke``."""
    from repro_torch.configs import SHAPES, applicable, get_config
    from repro_torch.launch import dryrun
    out, bad = [], []
    for arch, shape, multi_pod, opt in PRODUCTION_PAIRS:
        r = dryrun.run_pair(arch, shape, multi_pod=multi_pod,
                            out_dir=str(ROOT / "build" / "dryrun" / "smoke"),
                            verbose=False, opt=opt)
        ok, _ = applicable(get_config(arch), SHAPES[shape])
        if r["status"] != ("ok" if ok else "skip"):
            print(r.get("traceback", ""), flush=True)
            bad.append(f"{arch} {shape}: {r['status']} {r.get('error', '')}")
        out.append(r)
    if bad:
        raise AssertionError("dry-run pairs failed: " + "; ".join(bad))
    return out


def hook_overhead_line(device, calls: int = 100_000) -> str:
    """The host cost the sharding registrations add to a plain-tensor
    call: ``_build.direct`` (each LM kernel wrapper's check before its
    direct route) on three tensors, ``_build.dtensor_args`` (the model's
    check before a weight's or a cache's DTensor handling) and the
    model's mesh hooks with no mesh in scope (``constrain_batch``,
    ``fsdp_gather`` on a layer's dict), each averaged over ``calls``
    calls on the host clock."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models.common import constrain_batch, fsdp_gather
    t = torch.zeros(4, device=device)
    layer = {"mixer": {"wq": t, "wk": t}, "ffn": {"w_up": t}}
    out = []
    for name, fn in (("direct(q, k, v)", lambda: _build.direct(t, t, t)),
                     ("dtensor_args(w)", lambda: _build.dtensor_args(t)),
                     ("constrain_batch(x)", lambda: constrain_batch(t)),
                     ("fsdp_gather(layer)", lambda: fsdp_gather(layer))):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append(f"{name} {(time.perf_counter() - t0) / calls * 1e6:.3f}"
                   f" us")
    return "host cost a call with no mesh in scope: " + ", ".join(out)


def sharding_phase(device) -> dict:
    """Phase 8: the five LM kernels' abstract paths, the local pass, the
    production-mesh pairs. Returns the local pass's launch counts."""
    print("sharding and cost: the LM kernels' fake paths at zoo shapes:",
          flush=True)
    for line in abstract_kernel_checks(device):
        print(f"  {line}", flush=True)
    print(f"  {hook_overhead_line(device)}", flush=True)
    launches = local_pass_report(device)
    print("sharding and cost: production-mesh pairs (fake process groups, "
          "fake CUDA tensors):", flush=True)
    production_pairs()
    return launches


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
    moe_cfg = get_config(MOE_ARCH)
    print(f"MoE phases: host memory available {host_available()} bytes; "
          f"LM kernels against their plain versions at {MOE_ARCH}'s "
          f"shapes:", flush=True)
    for line in check_lm_kernels(moe_cfg, dev):
        print(f"  {line}")
    by_name = {row["name"]: row for row in kernels}
    by_name["embedding_lookup"].update(moe_gather_rows(moe_cfg, dev))
    moe_lm = drive_lm(dev, MOE_SERVE_ARGV, prefill_batch=PREFILL_BATCH,
                      prefill_len=PREFILL_LEN, prefill_reps=PREFILL_REPS,
                      long_len=LONG_LEN, long_pos=LONG_POS,
                      long_steps=LONG_STEPS)
    report_lm(moe_lm)
    for row in lm_kernel_rows(moe_lm["cfg"], moe_lm.pop("decode_inputs"),
                              dev):
        by_name[row["name"]][MOE_ARCH] = {k: row[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}
    paths[f"{MOE_ARCH} serving"] = moe_lm["launches"]
    print(f"MoE serving phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    del moe_lm
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ssm_cfg = get_config(SSM_ARCH)
    print(f"SSM serving: host memory available {host_available()} bytes; "
          f"the token gather at {SSM_ARCH}'s shape:", flush=True)
    by_name["embedding_lookup"][SSM_ARCH] = token_gather_row(ssm_cfg, dev)
    ssd = ssd_recurrence_check(dev, **SSD_SHAPE)
    torch.cuda.empty_cache()
    ssm_lm = drive_ssm(dev, SSM_SERVE_ARGV, prefill_batch=PREFILL_BATCH,
                       prefill_len=PREFILL_LEN, prefill_reps=PREFILL_REPS)
    report_ssm(ssm_lm, ssd)
    paths[f"{SSM_ARCH} serving"] = ssm_lm["launches"]
    del ssm_lm
    print(f"SSM serving phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print("depth cuts of the training runs, every width as published: "
          + ", ".join(f"{a} {train_cut(a).num_layers} of "
                      f"{get_config(a).num_layers} layers"
                      for a in TRAIN_DEPTH_CUTS), flush=True)
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
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print(f"MoE training: host memory available {host_available()} bytes",
          flush=True)
    f32 = check_train_f32(moe_cfg, dev, MOE_GRAD_LEAVES,
                          layers=MOE_F32_LAYERS)
    torch.cuda.empty_cache()
    moe_train = drive_lm_train(dev, MOE_TRAIN_ARGV, cfg=train_cut(MOE_ARCH),
                               decode_steps=SWAP_DECODE_STEPS)
    report_lm_train(moe_train, f32)
    paths[f"{MOE_ARCH} training run"] = moe_train["run"]["launches"]
    paths[f"{MOE_ARCH} hot-swap decode"] = \
        moe_train["run"]["decode"]["launches"]
    del moe_train
    print(f"MoE training phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    print(f"SSM training: host memory available {host_available()} bytes; "
          f"the embedding gradient at {SSM_ARCH}'s shape:", flush=True)
    sa = scatter_add_row(ssm_cfg, dev, split=False)
    by_name = {row["name"]: row for row in kernels}
    by_name["embedding_scatter_add"][SSM_ARCH] = {k: sa[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err")}
    f32 = check_train_f32(ssm_cfg, dev, SSM_GRAD_LEAVES)
    torch.cuda.empty_cache()
    ssm_train = drive_lm_train(dev, SSM_TRAIN_ARGV, cfg=train_cut(SSM_ARCH),
                               decode_steps=SWAP_DECODE_STEPS)
    report_lm_train(ssm_train, f32)
    paths[f"{SSM_ARCH} training run"] = ssm_train["run"]["launches"]
    paths[f"{SSM_ARCH} hot-swap decode"] = \
        ssm_train["run"]["decode"]["launches"]
    del ssm_train
    print(f"SSM training phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths[f"{GEMMA_ARCH} serving"] = window_serving_phase(dev, by_name)
    print(f"sliding-window serving phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    by_name = {row["name"]: row for row in kernels}
    paths[f"{GEMMA_ARCH} training run"], \
        paths[f"{GEMMA_ARCH} hot-swap decode"] = window_training_phase(
            dev, by_name)
    print(f"sliding-window training phase in {time.perf_counter() - t:.1f} "
          f"s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths[f"{ENCDEC_ARCH} serving"] = encdec_serving_phase(dev, by_name)
    print(f"encoder-decoder serving phase in {time.perf_counter() - t:.1f} "
          f"s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths[f"{ENCDEC_ARCH} training run"], \
        paths[f"{ENCDEC_ARCH} hot-swap decode"] = encdec_training_phase(
            dev, by_name)
    print(f"encoder-decoder training phase in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths[f"{HYBRID_ARCH} serving"] = hybrid_serving_phase(dev, by_name)
    print(f"hybrid serving phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths[f"{HYBRID_ARCH} training run"], \
        paths[f"{HYBRID_ARCH} hot-swap decode"] = hybrid_training_phase(
            dev, by_name)
    print(f"hybrid training phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    paths["sharding local pass"] = sharding_phase(dev)
    print(f"sharding and cost phase in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name in ops.KERNELS:
        counts = {path: c[name] for path, c in paths.items()}
        print(f"launches of {name} by path: "
              + ", ".join(f"{p} {c}" for p, c in counts.items())
              + f"; {sum(counts.values())} in all")
        for row in kernels:
            if row["name"] == name:
                row["launches"] = sum(counts.values())
    print("kernels: " + ", ".join(ops.KERNELS) + " (launches: each "
          "kernel's summed over every path above, ftrl_row_update's all "
          "ftrl_apply_slots, whose rows ride on its entry)")
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
