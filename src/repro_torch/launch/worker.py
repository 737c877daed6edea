"""Worker process entry for the multi-process cluster runtime: one master
PS shard or one slave PS replica per OS process, serving RPCs from the
supervisor (``launch/runtime.py``) over a unix socket and exchanging sync
records through the shared durable ``FileQueue`` — the counterpart of the
reference's ``launch/worker.py``.

Run as ``python -m repro_torch.launch.worker --role master --shard 0
--root <dir> --socket <path>`` — ``launch/specs.py`` builds these argvs.
The worker reads the cluster shape, the ``device`` and the PS and codec
backends from ``<root>/runtime.json`` and passes them to every
constructor that takes them, so nothing lands on a device by default.
With the torch backends on a CUDA device every worker holds its own CUDA
context on that device and launches the PS kernels there (the probes,
the fused FTRL pass, the row gather and scatter-set, the int8 codec);
their launch counters are published under the ``kernels`` key of the
``metrics`` RPC (and, on a CUDA device, the allocator's bytes under
``device_memory``). RPC arguments and results stay NumPy: no tensor
crosses the socket.

Fault injection: the supervisor arms a subset of the run's
:class:`~repro_torch.launch.chaos.FaultPlan` on each worker (``arm`` RPC);
the worker calls ``FaultHooks.check`` at the instrumented points documented in
``launch/chaos.py`` — a ``kill`` event SIGKILLs the process mid-operation,
exactly at a deterministic (target, point, step) coordinate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from repro_torch.launch.chaos import FaultEvent, FaultHooks
from repro_torch.launch.transport import RpcServer
from repro_torch.obs import trace as obs_trace


def _load_runtime_cfg(root: str) -> dict:
    with open(os.path.join(root, "runtime.json")) as f:
        return json.load(f)


def _setup_observability(worker, root: str, cfg: dict) -> None:
    """Per-worker tracer + fault-annotation wiring, shared by both
    roles. With ``cfg["trace"]`` set the worker records spans into its
    own process-local ring (exported via the ``trace_dump`` RPC);
    either way every chaos fault firing is annotated, and a ``kill``
    dumps the ring to ``<root>/trace/`` first — the process (and its
    ring) is gone one line later, so the dump file is the only way the
    supervisor's merged timeline keeps the pre-kill spans."""
    worker.trace_root = os.path.join(root, "trace")
    if cfg.get("trace"):
        obs_trace.configure(enabled=True, process=worker.name,
                            capacity=int(cfg.get("trace_capacity", 1 << 15)))

    def on_fire(e: FaultEvent) -> None:
        tr = obs_trace.get_tracer()
        if not tr.enabled:
            return
        tr.instant(f"fault.{e.kind}", target=e.target, point=e.point,
                   step=e.step)
        if e.kind == "kill":
            _dump_trace(worker)

    worker.hooks.on_fire = on_fire


def _dump_trace(worker) -> Optional[str]:
    """Write this worker's span ring to ``<root>/trace/<name>.<pid>.json``
    (atomic rename). Returns the path, or None when tracing is off."""
    tr = obs_trace.get_tracer()
    if not tr.enabled:
        return None
    os.makedirs(worker.trace_root, exist_ok=True)
    path = os.path.join(worker.trace_root,
                        f"{worker.name}.{os.getpid()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(tr.export(), f)
    os.replace(tmp, path)
    return path


def _build_optimizer(cfg: dict):
    from repro_torch.optim import get_optimizer
    return get_optimizer(cfg["optimizer"], **cfg.get("optimizer_kwargs", {}))


def _engine(cfg: dict) -> dict:
    """The row engine of every table of this worker: ``runtime.json``'s
    PS backend and device."""
    return {"backend": cfg["ps_backend"], "device": cfg["device"]}


def _register_port_metrics(reg, cfg: dict) -> None:
    """The port's own keys: its kernel launch counters in this process
    (each wrapper's ``launches``) under ``kernels`` and, on a CUDA
    device, the bytes PyTorch's allocator holds there for this process
    under ``device_memory`` (the CUDA context itself is not in them)."""
    import torch

    from repro_torch.kernels import ops
    reg.register("kernels", ops.launch_counts)
    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        reg.register("device_memory", lambda: {
            "allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev)})


def _sorted_table_state(table) -> dict:
    """Canonical (id-sorted) columnar dump of one table — the unit the
    trajectory-equality tests compare bit-for-bit."""
    snap = table.snapshot()
    order = np.argsort(snap["ids"], kind="stable")
    return {"ids": snap["ids"][order], "w": snap["w"][order],
            "slots": {n: v[order] for n, v in snap["slots"].items()}}


class MasterWorker:
    """One master PS shard + its collect→gather→push stages."""

    def __init__(self, shard_id: int, root: str, cfg: dict):
        from repro_torch.core.ps import MasterShard
        from repro_torch.core.queue import FileQueue
        from repro_torch.core.routing import RoutingPlan
        from repro_torch.core.streaming import Collector, Gatherer, Pusher
        from repro_torch.core.transform import make_transform

        self.name = f"master-{shard_id}"
        self.hooks = FaultHooks(self.name)
        self.cfg = cfg
        self.plan = RoutingPlan(cfg["num_master"], cfg["num_slave"],
                                cfg["num_partitions"])
        self.optimizer = _build_optimizer(cfg)
        self.groups = {g: int(d) for g, d in cfg["groups"].items()}
        self.shard = MasterShard(shard_id, self.groups, self.optimizer,
                                 **_engine(cfg))
        self.collector = Collector()
        self.shard.collector = self.collector
        self.gatherer = Gatherer(cfg.get("gather_mode", "realtime"))
        self.queue = FileQueue(os.path.join(root, "queue"))
        self.transform = make_transform(cfg.get("codec", "identity"),
                                        self.optimizer,
                                        backend=cfg["codec_backend"],
                                        device=cfg["device"])
        self.pusher = Pusher(self.shard, self.queue, self.plan,
                             self.transform)
        # delta-checkpoint marks: per-group mutation clock / dense version
        # at the previous part write (lost on respawn — the supervisor
        # forces the next checkpoint full after any recovery)
        self._marks: dict[str, int] = {}
        self._dense_marks: dict[str, int] = {}
        _setup_observability(self, root, cfg)
        self.registry = self._build_registry()

    def _build_registry(self):
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        # the reference's RPC keys (step/pushed_records/pushed_bytes/
        # rows) stay; the shard adds fused_batches + device_mirror, and
        # the port its kernel launch counters and device memory
        self.shard.register_metrics(reg)
        reg.register("pushed_records",
                     lambda: self.pusher.pushed_records)
        reg.register("pushed_bytes", lambda: self.pusher.pushed_bytes)
        _register_port_metrics(reg, self.cfg)
        return reg

    # -- RPC methods -----------------------------------------------------
    def pull(self, group: str, ids: np.ndarray) -> np.ndarray:
        return self.shard.pull(group, np.asarray(ids, np.int64))

    def apply(self, group: str, ids: np.ndarray, grads: np.ndarray,
              step: int) -> int:
        uniq = self.shard.apply_batch(group, ids, grads, step=step)
        self.hooks.check("mid_train", step)
        return int(len(uniq))

    def flush(self, step: int, now: float) -> int:
        self.gatherer.offer(self.collector.drain())
        if not self.gatherer.ready(now):
            return 0
        gathered = self.gatherer.flush(now)
        kill = self.hooks.pending("mid_flush", step, kind="kill")
        if kill is not None:
            # die with the flush half-pushed: produce roughly half of
            # every id set (some partitions get records, some don't),
            # then fire the kill — the torn-flush crash window
            partial = {k: ids[: max(1, len(ids) // 2)]
                       for k, ids in gathered.items() if len(ids)}
            self.pusher.push(partial, now=self.hooks.now(now))
            self.hooks.check("mid_flush", step)       # no return
        self.hooks.check("mid_flush", step)           # delay/skew
        return self.pusher.push(gathered, now=self.hooks.now(now))

    def checkpoint_part(self, version: int, kind: str, path: str,
                        step: int) -> dict:
        if kind == "full" or not self._marks:
            kind = "full"
            snap = self.shard.snapshot()
        else:
            snap = self.shard.delta_snapshot(self._marks, self._dense_marks)
        part = {"snap": snap, "kind": kind,
                "pusher_seqs": self.pusher.seqs()}
        tmp = path + ".tmp"
        import pickle
        with open(tmp, "wb") as f:
            pickle.dump(part, f, protocol=4)
        # the torn-checkpoint window: part written but not yet published;
        # a kill here leaves only the .tmp — the supervisor never commits
        # the manifest and the previous chain stays authoritative
        self.hooks.check("mid_ckpt", step)
        os.replace(tmp, path)
        self._marks = {g: t["version"]
                       for g, t in snap["tables"].items()}
        self._dense_marks = dict(self.shard.dense.versions)
        for g, t in self.shard.tables.items():
            t.trim_evict_log(self._marks[g])
        return {"kind": kind, "shard_step": self.shard.step}

    def restore(self, snap: dict, pusher_seqs: dict, step: int) -> None:
        """Install materialized (full-equivalent) state — the recovery /
        replay entry. Clears every streaming buffer: the supervisor
        re-drives the steps after the cut, regenerating the events."""
        self.shard.clear()
        self.shard.load_snapshot(snap)
        self.pusher.restore_seqs(pusher_seqs)
        self.collector.drain()
        self.gatherer._pending.clear()
        self.gatherer._pending_count = 0
        self._marks = {}
        self._dense_marks = {}
        self.shard.step = step

    def table_state(self, group: str) -> dict:
        return _sorted_table_state(self.shard.tables[group])

    def metrics(self) -> dict:
        return self.registry.tree()

    def trace_dump(self) -> list:
        """Span export RPC — the supervisor merges every worker's ring
        (plus pre-kill dump files) into one Perfetto timeline."""
        return obs_trace.get_tracer().export()


class SlaveWorker:
    """One slave PS replica + its Scatter consumer."""

    def __init__(self, shard_id: int, replica: int, root: str, cfg: dict):
        from repro_torch.core.ps import SlaveShard
        from repro_torch.core.queue import FileQueue
        from repro_torch.core.routing import RoutingPlan
        from repro_torch.core.streaming import Scatter
        from repro_torch.serving.cache import ServeCache

        self.name = f"slave-{shard_id}.{replica}"
        self.hooks = FaultHooks(self.name)
        self.cfg = cfg
        self.plan = RoutingPlan(cfg["num_master"], cfg["num_slave"],
                                cfg["num_partitions"])
        self.groups = {g: int(d) for g, d in cfg["groups"].items()}
        self.engine = _engine(cfg)
        self.shard = SlaveShard(shard_id, self.groups,
                                codec_backend=cfg["codec_backend"],
                                **self.engine)
        self.queue = FileQueue(os.path.join(root, "queue"))
        self.scatter = Scatter(self.shard, self.queue, self.plan)
        self.scatter.pre_apply = self._pre_apply
        self._cur_step = -1
        # worker-local serve cache: the multi-process cache-invalidate
        # stage of the update's causal chain. Lookup RPCs fill it;
        # every applied scatter batch invalidates the rewritten rows
        # (``SlaveShard.on_apply``), exactly like the in-process
        # serving plane. serve_cache_rows=0 disables it.
        rows = int(cfg.get("serve_cache_rows", 1 << 16))
        self.cache = ServeCache(self.groups, max_rows=rows,
                                **self.engine) if rows else None
        if self.cache is not None:
            self.shard.on_apply = self._on_applied
        _setup_observability(self, root, cfg)
        self.registry = self._build_registry()

    def _build_registry(self):
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        # the reference's RPC keys stay: applied/skipped/rows from the
        # shard, lag/staleness from the scatter, the cache subtree; the
        # port adds its kernel launch counters and device memory
        self.shard.register_metrics(reg)
        reg.register("lag", self.scatter.lag)
        reg.register("staleness",
                     lambda: self.scatter.staleness.percentiles((50, 99)))
        if self.cache is not None:
            self.cache.register_metrics(reg, "cache")
        _register_port_metrics(reg, self.cfg)
        return reg

    def _on_applied(self, group: str, ids, op: str) -> None:
        if group in self.cache.offsets:
            self.cache.invalidate(ids)

    def _pre_apply(self, recs) -> None:
        # offsets already advanced in the consumer's memory, nothing
        # applied yet — a kill here forces redelivery after respawn
        self.hooks.check("pre_apply", self._cur_step)

    # -- RPC methods -----------------------------------------------------
    def poll(self, step: int, max_records=None, now=None) -> int:
        self._cur_step = step
        if self.hooks.pending("pre_apply", step, kind="drop"):
            self.hooks.check("pre_apply", step)   # dropped fetch response
            return 0
        return self.scatter.poll(max_records, now=now)

    def lookup(self, group: str, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if self.cache is None or group not in self.cache.offsets:
            return self.shard.lookup(group, ids)
        block, hit = self.cache.lookup(ids)
        if block is None or not hit.all():
            # pull the miss set's COMBINED-group rows once and install
            # them, so the next lookup for any group hits
            miss = ids if block is None else ids[~hit]
            uniq = np.unique(miss)
            fill = np.empty((len(uniq), self.cache.width), np.float32)
            for g, (lo, hi) in self.cache.offsets.items():
                fill[:, lo:hi] = self.shard.lookup(g, uniq)
            self.cache.fill(uniq, fill)
            block, hit = self.cache.lookup(ids)
            if block is None or not hit.all():
                # the bound-trim evicted part of the fill: serve the
                # request straight from the shard tables
                return self.shard.lookup(group, ids)
        lo, hi = self.cache.offsets[group]
        return block[:, lo:hi]

    def offsets(self) -> dict:
        return self.scatter.offsets()

    def seek(self, offsets: dict) -> None:
        self.scatter.seek({int(k): int(v) for k, v in offsets.items()})
        if self.cache is not None:      # replay rewrites outside on_apply
            self.cache.clear()

    def load_group(self, group: str, ids: np.ndarray,
                   values: np.ndarray) -> None:
        self.shard.tables[group].scatter(np.asarray(ids, np.int64), values)
        if self.cache is not None:      # bulk load bypasses the stream
            self.cache.clear()

    def clear(self) -> None:
        """Hot-switch prelude: drop serve state + LWW seq memory so a
        checkpoint reload + offset seek replays into a clean table (on
        the worker's own row engine and device)."""
        from repro_torch.core.ps import SparseTable
        for g, dim in self.groups.items():
            self.shard.tables[g] = SparseTable(dim, **self.engine)
        self.shard._applied_seq = {}
        self.shard.dense = {}
        self.shard.dense_versions = {}
        if self.cache is not None:
            self.cache.clear()

    def table_state(self, group: str) -> dict:
        return _sorted_table_state(self.shard.tables[group])

    def metrics(self) -> dict:
        return self.registry.tree()

    def trace_dump(self) -> list:
        return obs_trace.get_tracer().export()


def _dispatch(worker, method: str, kwargs: dict):
    if method == "ping":
        return worker.name
    if method == "arm":
        worker.hooks.arm([FaultEvent(**e) for e in kwargs["events"]])
        return len(worker.hooks.events)
    fn = getattr(worker, method, None)
    if fn is None or method.startswith("_"):
        raise AttributeError(f"no RPC method {method!r}")
    return fn(**kwargs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("master", "slave"), required=True)
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--replica", type=int, default=-1)
    ap.add_argument("--root", required=True)
    ap.add_argument("--socket", required=True)
    args = ap.parse_args(argv)

    cfg = _load_runtime_cfg(args.root)
    if args.role == "master":
        worker = MasterWorker(args.shard, args.root, cfg)
    else:
        worker = SlaveWorker(args.shard, args.replica, args.root, cfg)
    print(f"[{worker.name}] pid={os.getpid()} ready", flush=True)
    server = RpcServer(args.socket,
                       lambda m, kw: _dispatch(worker, m, kw))
    server.serve_forever()
    print(f"[{worker.name}] shutdown", flush=True)
    sys.exit(0)


def fork_server() -> None:
    """The runtime's fork server: imports torch and this module once, then
    forks one worker per request line on stdin (JSON ``{"argv": [...],
    "log": path}``, ``argv`` as ``main`` takes it) and answers each with
    the child's pid on stdout. It reaps every child the moment it exits
    and ends at EOF. No CUDA call happens here: each worker initializes
    CUDA itself, after the fork."""
    import signal
    import traceback

    # loaded once, inherited by every fork: torch and the modules both
    # roles import (none of them touches CUDA at import)
    import repro_torch.core.streaming  # noqa: F401
    import repro_torch.obs.metrics  # noqa: F401
    import repro_torch.optim  # noqa: F401
    import repro_torch.serving.cache  # noqa: F401
    import torch  # noqa: F401

    def reap(*_) -> None:
        while True:
            try:
                pid, _status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return

    signal.signal(signal.SIGCHLD, reap)
    for line in sys.stdin:
        req = json.loads(line)
        pid = os.fork()
        if pid == 0:
            signal.signal(signal.SIGCHLD, signal.SIG_DFL)
            code = 1
            try:
                fd = os.open(req["log"], os.O_WRONLY | os.O_CREAT
                             | os.O_APPEND, 0o644)
                null = os.open(os.devnull, os.O_RDONLY)
                os.dup2(null, 0)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                os.close(fd)
                os.close(null)
                main(req["argv"])
                code = 0
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 0
            except BaseException:       # the child must not return into
                traceback.print_exc()   # the server's loop: log and exit
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        sys.stdout.write(f"{pid}\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
