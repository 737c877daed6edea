"""Multi-process WeiPS cluster runtime: a supervisor that launches one OS
process per master/slave shard (``launch/worker.py``) over the placement
from ``launch/mesh.py`` + ``launch/specs.py``, drives a deterministic
training loop over RPC, and supervises faults — detect death, restore
from the manifest-committed checkpoint chain, seek scatters to checkpoint
queue offsets, replay, and fire domino downgrade off the streaming
evaluator. The counterpart of the reference's ``launch/runtime.py``.

Where the workers' PS runs is ``RuntimeConfig``'s ``device``,
``ps_backend`` and ``codec_backend`` (default: the torch backends on the
card). Every worker is its own process with its own CUDA context on that
one device (give an explicit index, ``"cuda:0"``, to pin them all to one
card); the supervisor itself keeps NumPy state only. It resolves the
device in its constructor, so asking for CUDA on a host without a GPU
raises before any process is spawned, and ``start`` builds the CTR
kernels' libraries once before the workers spawn, so they load them
instead of each compiling its own. Where the reference starts each
worker as ``python -m repro.launch.worker``, the port forks it from a
fork server that has imported torch once (``worker.fork_server``): a
spawn, a respawn after a SIGKILL and ``add_replica`` cost a fork and the
worker's own CUDA context, not the seconds of a torch import. The
worker's flags are the same (``ProcSpec.argv``).

Determinism contract (what makes the chaos tests reproducible):

  * the supervisor drives every worker serially — one RPC in flight at a
    time, so there is no request interleaving to race;
  * training batches are a pure function of ``(cfg.seed, step)``
    (``ClusterRuntime._batch``), so rewinding the step clock and
    replaying regenerates the *identical* gradient stream;
  * a restored ``Pusher`` re-emits the same per-group seqs for replayed
    flushes, so slaves LWW-skip (or idempotently re-apply) replayed
    records — post-recovery table state is bit-equal to a fault-free run;
  * fault events fire on exact (target, point, step) coordinates and the
    supervisor re-arms only *unfired* events on respawn, so a kill does
    not re-fire while the recovered cluster replays the step that died.

Supervisor state machine (see docs/FAULT_TOLERANCE.md):

    RUNNING --WorkerDied--> DETECT (reap dead procs, consume their kills)
            --> RESTORE (respawn; restore ALL masters from the latest
                committed manifest; bootstrap dead slaves from the
                materialized chain + seek to checkpoint queue offsets)
            --> CATCHUP (rewind the step clock to the manifest cut and
                replay; evaluator/checkpoint/downgrade are muted for
                already-observed steps) --> RUNNING
"""

from __future__ import annotations

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.downgrade import (DominoDowngrade,
                                        SmoothedThresholdTrigger,
                                        VersionManager)
from repro_torch.core.fault_tolerance import fold_chain
from repro_torch.core.monitor import StreamingEvaluator
from repro_torch.core.ps import PS_BACKENDS, resolve_device
from repro_torch.core.queue import FileQueue
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.transform import CODEC_BACKENDS
from repro_torch.launch.chaos import FaultPlan
from repro_torch.launch.mesh import ProcSlot, make_process_mesh
from repro_torch.launch.specs import (ProcSpec, plan_cluster_procs,
                                      proc_spec_for)
from repro_torch.launch.transport import RpcClient, WorkerDied
from repro_torch.obs import perfetto
from repro_torch.obs import trace as obs_trace

# the CUDA sources the workers' PS launches: the probes, the copies, the
# fused FTRL pass and the int8 codec
CTR_SOURCES = ("hashmap_probe", "embedding_lookup", "ftrl_row_update",
               "delta_codec")



class ForkedWorker:
    """A worker process forked by the runtime's fork server
    (``worker.fork_server``), with the part of ``subprocess.Popen`` the
    supervisor uses. It is the fork server's child, which reaps it the
    moment it exits; its exit status stays there, so ``poll()`` gives -1
    for a worker that is gone."""

    def __init__(self, pid: int):
        self.pid = pid

    def poll(self) -> Optional[int]:
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            return -1
        return None

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"worker {self.pid}",
                                                timeout)
            time.sleep(0.01)
        return -1

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


@dataclass
class RuntimeConfig:
    """Shape + schedule of one multi-process cluster run."""

    root: str                          # runtime dir (queue/ckpt/sock/logs)
    num_master: int = 2
    num_slave: int = 2
    num_replicas: int = 1
    num_partitions: int = 4
    groups: dict = field(default_factory=lambda: {"emb": 1})
    optimizer: str = "ftrl"
    optimizer_kwargs: dict = field(default_factory=dict)
    codec: str = "identity"
    seed: int = 0
    batch_size: int = 32
    vocab: int = 512                   # sparse id space
    feats_per_sample: int = 8
    ckpt_every: int = 5                # steps between checkpoint cuts
    full_every: int = 3                # every Nth checkpoint is full
    trigger_threshold: float = 10.0    # smoothed logloss downgrade trigger
    trigger_window: int = 5
    trigger_min_points: int = 3
    downgrade_cooldown: float = 5.0    # sim-seconds (= steps)
    connect_timeout: float = 120.0     # the fork server's torch import
    trace: bool = False                # span tracing in every process
    trace_capacity: int = 1 << 15      # per-process span ring size
    serve_cache_rows: int = 1 << 16    # slave serve cache (0 disables)
    device: str = "cuda"               # every worker's PS device
    ps_backend: str = "torch"          # numpy | torch (device-mirror rows)
    codec_backend: str = "torch"       # numpy | torch (int8 codec kernels)


@dataclass
class Manifest:
    """One committed checkpoint version: per-shard part files + the queue
    cut. Duck-types ``Checkpoint`` where ``VersionManager`` needs it
    (``metrics`` for best-metric picks); the commit is the atomic rename
    of the manifest JSON — part files without a manifest are invisible,
    which is exactly what keeps a kill mid-checkpoint harmless."""

    version: int
    kind: str                          # "full" | "delta"
    base: Optional[int]                # previous version (delta chains)
    step: int                          # driver step to resume from
    queue_offsets: dict                # partition -> produced offset at cut
    parts: dict                        # shard_id -> part file name
    metrics: dict = field(default_factory=dict)


class ManifestStore:
    """Checkpoint-chain storage for the multi-process runtime. Part files
    are written by the master workers (tmp + atomic rename); the
    supervisor commits the version by atomically renaming the manifest
    JSON into place. Duck-types ``CheckpointStore`` for the core
    ``VersionManager``/``DominoDowngrade`` (``versions()``/``load()``).
    ``codec_backend`` and ``device`` are ``fold_chain``'s decode engine
    for compressed parts."""

    def __init__(self, root: str, codec_backend: str = "torch",
                 device="cuda"):
        self.root = root
        self.codec_backend = codec_backend
        self.device = device
        os.makedirs(root, exist_ok=True)

    def _manifest_path(self, version: int) -> str:
        return os.path.join(self.root, f"v{version}.json")

    def part_path(self, version: int, shard_id: int) -> str:
        return os.path.join(self.root, f"v{version}-shard{shard_id}.pkl")

    def versions(self) -> list[int]:
        out = []
        for f in os.listdir(self.root):
            if f.startswith("v") and f.endswith(".json"):
                try:
                    out.append(int(f[1:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    def load(self, version: int) -> Manifest:
        with open(self._manifest_path(version)) as f:
            d = json.load(f)
        return Manifest(
            version=d["version"], kind=d["kind"], base=d["base"],
            step=d["step"],
            queue_offsets={int(k): int(v)
                           for k, v in d["queue_offsets"].items()},
            parts={int(k): v for k, v in d["parts"].items()},
            metrics=d.get("metrics", {}))

    def commit(self, man: Manifest) -> None:
        path = self._manifest_path(man.version)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": man.version, "kind": man.kind,
                       "base": man.base, "step": man.step,
                       "queue_offsets": man.queue_offsets,
                       "parts": man.parts, "metrics": man.metrics},
                      f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def chain(self, version: int) -> list[Manifest]:
        """Manifests oldest-first from the nearest full up to ``version``."""
        chain = [self.load(version)]
        while chain[-1].kind != "full":
            if chain[-1].base is None:
                raise RuntimeError(f"delta v{chain[-1].version} has no base")
            chain.append(self.load(chain[-1].base))
        chain.reverse()
        return chain

    def materialize(self, version: int):
        """Fold the chain into full-equivalent per-shard snapshots plus
        the pusher seqs at the tip cut. Returns ``(snaps, seqs)`` with
        ``snaps[shard_id]`` in ``MasterShard.load_snapshot`` format."""
        links, seqs = [], {}
        for man in self.chain(version):
            link = {}
            for sid, fname in man.parts.items():
                with open(os.path.join(self.root, fname), "rb") as f:
                    part = pickle.load(f)
                link[sid] = part["snap"]
                seqs[sid] = part["pusher_seqs"]   # tip link wins
            links.append(link)
        return fold_chain(links, codec_backend=self.codec_backend,
                          device=self.device), seqs


class ClusterRuntime:
    """Launcher + supervisor for the process-per-shard WeiPS cluster."""

    def __init__(self, cfg: RuntimeConfig,
                 plan: Optional[FaultPlan] = None):
        if cfg.ps_backend not in PS_BACKENDS:
            raise ValueError(f"ps_backend must be one of {PS_BACKENDS}, "
                             f"got {cfg.ps_backend!r}")
        if cfg.codec_backend not in CODEC_BACKENDS:
            raise ValueError(f"codec_backend must be one of "
                             f"{CODEC_BACKENDS}, got {cfg.codec_backend!r}")
        # raise here, before any worker is spawned, if the device is not
        # there
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.plan = plan or FaultPlan(seed=cfg.seed, events=[])
        os.makedirs(cfg.root, exist_ok=True)
        for sub in ("queue", "ckpt", "sock", "logs"):
            os.makedirs(os.path.join(cfg.root, sub), exist_ok=True)
        with open(os.path.join(cfg.root, "runtime.json"), "w") as f:
            json.dump({"num_master": cfg.num_master,
                       "num_slave": cfg.num_slave,
                       "num_partitions": cfg.num_partitions,
                       "groups": cfg.groups, "optimizer": cfg.optimizer,
                       "optimizer_kwargs": cfg.optimizer_kwargs,
                       "codec": cfg.codec, "gather_mode": "realtime",
                       "trace": cfg.trace,
                       "trace_capacity": cfg.trace_capacity,
                       "serve_cache_rows": cfg.serve_cache_rows,
                       "device": str(self.device),
                       "ps_backend": cfg.ps_backend,
                       "codec_backend": cfg.codec_backend},
                      f, indent=2, sort_keys=True)
        with open(os.path.join(cfg.root, "fault_plan.json"), "w") as f:
            f.write(self.plan.to_json())
        self.routing = RoutingPlan(cfg.num_master, cfg.num_slave,
                                   cfg.num_partitions)
        # creating the supervisor's queue handle first writes meta.json,
        # which the workers' handles validate against
        self.queue = FileQueue(os.path.join(cfg.root, "queue"),
                               cfg.num_partitions)
        self.pmesh = make_process_mesh(cfg.num_master, cfg.num_slave,
                                       cfg.num_replicas)
        self.specs: dict[str, ProcSpec] = {
            s.name: s for s in plan_cluster_procs(self.pmesh, cfg.root)}
        self.procs: dict[str, ForkedWorker] = {}
        self._fork_server: Optional[subprocess.Popen] = None
        self.clients: dict[str, RpcClient] = {}
        self.store = ManifestStore(os.path.join(cfg.root, "ckpt"),
                                   codec_backend=cfg.codec_backend,
                                   device=self.device)
        self.versions = VersionManager(self.store)
        self.evaluator = StreamingEvaluator(window=cfg.trigger_window * 4)
        self.downgrader = DominoDowngrade(
            SmoothedThresholdTrigger(
                metric="logloss", threshold=cfg.trigger_threshold,
                window=cfg.trigger_window, direction="above",
                min_points=cfg.trigger_min_points),
            self.versions, self._hot_switch,
            cooldown=cfg.downgrade_cooldown)
        self.step = 0
        self.recoveries = 0
        self._fired: set = set()          # supervisor-consumed FaultEvents
        self._replaying_until = 0         # steps < this replay (muted)
        self._force_full = False
        # seconds of the last recover(): waiting for the dead to be
        # reaped, respawn + reconnect, and the restore RPCs
        self.last_recovery: dict = {}
        # the regression target the labels are drawn from — fixed per
        # seed, so the model actually learns and logloss moves
        rng = np.random.default_rng(cfg.seed)
        self._w_true = rng.normal(0.0, 0.5, size=cfg.vocab)
        self._log_f = open(os.path.join(cfg.root, "logs", "supervisor.log"),
                           "a", buffering=1)
        os.makedirs(os.path.join(cfg.root, "trace"), exist_ok=True)
        if cfg.trace:
            obs_trace.configure(enabled=True, process="supervisor",
                                capacity=cfg.trace_capacity)

    # -- logging ---------------------------------------------------------
    def _log(self, msg: str) -> None:
        self._log_f.write(f"[step {self.step}] {msg}\n")

    # -- process lifecycle -----------------------------------------------
    def _fork_server_proc(self) -> subprocess.Popen:
        """This runtime's fork server (``worker.fork_server``), started on
        first use: it imports torch and the worker module once (never
        CUDA, which every worker initializes for itself), so a spawn or a
        respawn costs a fork, not the seconds of a torch import."""
        if self._fork_server is None or self._fork_server.poll() is not None:
            src = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
            log = open(os.path.join(self.cfg.root, "logs", "fork_server.log"),
                       "ab", buffering=0)
            self._fork_server = subprocess.Popen(
                [sys.executable, "-c", "from repro_torch.launch.worker "
                 "import fork_server; fork_server()"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
                env=env, text=True, bufsize=1)
            log.close()
        return self._fork_server

    def _spawn(self, spec: ProcSpec) -> None:
        """Fork the slot's worker from the fork server: ``spec.argv``
        after ``python -m repro_torch.launch.worker`` are its flags, and
        its output goes to ``spec.log_path``."""
        server = self._fork_server_proc()
        server.stdin.write(json.dumps({"argv": list(spec.argv[3:]),
                                       "log": spec.log_path}) + "\n")
        server.stdin.flush()
        pid = server.stdout.readline()
        if not pid:
            raise RuntimeError(f"the worker fork server exited; see "
                               f"{self.cfg.root}/logs/fork_server.log")
        self.procs[spec.name] = ForkedWorker(int(pid))
        c = RpcClient(spec.socket, connect_timeout=self.cfg.connect_timeout)
        self.clients[spec.name] = c

    @staticmethod
    def _reap(p) -> None:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    def _connect(self, name: str) -> None:
        self.clients[name].connect()
        self.clients[name].call("ping")
        self._arm(name)

    def _arm(self, name: str) -> None:
        """Arm the plan's events for one worker, minus those the
        supervisor already saw fire — the no-refire-during-replay rule."""
        from dataclasses import asdict
        events = [asdict(e) for e in self.plan.for_target(name)
                  if e not in self._fired]
        self.clients[name].call("arm", events=events)

    def master_names(self) -> list[str]:
        return [s.name for s in self.pmesh.masters()]

    def slave_names(self) -> list[str]:
        return [n for n in self.specs if n.startswith("slave-")]

    def start(self) -> None:
        """Spawn + connect the whole grid (every worker forked from the
        fork server, which pays the torch import once; serial connect),
        then cut the bootstrap checkpoint v1 at step 0 so
        recovery always has a restore point. On a CUDA device the CTR
        kernels' libraries are built first, once (a no-op when they are
        built already); a worker that fails to load one answers its RPC
        with an ``"err"`` reply, which raises here."""
        if self.device.type == "cuda" and "torch" in (
                self.cfg.ps_backend, self.cfg.codec_backend):
            from repro_torch.kernels import _build
            _build.build(CTR_SOURCES)
        for spec in self.specs.values():
            self._spawn(spec)
        for name in self.specs:
            self._connect(name)
        self._log(f"cluster up: {sorted(self.procs)}")
        self.checkpoint(force_full=True)

    def shutdown(self) -> None:
        for name, c in self.clients.items():
            try:
                c.call("shutdown")
            except (WorkerDied, RuntimeError):
                pass
            c.close()
        for p in self.procs.values():
            self._reap(p)
        if self._fork_server is not None:
            self._fork_server.stdin.close()       # EOF: the server exits
            self._reap(self._fork_server)
        self.queue.close()
        self._log_f.close()

    # -- deterministic data plane ----------------------------------------
    def _batch(self, step: int):
        """Pure function of (seed, step): feature ids + labels drawn from
        the fixed linear teacher, so replay regenerates identical data
        and the learned logloss trends down (the downgrade trigger's
        signal)."""
        c = self.cfg
        rng = np.random.default_rng(c.seed * 1_000_003 + step)
        ids = rng.integers(0, c.vocab, size=(c.batch_size,
                                             c.feats_per_sample))
        logit = self._w_true[ids].sum(axis=1)
        y = (logit > 0.0).astype(np.float32)
        return ids.astype(np.int64), y

    def _pull_w(self, flat_ids: np.ndarray) -> np.ndarray:
        w = np.zeros(len(flat_ids), np.float32)
        owner = self.routing.master_shard(flat_ids)
        for m, name in enumerate(self.master_names()):
            mask = owner == m
            if mask.any():
                rows = self.clients[name].call(
                    "pull", group="emb", ids=flat_ids[mask])
                w[mask] = np.asarray(rows, np.float32).reshape(-1)
        return w

    def step_once(self) -> dict:
        """One supervisor-driven training step: pull → predict → observe →
        apply → flush → scatter-poll → maybe checkpoint → maybe downgrade.
        Raises ``WorkerDied`` when a fault event kills a worker mid-step —
        the caller (``run_to``) routes that into ``recover``."""
        c, step = self.cfg, self.step
        now = float(step)
        tr = obs_trace.get_tracer()
        t_step = tr.clock() if tr.enabled else 0.0
        replaying = step < self._replaying_until
        ids, y = self._batch(step)
        flat = ids.reshape(-1)
        w = self._pull_w(flat)
        logits = w.reshape(ids.shape).sum(axis=1)
        p = 1.0 / (1.0 + np.exp(-logits))
        if not replaying:
            self.evaluator.observe(t=now, step=step, y=y, p=p)
        grads = np.repeat(p - y, c.feats_per_sample).astype(np.float32)
        owner = self.routing.master_shard(flat)
        for m, name in enumerate(self.master_names()):
            mask = owner == m
            if mask.any():
                self.clients[name].call(
                    "apply", group="emb", ids=flat[mask],
                    grads=grads[mask][:, None], step=step)
        pushed = 0
        for name in self.master_names():
            pushed += self.clients[name].call("flush", step=step, now=now)
        applied = 0
        for name in self.slave_names():
            applied += self.clients[name].call("poll", step=step, now=now)
        self.step = step + 1
        if not replaying and self.step % c.ckpt_every == 0:
            self.checkpoint()
        if self.step >= self._replaying_until:
            v = self.downgrader.maybe_downgrade(now, self.evaluator)
            if v is not None:
                self._log(f"domino downgrade -> v{v}")
        if tr.enabled:
            tr.record("driver.step", t0=t_step, t1=tr.clock(), step=step,
                      pushed=pushed, applied=applied)
        return {"step": step, "pushed": pushed, "applied": applied,
                "p": p}

    def run_to(self, step: int) -> None:
        """Drive the cluster to ``step``, recovering from every injected
        death along the way. This loop IS the supervisor state machine:
        RUNNING (step_once) → DETECT/RESTORE/CATCHUP (recover) →
        RUNNING."""
        while self.step < step:
            try:
                self.step_once()
            except WorkerDied as e:
                self._log(f"worker death detected: {e}")
                self.recover()

    # -- checkpointing ----------------------------------------------------
    def _next_version(self) -> int:
        latest = self.store.latest()
        return 1 if latest is None else latest + 1

    def checkpoint(self, force_full: bool = False) -> int:
        """Cut a distributed checkpoint: every master writes its part
        (tmp + atomic rename), then the supervisor commits the manifest.
        The queue cut is the produced offsets at this instant — every
        record a restored state has already folded in sits below it."""
        tr = obs_trace.get_tracer()
        t_ckpt = tr.clock() if tr.enabled else 0.0
        v = self._next_version()
        latest = self.store.latest()
        kind = "full" if (force_full or self._force_full or latest is None
                          or len(self.store.versions()) % self.cfg.full_every
                          == 0) else "delta"
        parts, kinds = {}, []
        for m, name in enumerate(self.master_names()):
            path = self.store.part_path(v, m)
            res = self.clients[name].call(
                "checkpoint_part", version=v, kind=kind, path=path,
                step=self.step)
            kinds.append(res["kind"])
            parts[m] = os.path.basename(path)
        kind = "full" if all(k == "full" for k in kinds) else "delta"
        metrics = {}
        if self.evaluator.history:
            metrics["logloss"] = float(self.evaluator.smoothed("logloss"))
        man = Manifest(version=v, kind=kind,
                       base=latest if kind == "delta" else None,
                       step=self.step,
                       queue_offsets=self.queue.latest_offsets(),
                       parts=parts, metrics=metrics)
        self.store.commit(man)
        self.versions.current_version = v
        self._force_full = False
        if tr.enabled:
            tr.record("ckpt.commit", t0=t_ckpt, t1=tr.clock(), version=v,
                      kind=kind, step=self.step)
        self._log(f"checkpoint v{v} ({kind}) committed at step {self.step}")
        return v

    # -- fault recovery ----------------------------------------------------
    def _dead(self) -> list[str]:
        return [n for n, p in self.procs.items() if p.poll() is not None]

    def recover(self) -> None:
        """DETECT → RESTORE → CATCHUP. Respawn every dead process,
        restore ALL masters from the latest committed manifest (the
        trajectory-preserving cut), bootstrap dead slaves from the
        materialized chain + checkpoint queue offsets, rewind the step
        clock and let ``run_to`` replay the gap deterministically."""
        self.recoveries += 1
        tr = obs_trace.get_tracer()
        if tr.enabled:
            tr.instant("fault.detected", step=self.step)
        t_rec = tr.clock() if tr.enabled else 0.0
        t0 = time.perf_counter()
        # the socket EOF can beat the SIGKILLed child's exit becoming
        # visible to waitpid — give the reap a moment
        deadline = time.monotonic() + 10.0
        dead = self._dead()
        while not dead and time.monotonic() < deadline:
            time.sleep(0.02)
            dead = self._dead()
        if not dead:
            raise RuntimeError("recover() called with no dead workers")
        t_reap = time.perf_counter()
        for name in dead:
            # consume this worker's already-fired events (anything armed
            # at or before the current step) so respawn does not re-fire
            # them during replay
            for e in self.plan.for_target(name):
                if e.step <= self.step:
                    self._fired.add(e)
            self.clients[name].close()
            self.procs[name].wait()
            self._log(f"respawning {name}")
            self._spawn(self.specs[name])
        for name in dead:
            self._connect(name)
        t_respawn = time.perf_counter()
        v = self.store.latest()
        if v is None:
            raise RuntimeError("no committed checkpoint to recover from")
        man = self.store.load(v)
        snaps, seqs = self.store.materialize(v)
        for m, name in enumerate(self.master_names()):
            self.clients[name].call(
                "restore", snap=snaps[m], pusher_seqs=seqs.get(m, {}),
                step=man.step)
        for name in dead:
            if name.startswith("slave-"):
                self._bootstrap_slave(name, man, snaps)
        self._replaying_until = max(self._replaying_until, self.step)
        t_end = time.perf_counter()
        self.last_recovery = {"reap_s": t_reap - t0,
                              "respawn_s": t_respawn - t_reap,
                              "restore_s": t_end - t_respawn,
                              "workers": sorted(dead)}
        self._log(f"restored from v{v}; rewinding step "
                  f"{self.step} -> {man.step} (replay)")
        if tr.enabled:
            tr.record("recover", t0=t_rec, t1=tr.clock(), version=v,
                      rewind_to=man.step, workers=",".join(sorted(dead)))
        self.step = man.step
        self._force_full = True

    def _bootstrap_slave(self, name: str, man: Manifest,
                         snaps: dict) -> None:
        """Serve-state bootstrap for a fresh/reborn replica: install the
        checkpoint's serve rows for the ids this shard owns, seek its
        scatter to the checkpoint's queue offsets, then poll — the live
        stream replays everything after the cut on top (full-value
        upserts, so racing the stream is safe)."""
        shard_id = int(name.split("-", 1)[1].split(".")[0])
        c = self.clients[name]
        for snap in snaps.values():
            for g, rows in snap["tables"].items():
                ids = np.asarray(rows["ids"], np.int64)
                if not len(ids):
                    continue
                keep = self.routing.slave_shard(ids) == shard_id
                if keep.any():
                    # FTRL stores the derived serve weight in w (same
                    # _np_weights the push transform runs), so the
                    # checkpoint's w column IS the serve value
                    c.call("load_group", group=g, ids=ids[keep],
                           values=np.asarray(rows["w"])[keep])
        c.call("seek", offsets=man.queue_offsets)
        c.call("poll", step=-1)        # catch-up; step -1 matches no event

    # -- domino downgrade --------------------------------------------------
    def _hot_switch(self, man: Manifest) -> None:
        """Downgrade switch_fn: reload every slave replica's serve state
        from the target version's chain and seek scatters to its queue
        offsets — the serving plane hops back to the stable version while
        masters keep training."""
        snaps, _seqs = self.store.materialize(man.version)
        for name in self.slave_names():
            self.clients[name].call("clear")
            self._bootstrap_slave(name, man, snaps)
        self._log(f"hot switch to v{man.version} complete")

    # -- elastic replicas --------------------------------------------------
    def add_replica(self, shard_id: int) -> str:
        """Add one slave replica at runtime: spawn, bootstrap from the
        latest committed checkpoint, catch up from the stream."""
        existing = [int(n.split(".")[1]) for n in self.slave_names()
                    if n.startswith(f"slave-{shard_id}.")]
        replica = max(existing) + 1 if existing else 0
        slot = ProcSlot("slave", shard_id, replica)
        spec = proc_spec_for(slot, self.cfg.root)
        self.specs[spec.name] = spec
        self._spawn(spec)
        self._connect(spec.name)
        v = self.store.latest()
        if v is not None:
            man = self.store.load(v)
            snaps, _ = self.store.materialize(v)
            self._bootstrap_slave(spec.name, man, snaps)
        self._log(f"replica {spec.name} joined")
        return spec.name

    def remove_replica(self, name: str) -> None:
        """Drain one slave replica out of the grid."""
        if not name.startswith("slave-"):
            raise ValueError(f"only slave replicas can be removed: {name!r}")
        c = self.clients.pop(name)
        try:
            c.call("shutdown")
        except (WorkerDied, RuntimeError):
            pass
        c.close()
        self._reap(self.procs.pop(name))
        del self.specs[name]
        self._log(f"replica {name} removed")

    # -- observability -----------------------------------------------------
    def cluster_metrics(self) -> dict:
        """Supervisor-side aggregation: every worker's ``metrics`` RPC
        (each a ``MetricsRegistry.tree()``) keyed by name, plus sums the
        dashboards want. A dead worker is skipped, not fatal — metrics
        must stay readable mid-fault."""
        workers: dict = {}
        for name, c in self.clients.items():
            try:
                workers[name] = c.call("metrics")
            except (WorkerDied, RuntimeError, OSError):
                workers[name] = None
        live = {n: m for n, m in workers.items() if m is not None}
        agg = {
            "pushed_records": sum(m.get("pushed_records", 0)
                                  for m in live.values()),
            "pushed_bytes": sum(m.get("pushed_bytes", 0)
                                for m in live.values()),
            "applied": sum(m.get("applied", 0) for m in live.values()),
            "skipped": sum(m.get("skipped", 0) for m in live.values()),
            "staleness_p99": max(
                (m["staleness"].get("p99", 0.0) or 0.0
                 for m in live.values() if "staleness" in m),
                default=0.0),
        }
        return {"step": self.step, "recoveries": self.recoveries,
                "workers": workers, "aggregate": agg}

    def export_trace(self, path: str) -> int:
        """Merge the supervisor's spans, every live worker's ring
        (``trace_dump`` RPC), and the pre-kill dump files killed workers
        left under ``<root>/trace/`` into one Perfetto JSON at ``path``.
        Returns the number of exported events."""
        lists = [obs_trace.get_tracer().export()]
        for name, c in self.clients.items():
            try:
                lists.append(c.call("trace_dump"))
            except (WorkerDied, RuntimeError, OSError):
                pass
        dump_dir = os.path.join(self.cfg.root, "trace")
        for f in sorted(os.listdir(dump_dir)):
            if not f.endswith(".json"):
                continue
            try:
                with open(os.path.join(dump_dir, f)) as fh:
                    lists.append(json.load(fh))
            except (OSError, ValueError):
                continue
        spans = perfetto.merge_spans(*lists)
        return perfetto.write_trace(path, spans)

    # -- state inspection (tests) ------------------------------------------
    def master_state(self, group: str = "emb") -> dict:
        return {n: self.clients[n].call("table_state", group=group)
                for n in self.master_names()}

    def slave_state(self, group: str = "emb") -> dict:
        return {n: self.clients[n].call("table_state", group=group)
                for n in self.slave_names()}

    def __enter__(self) -> "ClusterRuntime":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
