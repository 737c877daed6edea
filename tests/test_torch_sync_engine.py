"""The port's ``ModelSyncEngine`` against the JAX package's, on the CPU:
the port of ``tests/test_sync_engine.py`` for the dense configs, the
MoE config granite-moe-3b-a800m (reduced: 4 experts), whose expert leaves
stream by (repeat, expert) id from the routed expert counts each step
reports, the SSM config mamba2-1.3b, whose Mamba leaves stream as
dense leaves, gemma3-4b, whose tied embedding streams as one dense
tensor beside its windowed and global layers, whisper-medium, whose
encoder's leaves (``encoder/segments/0/pos0/mixer/wq``, ...,
``encoder/final_norm``) stream as dense leaves in the reference's order,
llama-3.2-vision-90b's cross layers, and jamba-1.5-large-398b's hybrid
period (its expert leaves at four MoE positions beside Mamba, MLP and
attention leaves, under Adafactor's ``window`` mode).

Both engines are fed the same parameter trees (numpy, perturbed every
step) and the same tokens on the same clock, so their records — path,
seq, ids, metadata and payload bytes, partition by partition — and their
replicas' host arrays must be equal, for the identity, cast16 and int8
codecs (the port's int8 on its ``torch`` backend runs the codec kernels'
plain versions on the CPU; the reference's on NumPy). Then the port's
own training loop streams to its replica within the reference's
staleness bounds (1e-6 identity, 2e-3 cast16, 2e-2 int8), and the serve
params it materialises decode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.sync_engine import ModelSyncEngine as JaxEngine
from repro.core.sync_engine import SyncConfig as JaxSyncConfig
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MOE
from repro_torch.core import tree
from repro_torch.core.sync_engine import ModelSyncEngine, SyncConfig
from repro_torch.models import decode_step, init_cache
from repro_torch.training import init_train_state, make_train_step

CODECS = ["identity", "cast16", "int8"]


def _cfgs(arch, optimizer=None):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    if optimizer:
        jcfg = dataclasses.replace(jcfg, optimizer=optimizer)
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    return jcfg, cfg


def _to_torch(params):
    return tree.map_like(lambda a: torch.from_numpy(a.copy()), params)


def _queue_records(queue):
    return [queue.consume(p, 0)[0] for p in range(queue.num_partitions)]


def _same_record(a, b) -> None:
    assert (a.group, a.op, a.seq, a.producer) == \
        (b.group, b.op, b.seq, b.producer)
    np.testing.assert_array_equal(a.ids, b.ids)
    assert a.ids.dtype == b.ids.dtype
    assert a.meta == b.meta
    assert sorted(a.payload) == sorted(b.payload)
    for k in a.payload:
        x, y = np.asarray(a.payload[k]), np.asarray(b.payload[k])
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    assert a.nbytes() == b.nbytes()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("arch,optimizer", [
    ("qwen2-1.5b", None),          # tied embed: one dense tensor
    ("qwen2-7b", None),            # untied: embed rows, Adam -> cumulative
    ("qwen2-7b", "sgd"),           # untied, SGD -> window rows
    ("granite-moe-3b-a800m", None),   # experts, Adam -> cumulative
    ("granite-moe-3b-a800m", "sgd"),  # experts, SGD -> window
    ("mamba2-1.3b", None),         # Mamba leaves (float32 A_log, D, dt_bias)
    ("gemma3-4b", None),           # windowed and global layers, tied embed
    ("whisper-medium", None),      # the encoder's leaves, cross layers
    ("llama-3.2-vision-90b", None),   # cross layers; Adafactor -> window
    ("jamba-1.5-large-398b", None),   # hybrid: experts at four positions,
                                      # Mamba and attention; Adafactor
])
def test_records_and_replica_equal_reference(arch, optimizer, codec):
    """Five steps and the final flush on both engines; a MoE config's
    steps also report ``expert_counts_per_layer`` (random (R, E) counts,
    some experts unrouted: numpy to the reference, tensors to the
    port)."""
    jcfg, cfg = _cfgs(arch, optimizer)
    rng = np.random.default_rng(11)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            a.shape, dtype=np.float32),
        jax_init_params(jcfg, jax.random.PRNGKey(0)))
    kw = dict(gather_mode="period", period=1.0, codec=codec,
              num_partitions=4, embed_row_chunk=100)
    ref = JaxEngine(jcfg, params, JaxSyncConfig(codec_backend="numpy", **kw))
    port = ModelSyncEngine(cfg, _to_torch(params),
                           SyncConfig(codec_backend="torch", device="cpu",
                                      **kw))
    assert port.paths == ref.paths and port.kinds == ref.kinds
    if cfg.is_encdec:                       # dense, in the reference's order
        enc = [p for p in port.paths if p.startswith("encoder/")]
        assert "encoder/segments/0/pos0/mixer/wq" in enc
        assert "encoder/final_norm" in enc
        assert {port.kinds[p] for p in enc} == {"dense"}
    if cfg.tie_embeddings:                  # the tied table streams whole
        assert port.kinds["embed"] == "dense"
    for t in range(5):
        params = jax.tree.map(
            lambda a: a + 0.01 * rng.standard_normal(a.shape,
                                                     dtype=np.float32),
            params)
        tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        counts = [{f"pos{i}": rng.integers(0, 3, (seg.repeats,
                                                  cfg.num_experts))
                   .astype(np.int32) for i, spec in enumerate(seg.pattern)
                   if spec.ffn == MOE} for seg in cfg.segments]
        metrics = {"expert_counts_per_layer": counts} if cfg.num_experts \
            else None
        ref.collect_step(tokens, metrics)
        port.collect_step(torch.from_numpy(tokens), metrics and {
            "expert_counts_per_layer": [
                {k: torch.from_numpy(v) for k, v in seg.items()}
                for seg in counts]})
        assert port.tick(_to_torch(params), now=t * 0.5) == \
            ref.tick(params, now=t * 0.5)
    assert port.tick(_to_torch(params), now=1e9) == ref.tick(params, now=1e9)
    kinds = set()
    for want, got in zip(_queue_records(ref.queue),
                         _queue_records(port.queue)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_record(a, b)
            kinds.add(a.meta["kind"])
    assert ("experts" in kinds) == bool(cfg.num_experts)
    assert port.metrics() == ref.metrics()
    rep, jrep = port.replicas[0], ref.replicas[0]
    assert rep.applied == jrep.applied and rep.versions == jrep.versions
    for path in jrep.paths:
        np.testing.assert_array_equal(rep.host[path], jrep.host[path])
    assert rep.staleness(_to_torch(params)) == pytest.approx(
        jrep.staleness(params), rel=1e-6, abs=1e-12)


def _train_and_sync(sync_cfg, steps=6, batch=4, seq=32, seed=0,
                    arch="qwen2-1.5b"):
    """The reference test's loop on the port: train on the CPU, collect,
    tick every half second of a simulated clock, then the final flush."""
    cfg = reduced(get_config(arch))
    state = init_train_state(cfg, torch.Generator().manual_seed(seed))
    step = make_train_step(cfg)
    engine = ModelSyncEngine(cfg, state.params, sync_cfg)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
        state, _ = step(state, {"tokens": tokens})
        engine.collect_step(tokens)
        engine.tick(state.params, now=t * 0.5)
    engine.tick(state.params, now=1e9)       # final flush
    return cfg, state, engine


def _sync(**kw):
    kw.setdefault("gather_mode", "period")
    kw.setdefault("period", 1.0)
    return SyncConfig(codec_backend="torch", device="cpu", **kw)


@pytest.mark.parametrize("codec,bound", [
    ("identity", 1e-6), ("cast16", 2e-3), ("int8", 2e-2)])
def test_eventual_consistency_codec_bounds(codec, bound):
    _, state, engine = _train_and_sync(_sync(codec=codec))
    assert engine.replicas[0].staleness(state.params) < bound


def test_serve_params_usable_for_decode():
    cfg, state, engine = _train_and_sync(_sync(codec="cast16"))
    sp = engine.replicas[0].device_params(dtype="float32", device="cpu")
    assert [p for p, _ in tree.flatten_with_paths(sp)] == engine.paths
    for (_, a), (_, b) in zip(tree.flatten_with_paths(sp),
                              tree.flatten_with_paths(state.params)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert not a.requires_grad
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    logits, _ = decode_step(sp, cfg, cache, torch.zeros((2, 1),
                                                        dtype=torch.int32),
                            torch.zeros((2,), dtype=torch.int32))
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    bf = engine.replicas[0].device_params(device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="dtype"):
        engine.replicas[0].device_params(dtype="float16", device="cpu")


def test_mamba_leaves_stream_dense_and_serve_in_bf16():
    """A reduced mamba2-1.3b trained and synced (cast16): every leaf is
    ``"dense"``, the replica within the cast16 bound, and its bf16
    ``device_params`` (``A_log``, ``D`` and ``dt_bias`` cast too, as the
    reference casts every leaf) decode against a float32 cache to finite
    logits."""
    cfg, state, engine = _train_and_sync(_sync(codec="cast16"),
                                         arch="mamba2-1.3b")
    assert set(engine.kinds.values()) == {"dense"}
    assert "segments/0/pos0/mixer/A_log" in engine.paths
    assert engine.replicas[0].staleness(state.params) < 2e-3
    sp = engine.replicas[0].device_params(device="cpu")
    assert sp["segments"][0]["pos0"]["mixer"]["A_log"].dtype == \
        torch.bfloat16
    bf = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    cache = init_cache(bf, 2, 8, dtype=torch.float32, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for t in range(3):
        logits, cache = decode_step(sp, bf, cache, tok,
                                    torch.full((2,), t, dtype=torch.int32))
        assert logits.dtype == torch.bfloat16
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
        tok = logits.argmax(-1, keepdim=True).int()


def test_period_mode_dedups_dense_pushes():
    """10 steps with one flush -> each dense tensor pushed once, not 10x
    (the paper's repetition/dedup effect at tensor granularity)."""
    _, _, engine = _train_and_sync(_sync(period=1e6, codec="cast16"),
                                   steps=10)
    assert engine.gatherer.stats.dedup_ratio > 0.8
    assert engine._flushes == 1


def test_codec_bandwidth_ordering():
    pushed = [_train_and_sync(_sync(codec=c), steps=4)[2].pushed_bytes
              for c in ("int8", "cast16", "identity")]
    assert pushed[0] < pushed[1] < pushed[2]


def test_delta_threshold_skips_unchanged():
    """Tensors whose relative change is below the threshold are skipped;
    with a full refresh every flush nothing stays stale."""
    _, _, engine = _train_and_sync(_sync(codec="identity",
                                         delta_threshold=1e9))
    assert engine.skipped_dense > 0
    _, state, engine = _train_and_sync(_sync(
        codec="identity", delta_threshold=1e9, full_refresh_every=1))
    assert engine.replicas[0].staleness(state.params) < 1e-6


def test_unported_and_bad_configs_raise():
    """A reduced granite engine classifies its three expert leaves
    ``"experts"`` and its router ``"dense"``; a queue of another partition
    count and the default device without a card raise."""
    moe_cfg = reduced(get_config("granite-moe-3b-a800m"))
    moe_engine = ModelSyncEngine(moe_cfg, init_train_state(
        moe_cfg, torch.Generator().manual_seed(0)).params, _sync())
    ffn = "segments/0/pos0/ffn/"
    assert {p: k for p, k in moe_engine.kinds.items() if ffn in p} == {
        ffn + "norm": "dense", ffn + "router": "dense",
        ffn + "w_down": "experts", ffn + "w_gate": "experts",
        ffn + "w_up": "experts"}
    cfg = reduced(get_config("qwen2-1.5b"))
    params = init_train_state(cfg, torch.Generator().manual_seed(0)).params
    from repro_torch.core.queue import PartitionedQueue
    with pytest.raises(ValueError, match="partition"):
        ModelSyncEngine(cfg, params, _sync(), queue=PartitionedQueue(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ModelSyncEngine(cfg, params, SyncConfig())   # default: the card
