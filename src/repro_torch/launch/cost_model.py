"""Repeat-corrected cost model — the counterpart of the reference's
``launch/cost_model.py``.

The reference's ``cost_analysis`` counts a scan body once whatever its
trip count, so it adds ``(repeats - 1) x body_cost`` a segment. The
port's op-by-op count sees every repeat it runs; to keep the
reference's arithmetic, and a jamba pass at 16 counted layers instead
of 72, the dry-run counts the main program on the config with one
repeat a segment (``one_repeat``) and ``corrected_cost`` adds ``(repeats
- 1) x segment_body_cost`` — one more repeat of the segment in the
program, counted as the program with that segment at two repeats less
the main program, so the repeat sees the placements, remat and
backward structure the whole program gives it. Every term (FLOPs,
bytes, collective operand bytes) is corrected the same way.

``bytes_per_device`` is the no-fusion sum of each op's input and output
bytes on local shards (``hlo_analysis.CostMode``), the role of the XLA
CPU figure the reference calls an upper bound. ``analytic_hbm_bytes``
and ``activation_estimate`` are the reference's pure arithmetic on the
config and the mesh, copied exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.hlo_analysis import CostMode, collectives_from_comm_mode
from repro_torch.models import model as model_lib
from repro_torch.models.common import mesh_scope
from repro_torch.models.sharding import MeshInfo


@dataclass
class StepCost:
    flops_per_device: float
    bytes_per_device: float
    collective_operand_bytes_per_device: float
    collective_counts: dict

    def scaled(self, k: float) -> "StepCost":
        return StepCost(self.flops_per_device * k, self.bytes_per_device * k,
                        self.collective_operand_bytes_per_device * k,
                        {kk: v * k for kk, v in self.collective_counts.items()})

    def __add__(self, o: "StepCost") -> "StepCost":
        cc = dict(self.collective_counts)
        for k, v in o.collective_counts.items():
            cc[k] = cc.get(k, 0) + v
        return StepCost(self.flops_per_device + o.flops_per_device,
                        self.bytes_per_device + o.bytes_per_device,
                        self.collective_operand_bytes_per_device
                        + o.collective_operand_bytes_per_device, cc)


def cost_of(mode: CostMode) -> StepCost:
    """The ``StepCost`` a ``CostMode`` counted."""
    coll = collectives_from_comm_mode(mode)
    return StepCost(float(mode.flops), float(mode.bytes),
                    float(coll.total_operand_bytes), dict(coll.counts))


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), CostMode)``: the call counted, plain tensors
    it creates standing for replicated ones among ``DTensor``s."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode


def one_repeat(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with every segment (decoder and encoder) run once."""
    def once(segs):
        return tuple(dataclasses.replace(s, repeats=1) for s in segs)
    return dataclasses.replace(cfg, segments=once(cfg.segments),
                               encoder_segments=once(cfg.encoder_segments))


def step_arguments(cfg: ModelConfig, shape: InputShape, m: MeshInfo,
                   kv_quant: bool, fake_mode) -> tuple:
    """The step's abstract arguments: (state, batch) for train, (params,
    batch) for prefill, (params, cache, tokens, pos) for decode."""
    from repro_torch.launch.specs import (abstract_params,
                                          abstract_train_state, input_specs)
    with fake_mode:
        specs = input_specs(cfg, shape, m, kv_quant=kv_quant,
                            fake_mode=fake_mode)
        if shape.kind == "train":
            return (abstract_train_state(cfg, m, fake_mode=fake_mode),
                    specs["batch"])
        params = abstract_params(cfg, m, fake_mode=fake_mode)
        if shape.kind == "prefill":
            return params, specs["batch"]
        return params, specs["cache"], specs["tokens"], specs["pos"]


def count_step(cfg: ModelConfig, shape: InputShape, m: MeshInfo, *,
               kv_quant: bool = False, fake_mode):
    """``(CostMode, arguments, output)`` of the port's own train, prefill
    or serve step for ``shape`` on abstract arguments, counted."""
    from repro_torch.serving import make_prefill_step, make_serve_step
    from repro_torch.training import make_train_step
    args = step_arguments(cfg, shape, m, kv_quant, fake_mode)
    step = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_serve_step}[shape.kind](cfg)
    with fake_mode, mesh_scope(m), torch.set_grad_enabled(
            shape.kind == "train"):
        out, mode = count(step, *args)
    return mode, args, out


def _with_repeats(cfg: ModelConfig, seg: Segment, encoder: bool,
                  repeats: int) -> ModelConfig:
    """``one_repeat(cfg)`` with ``seg`` run ``repeats`` times."""
    one = one_repeat(cfg)
    field = "encoder_segments" if encoder else "segments"
    segs = tuple(dataclasses.replace(s, repeats=repeats) if orig is seg
                 else s for s, orig in zip(getattr(one, field),
                                           getattr(cfg, field)))
    return dataclasses.replace(one, **{field: segs})


def segment_body_cost(cfg: ModelConfig, seg: Segment, m: MeshInfo,
                      shape: InputShape, *, kind: str,
                      encoder: bool = False, kv_quant: bool = False,
                      fake_mode=None, main: StepCost = None) -> StepCost:
    """Counted cost of one repeat of this segment: the program with the
    segment at two repeats less the program at one (``main``, counted
    here if not given). The added repeat sits between pinned residual
    layouts, as every repeat of the whole program does, so its
    placements — and DTensor's choices for it — are the whole
    program's (a body counted alone would see its output gradient laid
    out otherwise)."""
    from repro_torch.launch.specs import _fake_mode
    fake_mode = fake_mode or _fake_mode()
    if kind != shape.kind:
        raise ValueError(f"kind {kind!r} is not the shape's {shape.kind!r}")
    if main is None:
        main = cost_of(count_step(one_repeat(cfg), shape, m,
                                  kv_quant=kv_quant, fake_mode=fake_mode)[0])
    two = cost_of(count_step(_with_repeats(cfg, seg, encoder, 2), shape, m,
                             kv_quant=kv_quant, fake_mode=fake_mode)[0])
    return two + main.scaled(-1)


def corrected_cost(main: StepCost, cfg: ModelConfig, m: MeshInfo,
                   shape: InputShape, fake_mode=None, kv_quant: bool = False
                   ) -> tuple[StepCost, dict]:
    """The main program's cost (counted on ``one_repeat(cfg)``) +
    (repeats-1) x body cost per segment."""
    total = main
    detail = {"main": dataclasses.asdict(main), "segments": []}
    seg_sets = [(cfg.segments, False)]
    if cfg.encoder_segments and shape.kind in ("train", "prefill"):
        seg_sets.append((cfg.encoder_segments, True))
    for segments, is_enc in seg_sets:
        for seg in segments:
            if seg.repeats <= 1:
                continue
            body = segment_body_cost(cfg, seg, m, shape, kind=shape.kind,
                                     encoder=is_enc, kv_quant=kv_quant,
                                     fake_mode=fake_mode, main=main)
            detail["segments"].append(
                {"repeats": seg.repeats, "encoder": is_enc,
                 **{k: v for k, v in body.__dict__.items()
                    if k != "collective_counts"}})
            total = total + body.scaled(seg.repeats - 1)
    return total, detail


def _itemsize(name: str) -> int:
    return model_lib._dtype(name).itemsize


def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape,
                       m: MeshInfo, arg_bytes_per_device: int) -> float:
    """HBM traffic estimate assuming elementwise fusion (the op-by-op
    byte count overstates it). Components: weight reads (fwd + remat recompute
    + bwd), grad+optimizer r/w, boundary activation materializations, KV
    cache reads, logits. Reported alongside the XLA number; the roofline's
    memory term uses this estimate."""
    n_dev = m.size
    dt = _itemsize(cfg.dtype)
    pc = cfg.param_counts()
    p_loc = pc["active"] * dt / n_dev            # active weights/device/step
    b_loc = max(1.0, shape.global_batch /
                (m.data * m.axes.get("pod", 1)))
    s = shape.seq_len
    specs = cfg.layer_specs()
    n_layers = max(1, len(specs))

    if shape.kind == "decode":
        kv_layers = sum(1 for sp in specs if sp.mixer == "attn")
        local_layers = sum(1 for sp in specs if sp.mixer == "local")
        kv_shards = (m.data * m.model if shape.global_batch < m.data
                     else m.model)
        kv_loc = s / max(1, kv_shards)
        cache_read = (kv_layers * 2 * b_loc * kv_loc
                      + local_layers * 2 * b_loc * min(cfg.window_size or s, s)
                      ) * cfg.num_kv_heads * cfg.head_dim * dt
        ssm_layers = sum(1 for sp in specs if sp.mixer == "mamba")
        ssm_state = ssm_layers * b_loc * cfg.ssm_num_heads * \
            cfg.ssm_head_dim * max(cfg.ssm_state, 1) * 4 * 2 / max(1, m.model)
        weights = p_loc                           # one read per token step
        return weights + cache_read + ssm_state

    # train / prefill
    remat_factor = 2 if (shape.kind == "train" and cfg.remat) else 1
    w_reads = remat_factor + (1 if shape.kind == "train" else 0)
    weights = p_loc * w_reads
    if shape.kind == "train":
        slots_per_param = {"adam": 8, "momentum": 4, "adagrad": 4,
                           "ftrl": 8, "adafactor": 0.1, "sgd": 0}
        weights += (pc["total"] / n_dev) * (
            dt * 2                                 # grad write+read
            + slots_per_param.get(cfg.optimizer, 8)  # slot r/w (f32)
            + dt)                                  # param write
    # boundary activations: ~8 materialized (d_model)-wide tensors per layer
    act = n_layers * b_loc * s * cfg.d_model * dt * 8
    if shape.kind == "train":
        act *= 2.5                                 # bwd re-reads + dgrads
    logits = b_loc * s * (cfg.vocab_size / max(1, m.model)) * (dt + 4)
    if shape.kind == "train":
        logits *= 2
    return weights + act + logits


# ---------------------------------------------------------------------------
# Analytical per-device memory estimate (the "fits in HBM" criterion)
# ---------------------------------------------------------------------------


def activation_estimate(cfg: ModelConfig, shape: InputShape,
                        m: MeshInfo) -> dict:
    """Peak activation bytes/device with remat: saved layer carries + one
    layer's working set + the logits block. Coarse but liveness-aware
    (the counted temporaries are not)."""
    n_layers = max(1, sum(s.num_layers for s in cfg.segments))
    dt = _itemsize(cfg.dtype)
    if shape.kind == "decode":
        b_loc = max(1, shape.global_batch // m.data)
        kv_loc = shape.seq_len // max(
            1, (m.data * m.model if shape.global_batch < m.data else m.model))
        kv_layers = sum(1 for sp in cfg.layer_specs() if sp.mixer == "attn")
        cache = kv_layers * 2 * b_loc * kv_loc * cfg.num_kv_heads * \
            cfg.head_dim * dt
        return {"cache_bytes": cache, "working_set": b_loc * cfg.d_model * dt
                * 8, "carries": 0, "logits": b_loc * cfg.vocab_size // max(
                    1, m.model) * 4}
    b_loc = max(1, shape.global_batch // (m.data *
                                          m.axes.get("pod", 1)))
    s = shape.seq_len
    carry = n_layers * b_loc * s * cfg.d_model * dt
    # one layer working set: qkv + attention chunk scores + mlp hidden
    h_loc = max(1, cfg.num_heads // m.model)
    chunk = min(s, 1024)
    scores = b_loc * h_loc * s * chunk * 4
    acc = b_loc * h_loc * s * cfg.head_dim * 4
    mlp = b_loc * s * max(1, cfg.d_ff // m.model) * dt * 2
    logits = b_loc * s * max(1, cfg.vocab_size // m.model) * (dt + 4)
    mult = 3 if shape.kind == "train" else 1     # grads of working set
    return {"carries": carry, "working_set": (scores + acc + mlp) * mult,
            "logits": logits * (2 if shape.kind == "train" else 1),
            "total": carry + (scores + acc + mlp) * mult + logits}
