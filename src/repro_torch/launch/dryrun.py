"""Multi-pod dry-run: count every (architecture x input shape) step on the
production meshes, and record memory, cost and roofline terms — the
counterpart of the reference's ``launch/dryrun.py``. No device
allocation: inputs are ``DTensor``s over fake local shards.

Where the reference lowers and compiles a GSPMD program on 512 forced
host devices (setting ``XLA_FLAGS`` at import), ``lower_pair`` creates a
fake process group of the mesh's size (and destroys it on return;
nothing is set at import), builds the production ``DeviceMesh``, and
runs the port's own ``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` on fake tensors on the mesh's device type under
``hlo_analysis.CostMode`` — the main program on ``one_repeat(cfg)``,
then each segment's body (``cost_model.corrected_cost``). DTensor's
sharding propagation stands in for GSPMD: it redistributes where an op
needs it, and each collective it issues is counted.

The serve layout is picked by memory fit against the H100's 80 GB:
pure TP-16 when the weights / 16 fit 0.75 of it (60e9 bytes), else
tp2d. Results are one JSON per pair, with the reference's keys;
``compile_seconds`` is the time of the body counts (no compile here).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--opt] [--device cpu] \\
      [--out build/dryrun/baseline]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch.cost_model import (StepCost, activation_estimate,
                                           analytic_hbm_bytes, corrected_cost,
                                           cost_of, count, count_step,
                                           one_repeat, step_arguments)
from repro_torch.launch.hlo_analysis import (CollectiveStats,
                                             collectives_from_comm_mode)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, ICI_LINK_BW,
                                     PEAK_FLOPS_BF16, fake_process_group,
                                     make_production_mesh)
from repro_torch.models.sharding import MeshInfo, ShardingOptions

# weights / 16 must fit this for the pure TP-16 serve layout: 0.75 of HBM
SERVE_TP_BYTES = 0.75 * HBM_BYTES


@dataclass
class Lowered:
    """A counted pair: the main program's cost (``one_repeat``), the
    corrected cost and its detail, the main program's raw collectives,
    and the per-device bytes of the arguments, the outputs and the
    temporaries (no liveness reuse)."""
    main: StepCost
    cost: StepCost
    detail: dict
    collectives: CollectiveStats
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    op_counts: dict
    flops_by_op: dict
    lower_seconds: float
    compile_seconds: float


class SkipPair(Exception):
    pass


def local_bytes(tree) -> int:
    """Bytes of every tensor leaf's local shard."""
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def sharding_options(cfg, shape, opt: bool) -> ShardingOptions:
    """The layout: vocab-TP logits with ``opt``, weight-stationary serving
    for ``opt`` decode, its layout by memory fit (``SERVE_TP_BYTES``)."""
    tp_weight_bytes = cfg.param_counts()["total"] * 2 / 16
    return ShardingOptions(
        embed_mode="tp" if opt else "fsdp",
        fsdp=not (opt and shape.kind == "decode"),
        serve_layout="tp" if tp_weight_bytes <= SERVE_TP_BYTES else "tp2d",
    )


def opt_config(cfg, shape, m: MeshInfo):
    """The ``--opt`` config knobs: group-local MoE dispatch, context-
    parallel attention where heads do not divide ``model``, chunked
    loss."""
    changes = {}
    if cfg.num_experts and shape.kind == "train":
        changes["moe_dispatch_groups"] = m.data
    if shape.kind in ("train", "prefill") and \
            not m.div(cfg.num_heads, "model"):
        changes["context_parallel_attn"] = True
    if shape.kind == "train":
        changes["loss_chunk"] = 512
    return dataclasses.replace(cfg, **changes) if changes else cfg


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               opt: bool = False, device_type: str = "cuda", cfg=None,
               mesh_shape: Optional[tuple[int, int]] = None, shape=None):
    """Returns (Lowered, cfg, shape, mesh_info). ``opt`` enables the
    layout optimizations (vocab-TP logits, group-local MoE dispatch,
    context-parallel attention, chunked loss, the int8 decode cache).
    ``cfg`` replaces ``get_config(arch)`` (a reduced config in tests),
    ``mesh_shape`` a ``(data, model)`` mesh the production one, and
    ``shape`` (an ``InputShape``) ``SHAPES[shape_name]``. The mesh
    info's ``mesh`` is gone with the group on return."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise SkipPair(why)
    if mesh_shape is not None:
        size = mesh_shape[0] * mesh_shape[1]
    else:
        size = 512 if multi_pod else 256
    with fake_process_group(size):
        if mesh_shape is not None:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(device_type, tuple(mesh_shape),
                                    mesh_dim_names=("data", "model"))
        else:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device_type)
        m = MeshInfo(mesh, sharding_options(cfg, shape, opt))
        if opt:
            cfg = opt_config(cfg, shape, m)
        kv_quant = opt and shape.kind == "decode"
        fm = FakeTensorMode()
        full = step_arguments(cfg, shape, m, kv_quant, fm)
        mode, _, out = count_step(one_repeat(cfg), shape, m,
                                  kv_quant=kv_quant, fake_mode=fm)
        if shape.kind == "train":
            outputs = (full[0], out[1])           # the state, updated
        elif shape.kind == "prefill":
            outputs = out
        else:
            outputs = (out[0], full[1])           # logits, the cache
        t_lower = time.time()
        main = cost_of(mode)
        cost, detail = corrected_cost(main, cfg, m, shape, fake_mode=fm,
                                      kv_quant=kv_quant)
        lowered = Lowered(
            main=main, cost=cost, detail=detail,
            collectives=collectives_from_comm_mode(mode),
            argument_bytes=local_bytes(full), output_bytes=local_bytes(outputs),
            temp_bytes=mode.temp_bytes, op_counts=dict(mode.op_counts),
            flops_by_op=dict(mode.flops_by_op),
            lower_seconds=t_lower - t0, compile_seconds=time.time() - t_lower)
        m.mesh = None
    return lowered, cfg, shape, m


def local_pass(cfg, shape, *, device_type: str = "cuda", seed: int = 0,
               reps: int = 0) -> dict:
    """The dry-run's route on real tensors: the step for ``shape`` (train
    or prefill) counted on ``make_local_mesh(1, 1)`` twice — on real
    ``DTensor``s (params from ``seed``, tokens from it; the kernels run
    on the card, their plain versions on the CPU) and on the abstract
    arguments' fake ones. Returns ``{"real", "fake": StepCost,
    "real_mode", "fake_mode": CostMode, "p50_ms": the plain-tensor
    step's median over ``reps`` timed calls (None with 0), "out": the
    real step's output}``. The world-size-1 group is destroyed on
    return; raises ``RuntimeError`` if a group exists."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree import map_like
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import _slot_spec
    from repro_torch.models import init_params
    from repro_torch.models.common import mesh_scope
    from repro_torch.models.sharding import (batch_pspecs, param_pspecs,
                                             placements)
    from repro_torch.serving import make_prefill_step
    from repro_torch.training import init_train_state, make_train_step

    if dist.is_initialized():
        raise RuntimeError("a process group already exists")
    device = torch.device(device_type)
    gen = torch.Generator(device=device).manual_seed(seed)
    b, s = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)
    if shape.kind == "train":
        state = init_train_state(cfg, gen)
        step = make_train_step(cfg)
    elif shape.kind == "prefill":
        state = init_params(cfg, gen)
        step = make_prefill_step(cfg)
    else:
        raise ValueError(f"local_pass takes train or prefill, not "
                         f"{shape.kind!r}")
    batch = {"tokens": tokens}
    if cfg.has_encoder_context:
        batch["enc_context"] = torch.randn(
            (b, cfg.encoder_len, cfg.d_model), generator=gen, device=device,
            dtype=torch.bfloat16)
    out = {"p50_ms": None}
    if reps:
        times = []
        for _ in range(reps + 1):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.set_grad_enabled(shape.kind == "train"):
                step(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["p50_ms"] = sorted(times[1:])[len(times[1:]) // 2]
    mesh = make_local_mesh(1, 1, device_type=device_type)
    try:
        m = MeshInfo(mesh)

        def wrap(t, spec):
            return DTensor.from_local(t, mesh, placements(spec, mesh),
                                      run_check=False)

        specs = param_pspecs(cfg, m)
        if shape.kind == "train":
            state = state._replace(
                params=map_like(lambda sp, t: wrap(t, sp), specs,
                                state.params),
                slots=map_like(lambda sp, p, sl: {
                    k: wrap(v, _slot_spec(sp, p, v))
                    for k, v in sl.items()}, specs, state.params,
                    state.slots))
        else:
            state = map_like(lambda sp, t: wrap(t, sp), specs, state)
        bspecs = batch_pspecs(cfg, m, shape.kind, b)
        real_batch = {k: wrap(v, bspecs[k]) for k, v in batch.items()}
        with mesh_scope(m), torch.set_grad_enabled(shape.kind == "train"):
            out["out"], real_mode = count(step, state, real_batch)
        fake_mode = count_step(cfg, shape, m,
                               fake_mode=FakeTensorMode())[0]
    finally:
        dist.destroy_process_group()
    out.update(real=cost_of(real_mode), fake=cost_of(fake_mode),
               real_mode=real_mode, fake_mode=fake_mode)
    return out


def model_flops(cfg, shape) -> float:
    """MFU convention: 6·N_active·tokens (train), 2·N_active·tokens
    (inference); attention score FLOPs not counted."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch        # decode: 1 token/seq


def analyze(lowered: Lowered, cfg, shape, m) -> dict:
    n_dev = m.size
    cost, cost_detail = lowered.cost, lowered.detail
    flops_global = cost.flops_per_device * n_dev
    bytes_global = cost.bytes_per_device * n_dev
    coll_bytes_dev = cost.collective_operand_bytes_per_device

    compute_s = flops_global / (n_dev * PEAK_FLOPS_BF16)
    # memory term: analytic (fusion-aware) estimate; the op-by-op
    # no-fusion number is recorded alongside as an upper bound.
    bytes_est = analytic_hbm_bytes(cfg, shape, m, lowered.argument_bytes)
    memory_s = bytes_est / HBM_BW
    memory_s_xla = cost.bytes_per_device / HBM_BW
    collective_s = coll_bytes_dev / ICI_LINK_BW   # per-device link traffic

    mf = model_flops(cfg, shape)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return {
        "devices": n_dev,
        "compile_seconds": lowered.compile_seconds,
        "memory": {
            "argument_bytes_per_device": lowered.argument_bytes,
            "output_bytes_per_device": lowered.output_bytes,
            # every intermediate output, no liveness reuse: an upper
            # bound, NOT a peak (see cost_model)
            "temp_bytes_upper_bound": lowered.temp_bytes,
            "activation_estimate": activation_estimate(cfg, shape, m),
        },
        "cost": {
            "flops_per_device": cost.flops_per_device,
            "flops_global": flops_global,
            "bytes_per_device": cost.bytes_per_device,
            "bytes_global": bytes_global,
            "scan_correction": cost_detail,
        },
        "collectives": {
            **lowered.collectives.as_dict(),
            "scan_corrected_operand_bytes": coll_bytes_dev,
            "scan_corrected_counts": cost.collective_counts,
        },
        "roofline": {
            **terms,
            "memory_s_xla_upper_bound": memory_s_xla,
            "hbm_bytes_est_per_device": bytes_est,
            "dominant": dominant,
            "model_flops": mf,
            "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        },
    }


def run_pair(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: Optional[str], verbose: bool = True, opt: bool = False,
             device_type: str = "cuda", cfg=None,
             mesh_shape: Optional[tuple[int, int]] = None,
             shape=None) -> dict:
    mesh_tag = "pod2" if multi_pod else "pod1"
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    try:
        lowered, cfg, shape, m = lower_pair(
            arch, shape_name, multi_pod=multi_pod, opt=opt,
            device_type=device_type, cfg=cfg, mesh_shape=mesh_shape,
            shape=shape)
        result = analyze(lowered, cfg, shape, m)
        result.update({"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                       "status": "ok",
                       "lower_seconds": lowered.lower_seconds})
        if verbose:
            print(f"== {tag} ==")
            print({k: result["memory"][k] for k in (
                "argument_bytes_per_device", "output_bytes_per_device",
                "temp_bytes_upper_bound")})
            print({"flops": lowered.main.flops_per_device,
                   "bytes accessed": lowered.main.bytes_per_device})
    except SkipPair as e:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "status": "skip", "reason": str(e)}
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(result, f, indent=2, default=str)
    status = result["status"]
    extra = ""
    if status == "ok":
        r = result["roofline"]
        extra = (f" dominant={r['dominant']} compute={r['compute_s']:.4f}s"
                 f" memory={r['memory_s']:.4f}s"
                 f" collective={r['collective_s']:.4f}s"
                 f" useful={r['useful_flops_ratio']:.2f}")
    elif status == "error":
        extra = " " + result["error"][:200]
    elif status == "skip":
        extra = " " + result["reason"][:80]
    print(f"[{status}] {tag}{extra}", flush=True)
    return result


def summary(dirs: list[str]) -> str:
    """A markdown table of the pair JSONs under ``dirs`` (one directory a
    sweep, one column each): a row an (arch, shape), a cell ``dominant
    compute / memory / collective seconds, useful-FLOPs ratio`` of an
    ``ok`` pair (the terms to 4 significant digits), the status of
    another."""
    cells: dict = {}
    for d in dirs:
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(d, name)) as f:
                r = json.load(f)
            key = (r["arch"], r["shape"])
            if r["status"] != "ok":
                cells.setdefault(key, {})[d] = r["status"]
                continue
            t = r["roofline"]
            cells.setdefault(key, {})[d] = (
                f"{t['dominant'][:-2]} {t['compute_s']:.4g} / "
                f"{t['memory_s']:.4g} / {t['collective_s']:.4g}, "
                f"{t['useful_flops_ratio']:.3g}")
    names = [os.path.basename(os.path.normpath(d)) for d in dirs]
    rows = ["| arch | shape | " + " | ".join(names) + " |",
            "|---|---|" + "---|" * len(dirs)]
    for (arch, shape), by_dir in sorted(cells.items()):
        if all(v == "skip" for v in by_dir.values()):
            continue
        rows.append(f"| {arch} | {shape} | "
                    + " | ".join(by_dir.get(d, "") for d in dirs) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on this mesh")
    ap.add_argument("--opt", action="store_true",
                    help="layout optimizations (vocab-TP logits, MoE "
                         "dispatch groups, context-parallel attention, "
                         "chunked loss, int8 decode cache)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' and the mesh's device type")
    ap.add_argument("--out", default="build/dryrun/baseline")
    ap.add_argument("--summary", nargs="+", metavar="DIR",
                    help="print a markdown table of the JSONs in these "
                         "directories and exit")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.summary))
        return

    if args.all:
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                run_pair(arch, shape_name, multi_pod=args.multi_pod,
                         out_dir=args.out, opt=args.opt,
                         device_type=args.device)
        return
    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    run_pair(args.arch, args.shape, multi_pod=args.multi_pod,
             out_dir=args.out, opt=args.opt, device_type=args.device)


if __name__ == "__main__":
    main()
