"""The port's shapes, abstract specs and cost model (``configs/shapes.py``,
``launch/specs.py``, ``launch/cost_model.py``, ``launch/dryrun.py``'s
``model_flops``) against the JAX package's, and the counts of
``launch/hlo_analysis.CostMode`` on fake meshes.

Held: ``SHAPES`` and ``applicable`` equal for every arch x shape;
``model_flops``, ``analytic_hbm_bytes`` and ``activation_estimate`` equal
to the float for every arch x shape x production mesh (the reference's
``MeshInfo`` on a stand-in mesh of the production shape); the
``abstract_*`` and ``input_specs`` trees' global shapes and dtypes
equal to the reference's ``jax.eval_shape`` on ``make_local_mesh(1, 1)``
for every arch at full size (each arch's own optimizer, plus Adam and
Adafactor slots; bf16 and int8 caches); on reduced qwen2-1.5b with a
segment of 3 repeats, the whole program's counted FLOPs equal
``corrected_cost``'s (main program at one repeat + 2 x the body); a
data-only (4, 1) fake mesh counts the same global FLOPs as (1, 1); an
FSDP train step on a fake (2, 2) mesh records collectives and (1, 1)
none; the five LM kernels' fake outputs have their plain versions'
shapes and dtypes, and their sharding rules give the expected
placements on fake ``DTensor``s.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.models import sharding as jax_sh
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, applicable,
                                 get_config, reduced)
from repro_torch.core.tree import flatten_with_paths
from repro_torch.launch import cost_model, dryrun
from repro_torch.models import sharding as sh

PROD = {"pod1": ((16, 16), ("data", "model")),
        "pod2": ((2, 16, 16), ("pod", "data", "model"))}


class _JaxMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.fixture(scope="module")
def jax_dryrun():
    """The reference's dry-run module; it sets ``XLA_FLAGS`` at import,
    which is put back as it was."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_applicable_match_reference(arch):
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JAX_SHAPES[name])
        assert applicable(get_config(arch), s) == \
            jax_applicable(jax_get_config(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_match_reference(jax_dryrun, arch, mesh):
    from repro.launch import cost_model as jax_cm
    shape, names = PROD[mesh]
    ref_m = jax_sh.MeshInfo(_JaxMesh(shape, names))
    port_m = sh.MeshInfo(dict(zip(names, shape)))
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        s, js = SHAPES[name], JAX_SHAPES[name]
        assert dryrun.model_flops(cfg, s) == jax_dryrun.model_flops(jcfg, js)
        assert cost_model.analytic_hbm_bytes(cfg, s, port_m, 0) == \
            jax_cm.analytic_hbm_bytes(jcfg, js, ref_m, 0)
        assert cost_model.activation_estimate(cfg, s, port_m) == \
            jax_cm.activation_estimate(jcfg, js, ref_m)


# ---------------------------------------------------------------------------
# abstract trees against jax.eval_shape
# ---------------------------------------------------------------------------


@pytest.fixture
def local_infos():
    """The reference's and the port's ``MeshInfo`` on
    ``make_local_mesh(1, 1)`` (the port's over a world-size-1 gloo group,
    destroyed after the test)."""
    import torch.distributed as dist
    from repro.launch.mesh import make_local_mesh as jax_local
    from repro_torch.launch.mesh import make_local_mesh
    port = sh.MeshInfo(make_local_mesh(1, 1, device_type="cpu"))
    try:
        yield jax_sh.MeshInfo(jax_local(1, 1)), port
    finally:
        dist.destroy_process_group()


def _walk(tree, prefix=""):
    """``{path: (shape, dtype name)}`` of a nested dict/list/tuple tree
    of ``ShapeDtypeStruct``s or tensors."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        dt = str(tree.dtype).replace("torch.", "")
        return {prefix: (tuple(tree.shape), dt)}
    out = {}
    for k, v in items:
        out.update(_walk(v, f"{prefix}/{k}"))
    return out


def _same_tree(ref, port):
    r, p = _walk(ref), _walk(port)
    assert r.keys() == p.keys()
    for k in r:
        assert p[k] == r[k], (k, p[k], r[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_eval_shape(local_infos, arch):
    from repro.launch import specs as jax_specs
    from repro.optim import get_optimizer as jax_opt
    from repro_torch.launch import specs
    from repro_torch.optim import get_optimizer
    ref_m, port_m = local_infos
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    _same_tree(jax_specs.abstract_params(jcfg, ref_m),
               specs.abstract_params(cfg, port_m))
    opts = {cfg.optimizer, "adam", "adafactor"}
    for name in sorted(opts):
        ref = jax_specs.abstract_train_state(jcfg, ref_m, jax_opt(name))
        port = specs.abstract_train_state(cfg, port_m, get_optimizer(name))
        _same_tree((ref.params, ref.slots), (port.params, port.slots))
        assert ref.step.shape == () and port.step == 0
    for name in SHAPES:
        s, js = SHAPES[name], JAX_SHAPES[name]
        if not applicable(cfg, s)[0]:
            continue
        for kv_quant in (False, True):
            _same_tree(jax_specs.input_specs(jcfg, js, ref_m, kv_quant),
                       specs.input_specs(cfg, s, port_m, kv_quant))


# ---------------------------------------------------------------------------
# counting on fake meshes (reduced configs, small shapes)
# ---------------------------------------------------------------------------

TRAIN = InputShape("train_small", 64, 8, "train")
PREFILL = InputShape("prefill_small", 128, 8, "prefill")


def _lowered(cfg, shape, mesh_shape, **kw):
    lowered, _, _, m = dryrun.lower_pair(
        cfg.name, shape.name, device_type="cpu", cfg=cfg,
        mesh_shape=mesh_shape, shape=shape, **kw)
    return lowered, m


def _qwen(layers=1, **changes):
    cfg = reduced(get_config("qwen2-1.5b"), layers_per_segment=layers)
    return dataclasses.replace(cfg, **changes)


@pytest.mark.parametrize("shape", [TRAIN, PREFILL], ids=lambda s: s.kind)
def test_corrected_cost_matches_whole_program(shape):
    """Three repeats counted whole equal one repeat + 2 x the body."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import fake_process_group
    cfg = _qwen(layers=3)
    assert cfg.segments[0].repeats == 3
    lowered, _ = _lowered(cfg, shape, (2, 2))
    assert lowered.detail["segments"][0]["repeats"] == 3
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        mode = cost_model.count_step(cfg, shape, sh.MeshInfo(mesh),
                                     fake_mode=FakeTensorMode())[0]
    assert mode.flops > 0
    assert lowered.cost.flops_per_device == mode.flops


@pytest.mark.parametrize("shape", [TRAIN, PREFILL], ids=lambda s: s.kind)
def test_data_mesh_counts_same_global_flops(shape):
    cfg = _qwen()
    one, m1 = _lowered(cfg, shape, (1, 1))
    four, m4 = _lowered(cfg, shape, (4, 1))
    assert one.cost.flops_per_device * m1.size == \
        four.cost.flops_per_device * m4.size


def test_fsdp_train_records_collectives_only_across_devices():
    cfg = _qwen()
    sharded, _ = _lowered(cfg, TRAIN, (2, 2))
    single, _ = _lowered(cfg, TRAIN, (1, 1))
    counts = sharded.collectives.counts
    assert counts.get("all-gather", 0) > 0
    assert counts.get("reduce-scatter", 0) + counts.get("all-reduce", 0) > 0
    assert sharded.collectives.total_operand_bytes > 0
    assert single.collectives.counts == {}
    assert single.cost.collective_operand_bytes_per_device == 0


def test_kernel_fake_outputs_match_plain_versions():
    """Each LM kernel's custom op on fake tensors against its plain
    version (the wrapper on CPU tensors): shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)

    def t(*shape, dtype=np.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype))

    q, k = t(2, 4, 16, 64), t(2, 2, 16, 64)
    qd, kd = t(2, 4, 64), t(2, 16, 2, 64)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    table = t(100, 8)
    ids = torch.from_numpy(rng.integers(0, 100, 12).astype(np.int32))
    upd = t(12, 8)
    codes = torch.from_numpy(rng.integers(-127, 128, (6, 8)).astype(np.int8))
    scale = t(6, 1)
    cases = {
        "flash_attention": (ops.flash_attention, (q, k, k)),
        "decode_attention": (ops.decode_attention, (qd, kd, kd, lengths)),
        "embedding_lookup": (ops.embedding_lookup, (table, ids)),
        "embedding_scatter_add": (ops.embedding_scatter_add,
                                  (table.clone(), ids, upd)),
        "dequantize_rows": (ops.dequantize_rows, (codes, scale)),
    }
    for name, (fn, args) in cases.items():
        plain = fn(*args)
        fm = FakeTensorMode()
        fake_args = [fm.from_tensor(a) for a in args]
        with fm:
            fake = fn(*fake_args)
        assert fake.shape == plain.shape and fake.dtype == plain.dtype, name
        assert ops.launch_counts()[name] == 0


def test_kernel_sharding_rules_on_dtensors():
    """Each LM kernel wrapper on fake ``DTensor``s on a (2, 2) mesh: the
    output's global shape and dtype are the plain call's, its placements
    the rule's (batch splits kept, a head_dim split gathered, a
    vocab-split table's gather ``Partial``, the scatter-add into a
    ``Partial`` table taking the token split), and the op runs once on
    the local shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import CostMode
    from repro_torch.launch.mesh import fake_process_group
    from repro_torch.launch.specs import abstract_leaf
    P = sh.P
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        m = sh.MeshInfo(mesh)
        fm = FakeTensorMode()

        def leaf(shape, spec, dtype=torch.float32):
            return abstract_leaf(shape, dtype, spec, m, fm)

        R = Replicate()
        cases = [
            ("flash_attention", lambda: ops.flash_attention(
                leaf((4, 8, 16, 64), P("data", None, None, "model")),
                leaf((4, 2, 16, 64), P("data", None, None, None)),
                leaf((4, 2, 16, 64), P("data", None, None, None))),
             (4, 8, 16, 64), (Shard(0), Shard(0))),
            ("decode_attention", lambda: ops.decode_attention(
                leaf((4, 8, 64), P("data", "model", None)),
                leaf((4, 32, 2, 64), P("data", "model", None, None)),
                leaf((4, 32, 2, 64), P("data", "model", None, None)),
                leaf((4,), P("data"), torch.int32)),
             (4, 8, 64), (Shard(0), Shard(0))),
            ("embedding_lookup", lambda: ops.embedding_lookup(
                leaf((64, 8), P("model", "data")),
                leaf((12,), P("data"), torch.int32)),
             (12, 8), (Shard(1), Partial())),
            ("dequantize_rows", lambda: ops.dequantize_rows(
                leaf((12, 8), P("data", None), torch.int8),
                leaf((12, 1), P(None, None))),
             (12, 8), (Shard(0), R)),
        ]
        for name, call, shape, placements in cases:
            with fm, CostMode() as mode:
                out = call()
            assert tuple(out.shape) == shape, name
            assert tuple(out.placements) == placements, name
            assert mode.op_counts[f"repro_torch.{name}"] == 1, name
        from torch.distributed.tensor import DTensor
        with fm:
            zeros = DTensor.from_local(
                torch.zeros(64, 8), mesh, (Partial(), R), run_check=False)
        with fm, CostMode() as mode:
            ops.embedding_scatter_add(
                zeros, leaf((12,), P("data"), torch.int32),
                leaf((12, 8), P("data", None)))
        assert zeros.placements == (Partial(), R)
        assert mode.op_counts["repro_torch.embedding_scatter_add"] == 1
        assert mode.collectives.counts == {}
