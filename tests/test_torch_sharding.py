"""The port's sharding policy (``models/sharding.py``) against the JAX
package's, and the DTensor placements its specs stand for.

Held: ``param_pspecs``, ``cache_pspecs`` and ``batch_pspecs`` equal to the
reference's entry for entry (``tuple(spec)``), for every id of
``ARCH_IDS`` at full size, on meshes (1, 1), (4, 2), (16, 16) and (2, 16,
16), under the four layouts (FSDP, embed-TP, serve-TP, serve-tp2d),
cache batches 1, 32 and 128 with and without the int8 cache, and the
three batch kinds. The reference's ``MeshInfo`` reads only the mesh's
``axis_names`` and ``devices.shape``, so a stand-in with ``devices =
np.empty(shape)`` gives it a 256-device mesh without touching the JAX
package. Then, on a fake (4, 2) process group: every spec kind's
``placements`` (a tuple entry in the mesh's order two ``Shard``s, the
tp2d embedding's ``(model, data)`` a ``_StridedShard`` + ``Shard``),
each param leaf's local shard shape the ceil-division the spec implies,
the ``(model, data)`` split model-major by its global offsets, and
``logical_axis_constraint`` the identity on plain tensors.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import sharding as jax_sh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.tree import flatten_with_paths
from repro_torch.models import sharding as sh

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = {"fsdp": dict(),
           "embed-tp": dict(embed_mode="tp"),
           "serve-tp": dict(fsdp=False, serve_layout="tp"),
           "serve-tp2d": dict(fsdp=False, serve_layout="tp2d")}
CACHE_BATCHES = (1, 32, 128)


class _JaxMesh:
    """What the reference's ``MeshInfo`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _infos(mesh, layout):
    shape, names = MESHES[mesh]
    ref = jax_sh.MeshInfo(_JaxMesh(shape, names),
                          jax_sh.ShardingOptions(**LAYOUTS[layout]))
    port = sh.MeshInfo(dict(zip(names, shape)),
                       sh.ShardingOptions(**LAYOUTS[layout]))
    return ref, port


def _flat(tree, is_jax):
    """``{path: tuple(spec)}`` of a spec tree."""
    if is_jax:
        import jax
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves[0]}
    import jax
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                _as_lists(tree), is_leaf=lambda x: isinstance(x, sh.P))[0]}


def _as_lists(tree):
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_lists(v) for v in tree]
    return tree


def _same(ref_tree, port_tree):
    ref, port = _flat(ref_tree, True), _flat(port_tree, False)
    assert ref.keys() == port.keys()
    for k in ref:
        assert port[k] == ref[k], (k, port[k], ref[k])
    for _, spec in flatten_with_paths(port_tree):
        assert isinstance(spec, sh.P)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, mesh, layout):
    ref_m, port_m = _infos(mesh, layout)
    _same(jax_sh.param_pspecs(jax_get_config(arch), ref_m),
          sh.param_pspecs(get_config(arch), port_m))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch, mesh, kv_quant):
    ref_m, port_m = _infos(mesh, "fsdp")
    for batch in CACHE_BATCHES:
        _same(jax_sh.cache_pspecs(jax_get_config(arch), ref_m, batch,
                                  kv_quant),
              sh.cache_pspecs(get_config(arch), port_m, batch, kv_quant))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_pspecs_match_reference(arch, mesh):
    ref_m, port_m = _infos(mesh, "fsdp")
    for kind in ("train", "prefill", "decode"):
        for batch in CACHE_BATCHES + (256,):
            ref = jax_sh.batch_pspecs(jax_get_config(arch), ref_m, kind, batch)
            port = sh.batch_pspecs(get_config(arch), port_m, kind, batch)
            assert {k: tuple(v) for k, v in port.items()} == \
                {k: tuple(v) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# DTensor placements on a fake (4, 2) group
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh42():
    """A (4, 2) ``("data", "model")`` CPU mesh over a fake 8-rank group,
    destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import fake_process_group
    with fake_process_group(8):
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))


def test_placements_of_every_spec_kind(mesh42):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    R = Replicate()
    cases = {
        sh.P(): (R, R),
        sh.P(None, None): (R, R),
        sh.P("data", None): (Shard(0), R),
        sh.P(None, "model"): (R, Shard(1)),
        sh.P("model", "data"): (Shard(1), Shard(0)),
        sh.P(None, None, ("data", "model"), None, None):
            (Shard(2), Shard(2)),
        sh.P(("pod", "data"), None)[1:]: (R, R),
        sh.P(("model", "data"), None):
            (_StridedShard(0, split_factor=2), Shard(0)),
    }
    for spec, want in cases.items():
        assert sh.placements(spec, mesh42) == want, spec
    with pytest.raises(ValueError):
        sh.placements(sh.P("pod", None), mesh42)
    with pytest.raises(ValueError):
        sh.placements(sh.P("data", "data"), mesh42)


def test_model_major_split_is_model_major(mesh42):
    """``(model, data)``: chunk ``m * 4 + d`` on device (d, m); ``(data,
    model)``: chunk ``d * 2 + m``."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as extent
    tp2d = sh.placements(sh.P(("model", "data"), None), mesh42)
    wide = sh.placements(sh.P(None, ("data", "model")), mesh42)
    for d in range(4):
        for m in range(2):
            shape, off = extent((64, 8), (4, 2), [d, m], tp2d)
            assert shape == (8, 8) and off == ((m * 4 + d) * 8, 0)
            shape, off = extent((8, 64), (4, 2), [d, m], wide)
            assert shape == (8, 8) and off == (0, (d * 2 + m) * 8)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_leaves_local_shapes(mesh42, arch, layout):
    """Every param leaf as a ``DTensor`` of its global shape whose local
    shard is the ceil-division its spec implies."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.specs import _param_shapes, abstract_leaf
    cfg = get_config(arch)
    m = sh.MeshInfo(mesh42, sh.ShardingOptions(**LAYOUTS[layout]))
    shapes = dict(flatten_with_paths(_param_shapes(cfg)))
    specs = dict(flatten_with_paths(sh.param_pspecs(cfg, m)))
    assert shapes.keys() == specs.keys()
    fm = FakeTensorMode()
    for path, t in shapes.items():
        leaf = abstract_leaf(t.shape, t.dtype, specs[path], m, fm)
        want = tuple(t.shape)
        for dim, entry in enumerate(specs[path]):
            for ax in (entry if isinstance(entry, tuple) else
                       () if entry is None else (entry,)):
                want = want[:dim] + (-(-want[dim] // m.axes[ax]),) \
                    + want[dim + 1:]
        assert tuple(leaf.shape) == tuple(t.shape), path
        assert tuple(leaf.to_local().shape) == want, path
        assert leaf.dtype == t.dtype


def test_logical_axis_constraint_identity_off_mesh():
    x = torch.ones(4, 3)
    assert sh.logical_axis_constraint(x, None, sh.P("data", None)) is x
    m = sh.MeshInfo({"data": 4, "model": 2})
    assert sh.logical_axis_constraint(x, m, sh.P("data", None)) is x


def test_logical_axis_constraint_redistributes(mesh42):
    from torch.distributed.tensor import Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import CostMode
    from repro_torch.launch.specs import abstract_leaf
    m = sh.MeshInfo(mesh42)
    fm = FakeTensorMode()
    x = abstract_leaf((16, 8), torch.float32, sh.P(None, "model"), m, fm)
    with fm, CostMode() as mode:
        y = sh.logical_axis_constraint(x, m, sh.P("data", None))
        z = sh.logical_axis_constraint(y, m, sh.P(sh.UNCONSTRAINED, None))
    assert y.placements == (Shard(0), Replicate())
    assert z is y
    assert mode.collectives.counts == {"all-gather": 1}
