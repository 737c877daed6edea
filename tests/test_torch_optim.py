"""The port's FTRL against the JAX package's, on the CPU.

The NumPy route and the ``ftrl_row_update`` plain version (what the
port's wrapper runs on CPU tensors) must be bit-equal to the reference's
``FTRL.update_rows(backend="numpy")``: the same op order in float32, the
hyper-parameters rounded to float32 once, IEEE divides and square roots.
Against the reference's Pallas kernel in interpret mode they agree within
``rtol=1e-5, atol=1e-6`` (XLA may fuse its arithmetic differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.optim import get_optimizer as ref_get_optimizer
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.optim import FTRL, get_optimizer

PARAMS = [dict(alpha=0.05, beta=1.0, l1=1.0, l2=1.0),
          dict(alpha=0.1, beta=0.5, l1=0.0, l2=0.1)]


def _rows(b, d, seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(b, d)) * 2).astype(np.float32)
    n = (rng.uniform(size=(b, d)) * 4).astype(np.float32)
    g = rng.normal(size=(b, d)).astype(np.float32)
    return z, n, g


@pytest.mark.parametrize("b", [1, 300])
@pytest.mark.parametrize("d", [1, 8, 128])
@pytest.mark.parametrize("params", PARAMS)
def test_ftrl_rows_match_reference(b, d, params):
    z, n, g = _rows(b, d, b * 1000 + d)
    want_w, want = ref_get_optimizer("ftrl", **params).update_rows(
        np.zeros((b, d), np.float32), {"z": z, "n": n}, g, 0,
        backend="numpy")
    port = get_optimizer("ftrl", **params)
    routes = {
        "numpy": port.update_rows(None, {"z": z, "n": n}, g, 0,
                                  backend="numpy"),
        "torch": port.update_rows(None, {"z": z, "n": n}, g, 0,
                                  backend="torch", device="cpu")}
    z2, n2, w2 = port_ops.ftrl_row_update(
        *(torch.from_numpy(a) for a in (z, n, g)), **params)
    routes["plain"] = (w2.numpy(), {"z": z2.numpy(), "n": n2.numpy()})
    for name, (w, slots) in routes.items():
        np.testing.assert_array_equal(w, want_w, err_msg=name)
        for k in ("z", "n"):
            np.testing.assert_array_equal(slots[k], want[k], err_msg=name)
    pz, pn, pw = ref_ops.ftrl_row_update(
        jnp.asarray(z), jnp.asarray(n), jnp.asarray(g), **params)
    for got, pallas in ((z2, pz), (n2, pn), (w2, pw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-5, atol=1e-6)


def test_sqrt_rn_is_ieee():
    """The plain versions' square root equals NumPy's float32 sqrt bit for
    bit, across magnitudes and at 0, the smallest subnormal and inf."""
    rng = np.random.default_rng(4)
    x = (rng.uniform(size=4096) * 10.0 ** rng.uniform(-40, 38, size=4096)
         ).astype(np.float32)
    x[:4] = [0.0, 1e-45, np.inf, 3e38]
    np.testing.assert_array_equal(port_ref.sqrt_rn(torch.from_numpy(x)),
                                  np.sqrt(x))


def test_serve_weights_and_update_match_reference():
    """``serve_weights_np`` is the reference's NumPy code; ``update`` on
    tensors (the dense-bank path) matches the reference's jnp ``update``
    within tolerance."""
    z, n, g = _rows(64, 8, 1)
    ref_opt = ref_get_optimizer("ftrl", alpha=0.1, l1=0.5)
    port = get_optimizer("ftrl", alpha=0.1, l1=0.5)
    w0 = np.zeros((64, 8), np.float32)
    np.testing.assert_array_equal(
        port.serve_weights_np(w0, {"z": z, "n": n}),
        ref_opt.serve_weights_np(w0, {"z": z, "n": n}))
    want_w, want = ref_opt.update(jnp.asarray(w0),
                                  {"z": jnp.asarray(z), "n": jnp.asarray(n)},
                                  jnp.asarray(g), 0)
    got_w, got = port.update(torch.from_numpy(w0),
                             {"z": torch.from_numpy(z),
                              "n": torch.from_numpy(n)},
                             torch.from_numpy(g), 0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-6)
    for k in ("z", "n"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        port.serve_weights(torch.from_numpy(w0), got).numpy(),
        np.asarray(ref_opt.serve_weights(jnp.asarray(w0), want)),
        rtol=1e-5, atol=1e-6)


def test_slots_and_registry():
    opt = FTRL()
    assert opt.serve_slot_names == ("z", "n")
    np_slots = opt.init_slots(np.zeros((3, 2), np.float32))
    assert sorted(np_slots) == ["n", "z"]
    assert all(isinstance(v, np.ndarray) and not v.any()
               for v in np_slots.values())
    t_slots = opt.init_slots(torch.zeros(3, 2))
    assert all(isinstance(v, torch.Tensor) and v.shape == (3, 2)
               for v in t_slots.values())
    assert get_optimizer("ftrl", alpha=0.2).alpha == 0.2
    assert get_optimizer("adam", lr=0.01).name == "adam"
    assert get_optimizer("sgd").name == "sgd"
    for name in ("momentum", "adagrad", "adafactor"):
        with pytest.raises(KeyError, match="not ported"):
            get_optimizer(name)
    with pytest.raises(KeyError, match="unknown"):
        get_optimizer("lamb")
    with pytest.raises(ValueError):
        opt.update_rows(None, np_slots, np.zeros((3, 2), np.float32), 0,
                        backend="pallas")


def test_empty_batch():
    z = torch.zeros((0, 8))
    for t in port_ops.ftrl_row_update(z, z, z):
        assert t.shape == (0, 8)
    w, slots = FTRL().update_rows(None, {"z": np.zeros((0, 8), np.float32),
                                         "n": np.zeros((0, 8), np.float32)},
                                  np.zeros((0, 8), np.float32), 0,
                                  backend="torch", device="cpu")
    assert w.shape == (0, 8) and slots["z"].shape == (0, 8)
