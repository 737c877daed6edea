"""The port's int8 delta codec and transforms against the JAX package's,
on the CPU.

``quantize_rows``/``dequantize_rows`` (the plain versions the port's
wrappers run on CPU tensors) must be bit-equal to the reference's Pallas
kernels in interpret mode and to its NumPy codec
(``Int8Transform._quantize_np``): codes, scales and decoded rows. The
cases include all-zero rows (scale 1e-12, codes 0), exact half-way
quotients (round half to even) and rows whose extremes land on ±127.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transform import Int8Transform as RefInt8
from repro.core.transform import make_transform as ref_make_transform
from repro.kernels import ops as ref_ops
from repro.optim import FTRL as RefFTRL
from repro_torch.core import transform as port_tf
from repro_torch.kernels import ops as port_ops
from repro_torch.optim import FTRL


def _codec_rows(b, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, d))
         * 10.0 ** rng.uniform(-4, 4, size=(b, 1))).astype(np.float32)
    x[0] = 0.0                                     # all-zero row
    if b > 2 and d >= 8:
        # scale exactly 1: quotients x.5 round half to even; ±127 at the
        # extremes (a scale of 1/127 * 127 rounds to exactly 1.0f)
        x[1, :8] = [127.0, -127.0, 0.5, 1.5, -2.5, 63.5, -64.5, 3.0]
        x[2, :] = 0.0
        x[2, 0] = -127.0 * 3                       # -127 code, scale 3
    return x


@pytest.mark.parametrize("b,d", [(1, 1), (33, 8), (100, 9), (7, 128)])
def test_quantize_dequantize_match_reference(b, d):
    x = _codec_rows(b, d, b * 100 + d)
    q, s = port_ops.quantize_rows(torch.from_numpy(x))
    rq, rs = ref_ops.quantize_rows(jnp.asarray(x))
    host = RefInt8._quantize_np(x)
    for want_q, want_s in ((np.asarray(rq), np.asarray(rs)),
                           (host["q"], host["scale"])):
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)
    assert q.dtype == torch.int8 and s.shape == (b, 1)
    assert (q.numpy()[0] == 0).all() and s.numpy()[0, 0] == np.float32(1e-12)
    if b > 2 and d >= 8:
        np.testing.assert_array_equal(q.numpy()[1, :8],
                                      [127, -127, 0, 2, -2, 64, -64, 3])
        assert q.numpy()[2, 0] == -127
    assert q.numpy().min() >= -127 and q.numpy().max() <= 127
    back = port_ops.dequantize_rows(q, s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_ops.dequantize_rows(rq, rs)))
    np.testing.assert_array_equal(
        back.numpy(), RefInt8.decode({"q": host["q"],
                                      "scale": host["scale"]}))


@pytest.mark.parametrize("with_opt", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_int8_transform_matches_reference(backend, with_opt):
    """Port encode (both backends) equals the reference's numpy and pallas
    encodes; with FTRL attached the pusher's (n, 0) w placeholder still
    takes the kernel path (guard on rows, not w.size)."""
    rng = np.random.default_rng(5)
    if with_opt:
        w = np.empty((24, 0), np.float32)
        slots = {"z": (rng.normal(size=(24, 8)) * 3).astype(np.float32),
                 "n": (rng.uniform(size=(24, 8)) * 5).astype(np.float32)}
    else:
        w, slots = _codec_rows(24, 8, 6), {}
    port = port_tf.make_transform("int8", FTRL() if with_opt else None,
                                  backend=backend, device="cpu")
    assert port._device_path == (backend == "torch")
    before = port_ops.quantize_rows.launches
    enc = port.encode(w, slots)
    assert port_ops.quantize_rows.launches == before   # CPU: plain version
    for ref_backend in ("numpy", "pallas"):
        want = ref_make_transform("int8", RefFTRL() if with_opt else None,
                                  backend=ref_backend).encode(w, slots)
        for k in ("q", "scale"):
            np.testing.assert_array_equal(enc[k], want[k])
    for dec_backend in ("numpy", "torch"):
        np.testing.assert_array_equal(
            port_tf.Int8Transform.decode(enc, backend=dec_backend,
                                         device="cpu"),
            RefInt8.decode(enc, backend="pallas"))


def test_kernel_less_codecs_stay_on_numpy_engine():
    for codec in ("identity", "cast16"):
        t = port_tf.make_transform(codec, FTRL(), backend="torch",
                                   device="cpu")
        assert not t._device_path
    assert port_tf.make_transform("int8", FTRL(), backend="torch",
                                  device="cpu")._device_path
    with pytest.raises(ValueError):
        port_tf.make_transform("int8", backend="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_tf.make_transform("int8")          # default: the card


@pytest.mark.parametrize("codec", ["identity", "cast16", "int8"])
def test_blocked_encode_matches_reference(codec):
    """The NumPy engine's cache-blocked encode tiles give the reference's
    payload, and the single-block torch encode the same bits."""
    n = port_tf._ENCODE_BLOCK + 257
    rng = np.random.default_rng(11)
    w = np.zeros((n, 4), np.float32)
    slots = {"z": (rng.normal(size=(n, 4)) * 3).astype(np.float32),
             "n": (rng.uniform(size=(n, 4)) * 5).astype(np.float32)}
    want = ref_make_transform(codec, RefFTRL()).encode(w, slots)
    for backend in ("numpy", "torch"):
        got = port_tf.make_transform(codec, FTRL(), backend=backend,
                                     device="cpu").encode(w, slots)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_wrappers_reject_bad_inputs_and_empty_batches():
    q, s = port_ops.quantize_rows(torch.zeros((0, 8)))
    assert q.shape == (0, 8) and s.shape == (0, 1)
    assert port_ops.dequantize_rows(q, s).shape == (0, 8)
    with pytest.raises(ValueError):
        port_ops.dequantize_rows(torch.zeros((2, 8), dtype=torch.int8),
                                 torch.zeros((2, 1)).to("meta"))
