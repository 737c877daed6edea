"""The int8 codec's plan by row width (``codec_plan``) and the rows that
test its arithmetic, against the JAX package, on the CPU.

The CUDA kernels cover rows by ``codec_plan``: a thread, a warp or a
block a row, or one row split into tiles over the whole card, whose
absmax is the maximum of per-tile maxima of the uint32 bits of ``|x|``.
Here: the plan's regime and word at each width class; the port's plain
version (what the wrappers run on CPU tensors) on rows of zeros, NaN and
±Inf and on one wide row, equal to the reference's Pallas kernel in
interpret mode and to its NumPy codec; and a NumPy emulation of the split
row's absmax equal to the plain version's scale, NaN included.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.transform import Int8Transform as RefInt8
from repro.kernels import delta_codec as ref_dc
from repro_torch.kernels import delta_codec as port_dc
from repro_torch.kernels import ref as port_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


@pytest.mark.parametrize("d,f32_ptr,code_ptr,regime,word", [
    (1, 0, 0, "narrow", 4), (8, 0, 0, "narrow", 16), (9, 0, 0, "narrow", 4),
    (16, 0, 0, "narrow", 16), (17, 0, 0, "warp", 4),
    (1536, 0, 0, "warp", 16), (2048, 0, 0, "warp", 16),
    (2049, 0, 0, "block", 4), (16384, 0, 0, "block", 16),
    (16385, 0, 0, "split", 4), (2 ** 20 + 3, 0, 0, "split", 4),
    (28 * 1536 * 8960, 0, 0, "split", 16),
    # misaligned: a float side 4 bytes off, a code side 8 or 4 bytes off
    (8, 4, 0, "narrow", 4), (1536, 0, 8, "warp", 4),
    (1536, 16, 4, "warp", 4), (16384, 32, 48, "block", 16)])
def test_codec_plan_regime_and_word(d, f32_ptr, code_ptr, regime, word):
    plan = port_dc.codec_plan(d, f32_ptr, code_ptr)
    assert plan == (regime, word)
    assert plan.quantize_launches == (2 if regime == "split" else 1)


@pytest.mark.parametrize("d", [0, 2 ** 31])
def test_codec_plan_refuses_rows_it_cannot_index(d):
    with pytest.raises(ValueError):
        port_dc.codec_plan(d)


def _same(a: np.ndarray, b: np.ndarray) -> None:
    """Bit-equal, NaNs in the same places standing for equal."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.where(np.isnan(a), 0, a),
                                  np.where(np.isnan(b), 0, b))


def _check_against_reference(x: np.ndarray):
    q, s = port_ref.quantize_rows(torch.from_numpy(x))
    rq, rs = ref_dc.quantize_rows(jnp.asarray(x), interpret=True)
    host = RefInt8._quantize_np(x)
    for want_q, want_s in ((np.asarray(rq), np.asarray(rs)),
                           (host["q"], host["scale"])):
        np.testing.assert_array_equal(q.numpy(), want_q)
        _same(s.numpy(), want_s)
    back = port_ref.dequantize_rows(q, s).numpy()
    _same(back, np.asarray(ref_dc.dequantize_rows(rq, rs, interpret=True)))
    _same(back, RefInt8.decode({"q": host["q"], "scale": host["scale"]}))
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("d", [1, 8, 9, 1536])
def test_nan_inf_zero_rows_match_reference(d):
    """Rows of zeros, a NaN, +Inf, -Inf, and NaN with both infinities:
    scale 1e-12, NaN, inf, inf, NaN and codes 0, in the port's plain
    version as in the reference's kernel and NumPy codec."""
    x = smoke.codec_rows(12, d, d)
    q, s = _check_against_reference(x)
    k = smoke.CODEC_SPECIAL
    assert (q[:k] == 0).all()
    assert s[0, 0] == np.float32(1e-12)
    assert np.isnan(s[1, 0]) and np.isnan(s[4, 0])
    assert s[2, 0] == np.inf and s[3, 0] == np.inf
    assert np.isfinite(s[k:]).all()


def test_wide_single_row_matches_reference():
    """ONE row of 100,003 floats (a split row on the card)."""
    x = smoke.codec_rows(1, 100_003, 7)
    x[0] = np.random.default_rng(8).normal(size=100_003) * 3.0
    assert port_dc.codec_plan(100_003).regime == "split"
    _check_against_reference(x.astype(np.float32))


def _split_scale(x: np.ndarray, tile: int) -> np.ndarray:
    """The split regime's scale, emulated: per-tile maxima of the uint32
    bits of |x|, their maximum per row (atomicMax), then the scale."""
    bits = np.abs(x).view(np.uint32)
    m = np.zeros(x.shape[0], np.uint32)
    for t0 in range(0, x.shape[1], tile):
        m = np.maximum(m, bits[:, t0:t0 + tile].max(axis=1))
    s = m.view(np.float32) * np.float32(1.0 / 127.0)
    return np.where(s < np.float32(1e-12), np.float32(1e-12),
                    s).reshape(-1, 1)


@pytest.mark.parametrize("d", [16385, 2 * port_dc.SPLIT_TILE + 5])
def test_split_absmax_emulation_equals_plain_scale(d):
    x = smoke.codec_rows(9, d, d)
    x[5, -1] = np.nan                         # a NaN in the ragged last tile
    x[6, port_dc.SPLIT_TILE] = -np.inf        # an Inf opening a tile
    x[7] = 0.0
    x[7, d - 1] = 5e-12                       # absmax / 127 under the floor
    _, want = port_ref.quantize_rows(torch.from_numpy(x))
    _same(_split_scale(x, port_dc.SPLIT_TILE), want.numpy())
