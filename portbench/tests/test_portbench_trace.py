"""The traced slice's reductions on made-up device records: the busy
union counts overlap once, idle time is charged to the operation the
device waited for, kernels are counted and timed by name."""

import pytest

from portbench.trace import Trace

MS = 1_000_000      # ns


def _trace():
    ops = [(0 * MS, 4 * MS, "gemm_a", True),
           (2 * MS, 5 * MS, "gemm_b", True),         # overlaps gemm_a
           (7 * MS, 8 * MS, "decode_attention_kernel<bf16>", True),
           (8 * MS, 9 * MS, "Memcpy DtoH", False),
           (12 * MS, 13 * MS, "decode_attention_kernel<bf16>", True)]
    return Trace(ops, window_s=0.015)


def test_busy_is_the_union():
    t = _trace()
    assert t.busy_s == pytest.approx(0.008)      # 0-5, 7-9 (copy too), 12-13
    assert t.window_s == 0.015


def test_kernels_by_name():
    t = _trace()
    assert t.kernel_count() == 4 and t.kernel_count("decode_attention") == 2
    assert t.kernel_s("decode_attention") == pytest.approx(0.002)


def test_breakdown_charges_gaps_to_the_next_operation():
    b = dict((k, v) for k, v in _trace().breakdown()["idle_gaps"])
    assert b["launching decode_attention_kernel<bf16>"] == pytest.approx(
        0.002 + 0.003)
    assert b["(slice edges)"] == pytest.approx(0.015 - 0.013)
    ops = dict((k, v) for k, v in _trace().breakdown()["device_ops"])
    assert ops["gemm_a"] == pytest.approx(0.004)
