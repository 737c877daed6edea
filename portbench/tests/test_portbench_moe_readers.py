"""The MoE layer's readers on made-up device records and spans:
``moe_pct.train`` (busy time inside ``layer.moe`` over ``train.step``),
``expert_imbalance.train`` (the most rows of a held expert over the
held experts' mean) and ``expert_gemm_roofline`` (the grouped products'
least time over their kernels' device time); each None without its
spans."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.peaks import least_s
from portbench.reference import granite_hybrid
from portbench.trace import Trace

MS = 1_000_000      # ns
SPEC = {"hidden_size": 4096, "intermediate_size": 768,
        "shared_intermediate_size": 1536, "mamba_expand": 2,
        "mamba_d_state": 128, "mamba_d_head": 64, "num_attention_heads": 32,
        "num_key_value_heads": 8, "published_num_local_experts": 72,
        "num_local_experts": 9, "num_experts_per_tok": 10,
        "torch_dtype": "bfloat16"}
# busy 0-4 ms (a layer's ops), 5-9 ms of grouped products, 10-12 ms other
OPS = [(0, 4 * MS, "gemm", True),
       (5 * MS, 5.5 * MS, "at::cuda::detail::prepare_grouped_gemm_data<>",
        True),
       (5.5 * MS, 7 * MS, "cutlass::device_kernel<GemmUniversal<"
        "GroupProblemShape<>>>", True),
       (7 * MS, 9 * MS, "_ZN7cutlass13device_kernelI17GroupProblemShape",
        True),
       (10 * MS, 12 * MS, "adam", True)]
NEW = ["moe_pct.train", "expert_imbalance.train", "expert_gemm_roofline"]


def _span(name, host, device=None, **args):
    d = {"name": name, "t0": host[0] * 1e-3, "t1": host[1] * 1e-3,
         "proc": "main", "trace": 0, "span": 0, "parent": 0, "tid": 1}
    if device:
        d["device"] = (device[0] * 1e-3, device[1] * 1e-3)
    if args:
        d["args"] = args
    return d


TRAIN = [_span("train.step", (0, 12), (0, 12)),
         _span("layer.moe", (1, 2), (1, 3), held_rows=18000, max_rows=4000),
         _span("layer.moe", (3, 4), (3, 6), held_rows=20000, max_rows=2500),
         _span("layer.moe", (6, 7), (6, 7))]        # a recompute: no rows


class _Tracer:
    def __init__(self, exported):
        self.exported = exported

    def export(self):
        return list(self.exported)


@pytest.fixture
def program(monkeypatch):
    from repro_torch.obs import trace as obs_trace

    def install(exported):
        monkeypatch.setattr(obs_trace, "get_tracer",
                            lambda: _Tracer(exported))
    return install


def _cell(kind="train"):
    return SimpleNamespace(kind=kind, trace=Trace(OPS, window_s=0.012),
                           spec=SPEC,
                           ctx=SimpleNamespace(family=granite_hybrid))


def test_moe_share_of_the_step(program):
    """``layer.moe`` device intervals 1-3, 3-6 and 6-7 ms hold 1-4 and 5-7
    of busy time (5 ms) of the step's 10."""
    program(TRAIN)
    got = harness.metric_reader("moe_pct.train")(_cell())
    assert got == pytest.approx(50.0)


def test_imbalance_over_the_noted_spans(program):
    """max / (held / 9) per noted span, averaged: 2.0 and 1.125."""
    program(TRAIN)
    got = harness.metric_reader("expert_imbalance.train")(_cell())
    assert got == pytest.approx((4000 * 9 / 18000 + 2500 * 9 / 20000) / 2)


def test_expert_gemm_roofline(program):
    """Each noted span's rows: the forward twice (forward, recompute) and
    the backward once, over the 4 ms of grouped-product kernels."""
    program(TRAIN)
    count = granite_hybrid.expert_gemm_flops_bytes
    least = sum(2 * least_s(*count(r, SPEC))
                + least_s(*count(r, SPEC, backward=True))
                for r in (18000, 20000))
    got = harness.metric_reader("expert_gemm_roofline")(_cell())
    assert got == pytest.approx(100 * least / 0.004)
    flops, nbytes = count(20000, SPEC)
    assert flops == pytest.approx(6 * 20000 * 4096 * 768)
    assert flops / 989e12 > nbytes / 3.35e12        # bound by operations
    assert count(20000, SPEC, backward=True)[0] == pytest.approx(2 * flops)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_spans_reads_nothing(program, name):
    program([_span("train.step", (0, 12), (0, 12))])
    read = harness.metric_reader(name)
    assert read(_cell()) is None
    assert read(_cell("prefill")) is None


def test_granite_flop_count():
    """1.70e14 model FLOPs a step of 8 x 2,048 on the card's share (the
    PERF.md prediction's basis); three forwards a step."""
    spec = harness.config_spec(harness.load_manifest(), "granite-4.0-h-small")
    fwd = granite_hybrid.forward_flops(spec, 8, 2048)
    assert granite_hybrid.train_flops(spec, 8, 2048) == pytest.approx(3 * fwd)
    assert granite_hybrid.train_flops(spec, 8, 2048) == pytest.approx(
        1.70e14, rel=0.01)
