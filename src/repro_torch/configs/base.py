"""Config system of the LM zoo: model architecture configs, registry and
layer segmentation — the port's own copy of the reference's
``configs/base.py`` (pure Python; the port imports nothing of the JAX
package).

Every architecture is a ``ModelConfig``. Layer stacks are *segments*: a
segment is a repeating pattern of ``LayerSpec`` entries (mixer kind + ffn
kind) run ``repeats`` times, with the parameters stacked on a leading
``repeats`` axis (the reference scans it; the port's ``models/model.py``
loops over it).

The registry knows every architecture id of the reference, and the port
has a config for each (``PORTED_ARCH_IDS``, the ids of ``ARCH_IDS``);
``PORT_ONLY_ARCH_IDS`` are the port's own, which the reference lacks
(``PortModelConfig``s). ``get_config`` imports an id's module on first
use and raises ``KeyError`` for an unknown id.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"            # global causal self-attention
LOCAL_ATTN = "local"     # sliding-window causal self-attention
MAMBA = "mamba"          # mamba2 / SSD block
CROSS_ATTN = "xattn"     # cross-attention to encoder states (VLM / enc-dec)
ENC_ATTN = "enc"         # bidirectional encoder self-attention

# ffn kinds
MLP = "mlp"
MOE = "moe"
NONE = "none"            # pure-mixer block (mamba2 has no FFN)

MIXER_KINDS = (ATTN, LOCAL_ATTN, MAMBA, CROSS_ATTN, ENC_ATTN)
FFN_KINDS = (MLP, MOE, NONE)


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a segment pattern."""

    mixer: str
    ffn: str = MLP

    def __post_init__(self):
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"unknown mixer kind {self.mixer!r}")
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"unknown ffn kind {self.ffn!r}")


@dataclass(frozen=True)
class Segment:
    """A repeating pattern of layers, run ``repeats`` times."""

    pattern: tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation bracket from the assignment
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...]    # decoder stack
    # encoder stack (whisper) — empty for decoder-only models
    encoder_segments: tuple[Segment, ...] = ()
    encoder_len: int = 0             # stub frontend: #frames / #patches
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # >1 enables group-local dispatch (set to the data-axis size by the
    # optimized dry-run variants; see models/moe.py + §Perf)
    moe_dispatch_groups: int = 1
    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # attention details
    window_size: int = 0             # for LOCAL_ATTN layers
    qkv_bias: bool = False
    # context-parallel attention: shard the query sequence over `model`
    # instead of head_dim when heads don't divide the TP degree (avoids the
    # full-score all-reduce pathology; requires a mesh in scope — only the
    # dry-run/launchers enable it). See §Perf.
    context_parallel_attn: bool = False
    # chunked cross-entropy: compute logits/CE in S-chunks of this size
    # with the vocab head gathered once (0 = monolithic logits). See §Perf.
    loss_chunk: int = 0
    rope_theta: float = 500_000.0
    logit_softcap: float = 0.0
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer: str = "adam"          # default training optimizer for this arch
    remat: bool = True
    # decode-shape applicability (long_500k needs sub-quadratic attention)
    supports_long_context: bool = False
    supports_decode: bool = True
    tie_embeddings: bool = False

    # The settings of the port's own architectures, at their neutral values:
    # class attributes here, fields of ``PortModelConfig``, so that
    # ``dataclasses.asdict`` of every config the reference has stays its
    # own. At these values they add no operation.
    shared_expert_ff = 0             # width of a shared gated-SiLU expert
    embedding_multiplier = 1.0       # on the token embeddings
    residual_multiplier = 1.0        # on both residual branches of a layer
    attention_multiplier = 0.0       # softmax scale; 0: head_dim ** -0.5
    logits_scaling = 1.0             # the logits divided by it
    use_rope = True                  # False: no positional embedding (NoPE)
    moe_dropless = False             # True: every assignment computed
    experts_held = 0                 # experts this card holds; 0: all of them
    norm_eps = 1e-6                  # every RMSNorm's epsilon

    # ---- derived -----------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a 256 multiple so the vocab axis
        shards evenly on any production mesh axis (logits beyond
        ``vocab_size`` are masked in forward/decode)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def held_experts(self) -> int:
        """Experts the MoE layers hold here: ``[0, held_experts)`` of the
        router's ``num_experts``."""
        return self.experts_held or self.num_experts

    @property
    def attention_scale(self) -> float:
        """The attention softmax's scale: ``attention_multiplier``, or
        ``head_dim ** -0.5`` where it is 0."""
        return self.attention_multiplier or self.head_dim ** -0.5

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.segments) + sum(
            s.num_layers for s in self.encoder_segments
        )

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return bool(self.encoder_segments)

    @property
    def has_encoder_context(self) -> bool:
        """Models whose inputs include stub frontend embeddings."""
        return self.encoder_len > 0

    def layer_specs(self) -> list[LayerSpec]:
        """Flat (unrolled) list of decoder layer specs, for accounting."""
        out: list[LayerSpec] = []
        for seg in self.segments:
            out.extend(list(seg.pattern) * seg.repeats)
        return out

    def validate(self) -> None:
        """Raise ``ValueError`` if the config is inconsistent (the
        conditions the reference checks)."""
        specs = self.layer_specs()
        checks = []
        if any(s.ffn == MOE for s in specs):
            checks.append(self.num_experts > 0 and self.experts_per_token > 0
                          and 0 <= self.experts_held <= self.num_experts)
            checks.append(self.moe_dropless or self.experts_held in
                          (0, self.num_experts))
        if any(s.mixer == MAMBA for s in specs):
            checks.append(self.ssm_state > 0
                          and self.d_inner % self.ssm_head_dim == 0)
        if any(s.mixer == LOCAL_ATTN for s in specs):
            checks.append(self.window_size > 0)
        if any(s.mixer in (ATTN, LOCAL_ATTN, CROSS_ATTN, ENC_ATTN) for s in specs):
            checks.append(self.num_heads % self.num_kv_heads == 0)
        if not all(checks):
            raise ValueError(f"inconsistent config {self.name!r}")

    # ---- parameter counting (for roofline MODEL_FLOPS) ---------------
    def param_counts(self) -> dict[str, int]:
        """Returns {'total': N, 'active': N_active} parameter counts. A MoE
        layer counts the experts it holds and its shared expert; its
        active count takes the held experts at their expected share
        ``experts_per_token * held / num_experts`` of a token's routes."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        active = total

        def attn_params(cross: bool = False) -> int:
            q = d * h * hd + (h * hd if self.qkv_bias else 0)
            k = d * kv * hd + (kv * hd if self.qkv_bias else 0)
            vp = d * kv * hd + (kv * hd if self.qkv_bias else 0)
            o = h * hd * d
            return q + k + vp + o + d  # + input norm

        def mlp_params() -> int:
            return 3 * d * ff + d  # gate/up/down + norm

        def moe_params() -> tuple[int, int]:
            router = d * self.num_experts
            per_expert = 3 * d * ff
            held = self.held_experts
            shared = 3 * d * self.shared_expert_ff
            tot = router + held * per_expert + shared + d
            act = router + self.experts_per_token * held * per_expert \
                // self.num_experts + shared + d
            return tot, act

        def mamba_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_num_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = self.ssm_conv_width * (di + 2 * ns)
            out_proj = di * d
            extra = nh * 3 + di  # A_log, D, dt_bias, gated-norm
            return in_proj + conv + out_proj + extra + d

        all_specs = self.layer_specs() + [
            s for seg in self.encoder_segments for s in list(seg.pattern) * seg.repeats
        ]
        for spec in all_specs:
            if spec.mixer in (ATTN, LOCAL_ATTN, ENC_ATTN):
                total += attn_params(); active += attn_params()
            elif spec.mixer == CROSS_ATTN:
                total += attn_params(cross=True); active += attn_params(cross=True)
            elif spec.mixer == MAMBA:
                total += mamba_params(); active += mamba_params()
            if spec.ffn == MLP:
                total += mlp_params(); active += mlp_params()
            elif spec.ffn == MOE:
                t, a = moe_params(); total += t; active += a
        total += d  # final norm
        active += d
        return {"total": total, "active": active}


@dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ``ModelConfig`` of an architecture the port has and the reference
    lacks: ``ModelConfig``'s class-level settings as fields (see there)."""

    shared_expert_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    use_rope: bool = True
    moe_dropless: bool = False
    experts_held: int = 0
    norm_eps: float = 1e-6


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "mamba2-1.3b",
    "llama-3.2-vision-90b",
    "qwen1.5-4b",
    "dbrx-132b",
    "qwen2-7b",
    "granite-moe-3b-a800m",
    "qwen2-1.5b",
    "whisper-medium",
    "jamba-1.5-large-398b",
    "gemma3-4b",
)
# The paper's own sparse CTR model family lives in configs/weips_ctr.py with
# its own config class (it is a sparse PS model, not a transformer).

# the architectures the port has configs for: every id of ARCH_IDS
PORTED_ARCH_IDS = ("mamba2-1.3b", "qwen1.5-4b", "dbrx-132b", "qwen2-7b",
                   "granite-moe-3b-a800m", "qwen2-1.5b", "gemma3-4b",
                   "whisper-medium", "llama-3.2-vision-90b",
                   "jamba-1.5-large-398b")

# the port's own architectures, which the reference lacks; each module
# may register more than one id (a deployment's share of one card)
PORT_ONLY_ARCH_IDS = ("granite-4.0-h-small", "granite-4.0-h-small-ep8")

_MODULE_FOR_ARCH = {a: a.replace("-", "_").replace(".", "_")
                    for a in PORTED_ARCH_IDS}
_MODULE_FOR_ARCH.update({a: "granite_4_0_h_small"
                         for a in PORT_ONLY_ARCH_IDS})

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = _MODULE_FOR_ARCH.get(name)
        if mod is None:
            raise KeyError(f"unknown architecture {name!r}; known: "
                           f"{ARCH_IDS + PORT_ONLY_ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    """Every config the port has (``PORTED_ARCH_IDS``)."""
    return {a: get_config(a) for a in PORTED_ARCH_IDS}


def reduced(cfg: ModelConfig, *, d_model: int = 256, layers_per_segment: int = 1,
            d_ff: Optional[int] = None, vocab: int = 512,
            num_experts: Optional[int] = None) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model<=512, <=4 experts."""
    if d_model > 512:
        raise ValueError(f"reduced d_model must be <= 512, got {d_model}")
    n_exp = num_experts if num_experts is not None else (
        min(cfg.num_experts, 4) if cfg.num_experts else 0)
    topk = min(cfg.experts_per_token, max(1, n_exp // 2)) if n_exp else 0
    heads = max(2, min(4, cfg.num_heads))
    kv = 1 if cfg.num_kv_heads == 1 else 2
    hd = d_model // heads
    segs = tuple(
        Segment(pattern=s.pattern, repeats=min(s.repeats, layers_per_segment))
        for s in cfg.segments[:1]
    )
    enc_segs = tuple(
        Segment(pattern=s.pattern, repeats=min(s.repeats, layers_per_segment))
        for s in cfg.encoder_segments[:1]
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=d_ff if d_ff is not None else max(64, d_model * 2),
        vocab_size=vocab,
        segments=segs,
        encoder_segments=enc_segs,
        encoder_len=min(cfg.encoder_len, 16),
        num_experts=n_exp,
        experts_per_token=topk,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=32 if cfg.ssm_state else cfg.ssm_chunk,
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
