"""Model/shape configuration system (a copy of ``repro/configs/base.py``;
the port imports nothing of the JAX package).

Every assigned architecture is a ``ModelConfig`` built from a repeating
*pattern unit* of block types.  The JAX package lowers the units as one
``lax.scan`` over stacked per-unit parameters; the port runs them as a
Python loop over a ``ModuleList``:

  block chars:  D = attention + dense MLP        (all dense archs)
                E = attention + MoE FFN          (llama4 alternates D/E)
                M = Mamba2 (SSD) block           (mamba2, zamba2)
                A = attention + dense MLP        (zamba2's shared-attention
                                                  blocks; same math as D,
                                                  kept distinct for clarity)

``layers = pattern_unit * num_units + tail``.

Shape specs are the assigned input shapes; ``runnable`` marks the cells that
execute (long_500k only for sub-quadratic archs, per the assignment).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int                   # per-expert FFN width
    shared_d_ff: int = 0        # always-on shared expert (llama4)
    capacity_factor: float = 1.25
    group_size: int = 1024      # tokens per dispatch group (dense dispatch)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    num_layers: int
    num_frames: int = 1500      # whisper conv-frontend output length (stub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense|moe|hybrid|ssm|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    pattern_unit: str = "D"
    tail: str = ""
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    encoder: EncoderCfg | None = None
    frontend: str | None = None          # "audio" | "vq_image" (stubs)
    sub_quadratic: bool = False          # can run long_500k
    use_pallas: bool = False             # kept as in JAX; read by nothing
    moe_impl: str = "dense"              # "dense" (pjit) | "sorted" (paper)
    dtype: str = "bfloat16"
    remat: str = "full"                  # "none"|"full"|"dots"
    scan_layers: bool = True             # False: unroll (cost extrapolation)
    train_accum: int = 1                 # gradient-accumulation microbatches
    source: str = ""                     # provenance note

    def __post_init__(self):
        unit = len(self.pattern_unit)
        assert (self.num_layers - len(self.tail)) % unit == 0, \
            (self.name, self.num_layers, self.pattern_unit, self.tail)

    @property
    def num_units(self) -> int:
        return (self.num_layers - len(self.tail)) // len(self.pattern_unit)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.num_heads * hd * 2 \
            + d * self.num_kv_heads * hd * 2
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = 0
        if self.moe:
            moe_ffn = 3 * d * self.moe.d_ff * self.moe.num_experts \
                + 3 * d * self.moe.shared_d_ff + d * self.moe.num_experts
        per = {"D": attn + dense_ffn, "A": attn + dense_ffn,
               "E": attn + moe_ffn, "M": self._mamba_params()}
        pattern = self.pattern_unit * self.num_units + self.tail
        total = sum(per[c] for c in pattern)
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.encoder:
            total += self.encoder.num_layers * (attn + dense_ffn) \
                + self.num_layers * (attn + dense_ffn)  # cross attn approx
        return total

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        inactive = 3 * d * self.moe.d_ff * \
            (self.moe.num_experts - self.moe.top_k)
        n_moe = sum(1 for c in self.pattern_unit * self.num_units + self.tail
                    if c == "E")
        return self.param_count() - n_moe * inactive

    def _mamba_params(self) -> int:
        if not self.ssm:
            return 0
        d, s = self.d_model, self.ssm
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.d_state
        return (d * (2 * d_in + 2 * s.d_state + nheads)   # in_proj
                + conv_dim * s.conv_kernel                 # conv
                + 2 * nheads + nheads                      # A, D, dt_bias
                + d_in * d)                                # out_proj


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def runnable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  (False, why) if assigned-skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k decode needs sub-quadratic "
                       "attention (skip noted in DESIGN.md §4)")
    return True, ""


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


ARCH_IDS = [
    "qwen3_8b", "qwen3_32b", "qwen2_5_14b", "phi3_mini_3_8b",
    "llama4_maverick_400b", "granite_moe_3b", "zamba2_1_2b", "mamba2_2_7b",
    "whisper_large_v3", "chameleon_34b",
]


def load_all() -> None:
    import importlib
    for arch in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{arch}")


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests (one step, no NaNs)."""
    kw: dict = dict(
        name=cfg.name + "_smoke", d_model=64, num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads
        < cfg.num_heads else 4,
        head_dim=16, d_ff=128, vocab_size=503,  # odd on purpose (padding)
        num_layers=len(cfg.pattern_unit) + len(cfg.tail),
        tail=cfg.tail[:2], rope_theta=1e4, remat="none",
    )
    kw["num_layers"] = len(cfg.pattern_unit) + len(kw["tail"])
    if cfg.moe:
        kw["moe"] = MoECfg(num_experts=8, top_k=min(cfg.moe.top_k, 2),
                           d_ff=32, shared_d_ff=32 if cfg.moe.shared_d_ff
                           else 0, group_size=32)
    if cfg.ssm:
        kw["ssm"] = SSMCfg(d_state=16, head_dim=16, expand=2, conv_kernel=4,
                           chunk=16)
    if cfg.encoder:
        kw["encoder"] = EncoderCfg(num_layers=1, num_frames=24)
    return dataclasses.replace(cfg, **kw)
