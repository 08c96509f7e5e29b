"""Model / run configuration schema.

Every assigned architecture gets one ``src/repro/configs/<id>.py`` exporting
``CONFIG`` (the exact published spec, cited) and ``SMOKE_CONFIG`` (a reduced
same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts) for CPU tests.

Families:
  dense   — decoder-only transformer (GQA), optionally every-layer MoE off
  moe     — decoder-only with MoE MLPs
  ssm     — attention-free Mamba2 / SSD stack
  hybrid  — interleaved Mamba + attention (Jamba-style), optional MoE
  vlm     — dense decoder consuming text tokens + stub patch embeddings
  audio   — encoder-decoder; encoder consumes stub frame embeddings
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight (Switch/GShard)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128  # N (SSD state size)
    head_dim: int = 64  # P
    expand: int = 2  # d_inner = expand * d_model
    chunk_size: int = 256  # SSD block length Q
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 32.0
    dropout: float = 0.1
    # Which projections carry adapters.  'qv' matches standard practice and
    # the paper's GPT-2 setup.
    targets: tuple[str, ...] = ("q", "v")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid: layer i is attention iff i % attn_every == attn_offset,
    # else Mamba.  Jamba uses 1:7 (one attn per 8 layers).
    attn_every: int = 1
    attn_offset: int = 0
    # hybrid/moe interleave: layer i uses MoE MLP iff moe is set and
    # i % moe_every == moe_offset.  1 -> every layer.
    moe_every: int = 1
    moe_offset: int = 0
    # enc-dec (audio family): encoder_layers of bidirectional self-attn over
    # frontend embeddings; num_layers counts DECODER layers.
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: Literal["none", "vision", "audio"] = "none"
    # number of stub frontend embeddings (patches / frames) prepended or
    # encoded; used by input_specs.
    frontend_len: int = 256
    positional: Literal["rope", "learned", "none"] = "rope"
    rope_theta: float = 10000.0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["swiglu", "gelu"] = "swiglu"
    use_bias: bool = False
    tie_embeddings: bool = False
    # sliding-window attention (tokens).  None = full causal.  The launcher
    # enables window=4096 for full-attention archs at long_500k (DESIGN §5).
    sliding_window: int | None = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Adam moment dtype; big configs use bfloat16 to fit HBM (DESIGN §4).
    optimizer_state_dtype: str = "float32"
    remat: bool = False
    # gradient-accumulation microbatches per train step (memory lever)
    microbatches: int = 1
    lora: LoRAConfig | None = None
    max_seq_len: int = 8192
    cite: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(1, self.num_kv_heads) == 0, (
            "q heads must be a multiple of kv heads (GQA)"
        )
        if self.family in ("ssm",):
            assert self.ssm is not None
        if self.family == "hybrid":
            assert self.ssm is not None and self.attn_every > 1
        if self.family == "audio":
            assert self.encoder_layers > 0 and self.cross_attention

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def is_attention_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe_every == self.moe_offset

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts (for roofline MODEL_FLOPS = 6·N·D) ----

    def _attn_params(self) -> int:
        hd = self.head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        return q + kv + o

    def _dense_mlp_params(self) -> int:
        mult = 3 if self.activation == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    def _moe_mlp_params(self, active_only: bool) -> int:
        assert self.moe is not None
        mult = 3 if self.activation == "swiglu" else 2
        per_expert = mult * self.d_model * self.moe.d_ff
        router = self.d_model * self.moe.num_experts
        n = self.moe.top_k if active_only else self.moe.num_experts
        return n * per_expert + router

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        d_in = self.ssm.expand * self.d_model
        nheads = d_in // self.ssm.head_dim
        n = self.ssm.state_dim
        # in_proj -> [z, x, B, C, dt], out_proj, conv, A, D, norms
        in_proj = self.d_model * (2 * d_in + 2 * n + nheads)
        out_proj = d_in * self.d_model
        conv = self.ssm.conv_width * (d_in + 2 * n)
        return in_proj + out_proj + conv + 2 * nheads

    def param_count(self, *, active_only: bool = False) -> int:
        """Approximate parameter count (embeddings + blocks).

        ``active_only=True`` counts only top-k experts per MoE layer —
        the N_active used for MoE MODEL_FLOPS.
        """
        total = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        layers = 0
        for i in range(self.num_layers):
            if self.is_attention_layer(i):
                layers += self._attn_params()
            else:
                layers += self._ssm_params()
            if self.family == "ssm":
                # Mamba2 blocks have no separate MLP
                continue
            if self.is_moe_layer(i):
                layers += self._moe_mlp_params(active_only)
            else:
                layers += self._dense_mlp_params()
            layers += 2 * self.d_model  # norms
        total += layers
        # encoder stack (audio)
        for _ in range(self.encoder_layers):
            total += self._attn_params() + self._dense_mlp_params() + 2 * self.d_model
        if self.cross_attention:
            total += self.num_layers * (self._attn_params() + self.d_model)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
