"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 72 layers, d_model=8192, 64 q heads / 8 kv heads,
per-expert d_ff=24576, vocab 65536, MoE 16 experts top-2 every other layer,
one attention layer per 8 (attn_every=8; the rest are Mamba blocks with
state N=128, head P=64, expand 2 → d_inner 16384).  398B total params: the
HBM-fit config is bf16 params + bf16 Adam moments + remat (DESIGN §4:
398e9 × 8 B / 256 chips ≈ 12.4 GB/chip).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24_576, capacity_factor=1.25),
    moe_every=2,
    moe_offset=1,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    attn_every=8,
    attn_offset=4,  # attention mid-period, as in the released block layout
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_state_dtype="bfloat16",
    remat=True,
    microbatches=16,
    max_seq_len=1_048_576,  # hybrid: attn layers use the seq-sharded cache
    cite="arXiv:2403.19887",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="jamba-smoke", num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=512), moe_every=2, moe_offset=1,
    ssm=SSMConfig(state_dim=32, head_dim=32, expand=2, chunk_size=32),
    attn_every=4, attn_offset=2,
    param_dtype="float32", compute_dtype="float32", optimizer_state_dtype="float32",
    remat=False, max_seq_len=256,
)
