"""mamba2-130m — pure SSD (state-space duality) stack, attention-free.

[arXiv:2405.21060] Mamba-2: 24 layers, d_model=768, vocab 50280 (GPT-NeoX
tokenizer, padded), state N=128, head_dim P=64, expand=2 (d_inner=1536,
24 SSD heads/layer).  No attention, no separate MLP (the Mamba2 block is the
whole layer).  num_heads/num_kv_heads are nominal (unused by the ssm family).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50_288,  # 50280 padded +8 to divide the 16-way model axis
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    positional="none",
    norm="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=4,
    max_seq_len=1_048_576,  # SSMs: O(1) state — long_500k runs natively
    cite="arXiv:2405.21060",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    param_dtype="float32", compute_dtype="float32",
    remat=False,
    name="mamba2-smoke",
    num_layers=2,
    d_model=256,
    vocab_size=512,
    ssm=SSMConfig(state_dim=32, head_dim=32, expand=2, chunk_size=32),
    max_seq_len=256,
)
