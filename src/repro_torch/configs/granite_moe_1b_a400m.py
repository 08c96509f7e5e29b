"""granite-moe-1b-a400m — small MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24 layers, d_model=1024,
16 q heads / 8 kv heads, per-expert d_ff=512, vocab 49155, 32 experts
top-8 (~400M active of 1.3B).  The natural *client-side* model for the
paper's FL setting (SLM class).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_168,  # 49155 padded +13 to divide the 16-way model axis
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512, capacity_factor=1.25),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=4,
    max_seq_len=8192,
    cite="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    param_dtype="float32", compute_dtype="float32",
    remat=False,
    name="granite-smoke", num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, moe=MoEConfig(num_experts=4, top_k=2, d_ff=128),
    max_seq_len=256,
)
