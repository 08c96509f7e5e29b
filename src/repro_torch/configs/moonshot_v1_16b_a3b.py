"""moonshot-v1-16b-a3b — fine-grained MoE (64 experts, top-6).

[hf:moonshotai/Moonlight-16B-A3B] 48 layers, d_model=2048, 16 heads
(kv=16, MHA), per-expert d_ff=1408 (DeepSeek-V3-style fine-grained experts),
vocab 163840, 64 experts top-6 (~3B active of 16B).  The release keeps the
first layer dense and adds shared experts; here every layer is routed MoE —
the uniform-scan form that stresses expert-parallel all-to-all hardest
(noted adaptation, DESIGN §5).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, capacity_factor=1.25),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=4,
    max_seq_len=131_072,
    cite="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="moonshot-smoke", num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, moe=MoEConfig(num_experts=4, top_k=2, d_ff=128),
    param_dtype="float32", compute_dtype="float32", remat=False, max_seq_len=256,
)
