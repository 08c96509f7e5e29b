"""llama4-scout-17b-a16e — MoE decoder, 16 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48 layers, d_model=5120, 40 q heads /
8 kv heads (GQA), per-expert d_ff=8192, vocab 202048, 16 experts top-1
routing (17B active of 109B total).  Every layer MoE here (the release
interleaves a shared expert; the routed-expert path is what stresses the
framework's expert-parallel sharding).  bf16 params + remat to fit v5e HBM.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192, capacity_factor=1.25),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_state_dtype="bfloat16",
    remat=True,
    microbatches=16,
    max_seq_len=262_144,
    cite="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="llama4-smoke", num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, moe=MoEConfig(num_experts=4, top_k=1, d_ff=256),
    param_dtype="float32", compute_dtype="float32", optimizer_state_dtype="float32",
    remat=False, max_seq_len=256,
)
