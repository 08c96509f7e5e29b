"""yi-9b — dense llama-architecture decoder with aggressive GQA (kv=4).

[arXiv:2403.04652] 48 layers, d_model=4096, 32 q heads / 4 kv heads,
d_ff=11008, vocab 64000, RMSNorm + SwiGLU + RoPE, no biases.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=8,
    max_seq_len=32_768,
    cite="arXiv:2403.04652",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="yi-smoke", num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat=False, max_seq_len=256,
)
