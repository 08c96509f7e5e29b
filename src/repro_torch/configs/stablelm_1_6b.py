"""stablelm-1.6b — dense decoder, full multi-head attention (kv = q = 32).

[hf:stabilityai/stablelm-2-1_6b] 24 layers, d_model=2048, 32 heads
(num_kv_heads=32 → plain MHA), d_ff=5632, vocab 100352, LayerNorm,
rotary embeddings (partial in the release; full RoPE here), SiLU-gated MLP.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    norm="layernorm",
    activation="swiglu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=4,
    max_seq_len=32_768,
    cite="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    param_dtype="float32", compute_dtype="float32",
    remat=False,
    name="stablelm-smoke", num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=512, vocab_size=512, max_seq_len=256,
)
