"""command-r-35b — dense GQA decoder, no biases, 256k vocab.

[hf:CohereForAI/c4ai-command-r-v01] 40 layers, d_model=8192, 64 q heads /
8 kv heads, d_ff=22528, vocab 256000, LayerNorm, no biases anywhere.
The 256k vocab makes this the paper-technique stress case: one sample's
logit vector is 512 KB — exactly the uplink the adaptive Top-k targets.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    norm="layernorm",
    use_bias=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=16,
    max_seq_len=131_072,
    cite="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="command-r-smoke", num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
    d_ff=512, vocab_size=512,
    param_dtype="float32", compute_dtype="float32", remat=False, max_seq_len=256,
)
