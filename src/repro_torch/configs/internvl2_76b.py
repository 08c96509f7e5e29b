"""internvl2-76b — VLM: InternViT frontend (STUB) + LLM decoder backbone.

[arXiv:2404.16821] Language backbone (Llama-3-70B-derived): 80 layers,
d_model=8192, 64 q heads / 8 kv heads, d_ff=28672, vocab 128256.  The
InternViT-6B vision encoder + MLP projector are stubbed per the assignment:
``input_specs()`` supplies 256 pre-projected patch embeddings (pixel-shuffle
output length for one 448² tile) which the decoder consumes before the text
stream.  bf16 + remat for HBM fit.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    frontend="vision",
    frontend_len=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    optimizer_state_dtype="bfloat16",
    remat=True,
    microbatches=16,
    max_seq_len=32_768,
    cite="arXiv:2404.16821",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    name="internvl2-smoke", num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
    d_ff=512, vocab_size=512, frontend_len=16,
    param_dtype="float32", compute_dtype="float32", optimizer_state_dtype="float32",
    remat=False, max_seq_len=256,
)
