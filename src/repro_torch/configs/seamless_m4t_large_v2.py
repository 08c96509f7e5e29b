"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio STUB).

[arXiv:2308.11596] SeamlessM4T v2 large transformer backbone: 24 encoder +
24 decoder layers, d_model=1024, 16 heads (MHA, kv=16), d_ff=8192, vocab
256206 (NLLB tokenizer).  The w2v-BERT speech frontend (mel + conv) is
stubbed per the assignment: ``input_specs()`` provides 1024 precomputed
frame embeddings consumed by the encoder; the decoder cross-attends to the
encoder output.  Decode shapes run the decoder (one token + KV cache) with
the fixed encoder output — enc-dec has a decoder, so no decode-shape skip.
Adaptation note (DESIGN §5): relative position bias → RoPE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers; + 24 encoder layers below
    encoder_layers=24,
    cross_attention=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256_208,  # 256206 padded +2 to divide the 16-way model axis
    frontend="audio",
    frontend_len=1024,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    microbatches=4,
    max_seq_len=32_768,
    cite="arXiv:2308.11596",
)

SMOKE_CONFIG = CONFIG.with_overrides(
    param_dtype="float32", compute_dtype="float32",
    remat=False,
    name="seamless-smoke", num_layers=2, encoder_layers=2, d_model=256,
    num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512, frontend_len=16,
    max_seq_len=256,
)
