"""The paper's own model pair (§IV): GPT-2 small clients / GPT-2 large server.

[Radford et al. 2019]  GPT-2 small: 12L, d=768, 12H, d_ff=3072; GPT-2
large: 36L, d=1280, 20H, d_ff=5120; vocab 50257, learned positions, GELU,
LayerNorm with biases, tied embeddings.  LoRA (r=8, α=32, dropout 0.1 —
paper Table I) on q/v projections.

REDUCED_* are width/depth-scaled same-family variants with a compact vocab,
used by the runnable end-to-end FL examples and Fig. 2/3 benchmarks on CPU
(DESIGN §1: the exact GPT-2 checkpoints are a data gate; the mechanisms and
method ordering are what we reproduce).
"""

from repro_torch.configs.base import LoRAConfig, ModelConfig

_COMMON = dict(
    family="dense",
    positional="learned",
    norm="layernorm",
    activation="gelu",
    use_bias=True,
    tie_embeddings=True,
    max_seq_len=1024,
    cite="Radford et al. 2019 (GPT-2)",
)

GPT2_SMALL = ModelConfig(
    name="gpt2-small",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50_257,
    lora=LoRAConfig(rank=8, alpha=32.0, dropout=0.1),
    **_COMMON,
)

GPT2_LARGE = ModelConfig(
    name="gpt2-large",
    num_layers=36,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=50_257,
    lora=LoRAConfig(rank=8, alpha=32.0, dropout=0.1),
    **_COMMON,
)

# CPU-runnable same-family pair for the end-to-end FL experiments.  The
# reduced backbones are shallow and trained from scratch (DESIGN §1), so the
# adapters carry more of the task than they would on real GPT-2: rank 16 on
# q/v/o + the LM head (all standard PEFT targets).  The full-size GPT2_*
# configs above keep the paper's exact r=8 q/v setting.
REDUCED_LORA = LoRAConfig(rank=16, alpha=32.0, dropout=0.1, targets=("q", "v", "o", "head"))
REDUCED_CLIENT = GPT2_SMALL.with_overrides(
    name="gpt2-reduced-client", num_layers=4, d_model=256, num_heads=4,
    num_kv_heads=4, d_ff=1024, vocab_size=1024, max_seq_len=128,
    lora=REDUCED_LORA,
)
REDUCED_SERVER = GPT2_LARGE.with_overrides(
    name="gpt2-reduced-server", num_layers=6, d_model=384, num_heads=6,
    num_kv_heads=6, d_ff=1536, vocab_size=1024, max_seq_len=128,
    lora=REDUCED_LORA,
)

CONFIG = GPT2_LARGE  # registry entry: the paper's server model
SMOKE_CONFIG = REDUCED_CLIENT.with_overrides(name="gpt2-smoke", num_layers=2)
