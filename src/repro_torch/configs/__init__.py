"""Model configuration schema and the paper's GPT-2 pair (copies of the
reference package's ``repro.configs.base`` and ``gpt2_paper``)."""

from repro_torch.configs.base import LoRAConfig, ModelConfig
from repro_torch.configs.gpt2_paper import GPT2_LARGE, GPT2_SMALL, REDUCED_CLIENT, REDUCED_SERVER

__all__ = ["LoRAConfig", "ModelConfig", "GPT2_SMALL", "GPT2_LARGE", "REDUCED_CLIENT", "REDUCED_SERVER"]
