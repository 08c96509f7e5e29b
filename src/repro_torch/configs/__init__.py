"""Model configuration schema, the paper's GPT-2 pair and the reference's
other architectures (copies of the reference package's ``repro.configs``,
data only) and the architecture registry: ``--arch <id>`` resolution for
the launchers.

``ARCHITECTURES`` lists the reference's public dashed ids in its order, and
``get_config``/``get_smoke_config`` return every one of them, and the port
runs each in fp32, bf16 and fp16; any other dtype name is refused when a
model is built (:func:`repro_torch.models.model.check_supported`).
``remat`` (each repeat of the layer period, and each position of a longer
period, recomputed in the backward: ``models.transformer.stack_apply``) and
``microbatches`` change memory, not results."""

import importlib

from repro_torch.configs.base import LoRAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.gpt2_paper import GPT2_LARGE, GPT2_SMALL, REDUCED_CLIENT, REDUCED_SERVER

__all__ = ["ARCHITECTURES", "LoRAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "GPT2_SMALL",
           "GPT2_LARGE", "REDUCED_CLIENT", "REDUCED_SERVER", "get_config", "get_smoke_config"]

# arch id -> module name, as in the reference
ARCHITECTURES: dict[str, str] = {
    "mamba2-130m": "mamba2_130m",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "yi-9b": "yi_9b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "command-r-35b": "command_r_35b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    # the paper's own models
    "gpt2-paper": "gpt2_paper",
}


def _module(arch_id: str):
    if arch_id not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHITECTURES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHITECTURES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
