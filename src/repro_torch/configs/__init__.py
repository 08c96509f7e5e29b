"""Model configuration schema, the paper's GPT-2 pair (copies of the
reference package's ``repro.configs.base`` and ``gpt2_paper``) and the
architecture registry: ``--arch <id>`` resolution for the launchers.

``ARCHITECTURES`` lists the reference's public dashed ids in its order;
the port carries ``gpt2-paper``, and ``get_config``/``get_smoke_config``
of any other id raise naming its ROADMAP.md port queue item."""

from repro_torch.configs.base import LoRAConfig, ModelConfig
from repro_torch.configs.gpt2_paper import GPT2_LARGE, GPT2_SMALL, REDUCED_CLIENT, REDUCED_SERVER

__all__ = ["ARCHITECTURES", "LoRAConfig", "ModelConfig", "GPT2_SMALL", "GPT2_LARGE",
           "REDUCED_CLIENT", "REDUCED_SERVER", "get_config", "get_smoke_config"]

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
    if arch_id != "gpt2-paper":
        from repro_torch.fed.engines.base import not_carried

        raise not_carried(f"--arch {arch_id}", "other model families and mixed fleets")
    from repro_torch.configs import gpt2_paper

    return gpt2_paper


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
