from repro_torch.lora.lora import (
    is_lora_path, lora_param_count, lora_template, map_lora, merge_lora, split_lora,
)

__all__ = ["is_lora_path", "lora_param_count", "lora_template", "map_lora", "merge_lora",
           "split_lora"]
