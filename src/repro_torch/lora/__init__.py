from repro_torch.lora.lora import is_lora_path, merge_lora, split_lora

__all__ = ["is_lora_path", "merge_lora", "split_lora"]
