from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine, warmup_linear

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm", "constant", "warmup_cosine",
           "warmup_linear"]
