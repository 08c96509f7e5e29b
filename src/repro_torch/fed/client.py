"""FL client state: its private data, its batch stream and its fresh
parameters (Algorithm 1, client loop) — the port of ``repro/fed/client.py``.

The round computation itself lives in the engine, which stacks the cohort
on a leading client axis; a client contributes its parameters at start-up
and draws its private batches from its own numpy rng, exactly as the
reference client does, so both packages feed identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.protocol import PayloadSpec, UplinkPayload
from repro_torch.data.pipeline import epoch_batches
from repro_torch.data.synthetic import IntentDataset
from repro_torch.lora import merge_lora, split_lora
from repro_torch.models import model as model_lib

__all__ = ["Client", "make_upload_payload"]


def make_upload_payload(
    cfg: ModelConfig,
    client_id: int,
    num_samples: int,
    k: int,
    *,
    send_h: bool,
    value_bits: int,
    snr_db: float,
    quantize: bool = False,
) -> tuple[UplinkPayload, int | None]:
    """The single source of truth for one upload's on-air accounting.
    Returns (payload, lora_rank or None).  ``quantize`` prices the (value,
    index) entries at the int8 wire's 8 bits while the projection ``h``
    keeps ``value_bits``."""
    rank = cfg.lora.rank if (send_h and cfg.lora is not None) else None
    spec = PayloadSpec(
        num_samples=num_samples, vocab=cfg.vocab_size, k=k,
        lora_rank=rank,
        value_bits=8 if quantize else value_bits,
        h_value_bits=value_bits if quantize else None,
    )
    return UplinkPayload(client_id=client_id, spec=spec, snr_db=snr_db), rank


class Client:
    def __init__(
        self,
        client_id: int,
        cfg: ModelConfig,
        private_data: IntentDataset,
        *,
        seed: int = 0,
        batch_size: int = 32,
        device: str | torch.device = "cuda",
        initial_params: dict | None = None,
    ):
        self.client_id = client_id
        self.cfg = cfg
        self.data = private_data
        self.batch_size = batch_size
        params = model_lib.init(cfg, seed, device)
        if initial_params is not None:
            # shared pretrained backbone W' (paper eq. 1) + this client's fresh LoRA
            own_lora, _ = split_lora(params)
            _, frozen = split_lora(initial_params)
            params = merge_lora(own_lora, frozen)
        self.params: dict | None = params  # handed to the engine, which owns it after
        self._rng = np.random.default_rng(seed + 1000 * (client_id + 1))

    def next_train_batches(self, num_steps: int) -> list[dict]:
        """The next ``num_steps`` private batches from this client's own rng
        stream (the reference's exact draw order)."""
        out: list[dict] = []
        while len(out) < num_steps:
            for batch in epoch_batches(self.data, self.batch_size, rng=self._rng):
                out.append(batch)
                if len(out) >= num_steps:
                    break
        return out
