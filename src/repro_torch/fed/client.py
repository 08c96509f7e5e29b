"""FL client: local LoRA fine-tuning and the sparsified knowledge upload
(Algorithm 1, client loop: lines 3-12) — the port of ``repro/fed/client.py``.

The ``sequential`` engine runs each client's round through the methods
here, one client at a time, as the paper writes Algorithm 1.  The cohort
engines instead stack the cohort on a leading client axis: they take the
client's parameters at start-up and draw its private batches through
:meth:`Client.next_train_batches`.  Either way a client draws its batches
from its own numpy rng, exactly as the reference client does, so both
packages feed identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import ChannelState, topk_budget
from repro_torch.core.protocol import PayloadSpec, UplinkPayload, lora_projection_bits
from repro_torch.core.topk import SparseLogits, topk_sparsify
from repro_torch.data.pipeline import epoch_batches
from repro_torch.data.synthetic import IntentDataset
from repro_torch.fed import steps as fed_steps
from repro_torch.lora import merge_lora, split_lora
from repro_torch.models import model as model_lib

__all__ = ["ClientUpload", "Client", "make_upload_payload"]


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


@dataclasses.dataclass
class ClientUpload:
    client_id: int
    sparse: SparseLogits  # top-k (values, indices) on the public set
    h: torch.Tensor | None  # (P, r) LoRA projections (paper eq. 8)
    payload: UplinkPayload  # byte accounting
    k: int


class Client:
    """One client.  ``num_classes`` is needed by :meth:`local_train` only
    (the cohort engines build their own steps)."""

    def __init__(
        self,
        client_id: int,
        cfg: ModelConfig,
        private_data: IntentDataset,
        *,
        num_classes: int | None = None,
        seed: int = 0,
        lr: float = 1e-3,
        distill_lr: float = 1e-3,
        temperature: float = 2.0,
        lam: float = 0.03,
        batch_size: int = 32,
        local_steps: int = 4,
        distill_steps: int = 2,
        restrict_to_support: bool = False,
        last_only: bool = True,
        device: str | torch.device = "cuda",
        initial_params: dict | None = None,
    ):
        self.client_id = client_id
        self.cfg = cfg
        self.data = private_data
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.local_steps = local_steps
        self.distill_steps = distill_steps
        self.last_only = last_only
        if initial_params is None:
            params = model_lib.init(cfg, seed, device)
        else:
            # shared pretrained backbone W' (paper eq. 1) + this client's fresh LoRA
            own_lora, _ = split_lora(model_lib.init(cfg, seed, device, adapters_only=True))
            _, frozen = split_lora(initial_params)
            params = merge_lora(own_lora, frozen)
        # a cohort engine takes both over at start-up and sets them to None
        self.params: dict | None = params
        self.opt = fed_steps.init_lora_opt(params, cfg)
        self._train_step = None if num_classes is None else fed_steps.make_finetune_step(
            cfg, num_classes, lr=lr, last_only=last_only
        )
        self._distill_step = fed_steps.make_distill_step(
            cfg, lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, last_only=last_only,
        )
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

    @property
    def _device(self) -> torch.device:
        return self.params["embed"].device

    # ---- Algorithm 1, line 8: local supervised fine-tuning ----
    def local_train(self) -> dict:
        if self._train_step is None:
            raise ValueError("Client.local_train needs the client built with num_classes")
        metrics = {}
        for batch in self.next_train_batches(self.local_steps):
            tb = {k: torch.as_tensor(v, device=self._device) for k, v in batch.items()}
            self.params, self.opt, metrics = self._train_step(self.params, self.opt, tb)
        return {k: float(v) for k, v in metrics.items()}

    # ---- Algorithm 1, lines 5-7: local distillation vs global knowledge ----
    def local_distill(self, public_tokens, g_logits, g_h) -> dict:
        metrics = {}
        for _ in range(self.distill_steps):
            self.params, self.opt, metrics = self._distill_step(
                self.params, self.opt, public_tokens, g_logits, g_h
            )
        return {k: float(v) for k, v in metrics.items()}

    # ---- Algorithm 1, lines 9-11: infer public set, top-k, upload ----
    def upload(
        self,
        public_tokens: torch.Tensor,
        channel: ChannelState,
        *,
        value_bits: int = 16,
        k_override: int | None = None,
        send_h: bool = True,
        k_min: int = 1,
    ) -> ClientUpload | None:
        """None when the round's budget yields ``k == 0``: a straggler in
        outage transmits nothing (it is never zero-padded into the
        aggregation).  With ``send_h`` the LoRA-projection bits are reserved
        out of the Shannon budget before the top-k entries are counted, so
        the realized payload fits by construction."""
        vocab = self.cfg.vocab_size
        n_samples = int(public_tokens.shape[0])
        if k_override is not None:
            k = int(min(k_override, vocab))
        else:
            reserved = (
                lora_projection_bits(n_samples, self.cfg.lora.rank, value_bits)
                if (send_h and self.cfg.lora is not None)
                else 0
            )
            k = topk_budget(
                channel, vocab_size=vocab, num_samples=n_samples,
                value_bits=value_bits, k_min=k_min, reserved_bits=reserved,
            )
        if k == 0:
            return None
        logits, h = fed_steps.public_logits(
            self.params, self.cfg, public_tokens, last_only=self.last_only
        )
        payload, _ = make_upload_payload(
            self.cfg, self.client_id, n_samples, k,
            send_h=send_h, value_bits=value_bits, snr_db=channel.snr_db,
        )
        return ClientUpload(client_id=self.client_id, sparse=topk_sparsify(logits, k),
                            h=h if send_h else None, payload=payload, k=k)
