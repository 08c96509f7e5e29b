"""The whole-round engine — the port of ``repro/fed/engines/e2e.py``'s
``FusedE2EEngine.run_round``.

The fleet's state is kept as the reference's device fleet store keeps it:
every client's LoRA and optimizer state stacked on a leading
``(num_clients, ...)`` axis on the device, and the frozen backbone either
one shared dict (every client rides the same W') or stacked per client
(each client initialised its own, as with ``pretrain_steps=0``).  A round
gathers the cohort's rows, runs the round function once, and writes the
advanced rows back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client, make_upload_payload
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    _ServerOwnerMixin,
    check_unique_cohort,
    cohort_budgets,
    k_cap_bucket,
)
from repro_torch.lora import merge_lora, split_lora
from repro_torch.optim import AdamWState, adamw_init

__all__ = ["FusedE2EEngine"]


def _shared_backbone(frozens: Sequence[dict]) -> bool:
    """True iff every client's frozen dict holds literally the same tensors."""
    first = frozens[0]
    return all(
        o.keys() == first.keys() and all(o[k] is first[k] for k in first) for o in frozens[1:]
    )


class FusedE2EEngine(_ServerOwnerMixin):
    """Client phase and server phase of a round as one function call, with
    the uplink crossing to the server as the sparse wire."""

    name = "fused_e2e"
    store_kind = "device"

    def __init__(
        self,
        clients: list[Client],
        cfg: ModelConfig,
        *,
        server,
        num_classes: int,
        lr: float = 1e-3,
        distill_lr: float = 1e-3,
        temperature: float = 2.0,
        lam: float = 0.03,
        local_steps: int = 4,
        distill_steps: int = 2,
        server_distill_steps: int = 12,
        aggregation: str = "adaptive",
        restrict_to_support: bool = False,
        value_bits: int = 16,
        k_min: int = 1,
        last_only: bool = True,
        use_kernels: bool = False,
        quantize_wire: bool = False,
    ):
        self.clients = clients
        self.cfg = cfg
        self.local_steps = local_steps
        self.value_bits = value_bits
        self.k_min = k_min
        self.quantize_wire = quantize_wire
        loras, frozens = zip(*(split_lora(c.params) for c in clients))
        self._shared = _shared_backbone(frozens)
        self._lora = {k: torch.stack([lo[k] for lo in loras]) for k in loras[0]}
        self._frozen = (
            frozens[0] if self._shared
            else {k: torch.stack([f[k] for f in frozens]) for k in frozens[0]}
        )
        del loras, frozens
        for c in clients:  # the engine owns the fleet state from here on
            c.params = None
        self._opt = adamw_init(self._lora, state_dtype=cfg.optimizer_state_dtype)
        self._fn_kwargs = dict(
            lr=lr, distill_lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, local_steps=local_steps,
            distill_steps=distill_steps, server_distill_steps=server_distill_steps,
            aggregation=aggregation, last_only=last_only, use_kernels=use_kernels,
            quantize=quantize_wire,
        )
        self._num_classes = num_classes
        self._init_server_state(server)

    @property
    def device(self) -> torch.device:
        return next(iter(self._lora.values())).device

    def client_params(self, cid: int) -> dict:
        """One client's merged parameters (for evaluation)."""
        lora = {k: v[cid] for k, v in self._lora.items()}
        frozen = self._frozen if self._shared else {k: v[cid] for k, v in self._frozen.items()}
        return merge_lora(lora, frozen)

    def _stacked_batches(self, cohort) -> dict:
        """Each client's next ``local_steps`` private batches from its own rng,
        stacked client-major: ``{tokens (C, S, B, L), labels (C, S, B)}``."""
        per_client = [c.next_train_batches(self.local_steps) for c in cohort]
        return {
            key: torch.as_tensor(
                np.stack([np.stack([b[s][key] for s in range(self.local_steps)])
                          for b in per_client]),
                device=self.device,
            )
            for key in per_client[0][0]
        }

    def _upload_manifests(self, cohort, states, ks, n_samples: int, send_h: bool):
        """(active indices, payload manifests) for the k > 0 transmitters."""
        active = [i for i, k in enumerate(ks) if k > 0]
        payloads = [
            make_upload_payload(
                self.cfg, cohort[i].client_id, n_samples, ks[i], send_h=send_h,
                value_bits=self.value_bits, snr_db=states[i].snr_db,
                quantize=self.quantize_wire,
            )[0]
            for i in active
        ]
        return active, payloads

    def run_round(
        self,
        sel: Sequence[int],
        pub_tokens: torch.Tensor,
        bcast: BroadcastState | None,
        states: BatchedChannelState | Sequence[ChannelState],
        *,
        adaptive_k: bool,
        send_h: bool,
    ) -> ClientPhase:
        sel = check_unique_cohort(sel)
        cohort = [self.clients[i] for i in sel]
        states = list(states)
        batches = self._stacked_batches(cohort)
        idx = torch.as_tensor(sel, device=self.device)
        lora = {k: v[idx] for k, v in self._lora.items()}
        opt = AdamWState(
            m={k: v[idx] for k, v in self._opt.m.items()},
            v={k: v[idx] for k, v in self._opt.v.items()},
            count=self._opt.count[idx],
        )
        frozen = self._frozen if self._shared else {k: v[idx] for k, v in self._frozen.items()}
        n_samples = int(pub_tokens.shape[0])
        ks = cohort_budgets(
            states, self.cfg, n_samples, adaptive_k, len(cohort), send_h,
            value_bits=self.value_bits, k_min=self.k_min, quantize_wire=self.quantize_wire,
        )
        k_cap = k_cap_bucket(ks, self.cfg.vocab_size)
        if bcast is not None:
            g_tokens, g_logits, g_h, g_valid = bcast.tokens, bcast.logits, bcast.h, True
        else:
            (g_tokens, g_logits, g_h), g_valid = self._cold_broadcast(pub_tokens, n_samples), False

        fn = fed_steps.make_fused_e2e_round_fn(
            self.cfg, self.server.cfg, self._num_classes, k_cap=k_cap, send_h=send_h,
            **self._fn_kwargs,
        )
        (lora, opt, self._s_lora, self._s_opt, wire, b_logits, b_h, self._d_loss) = fn(
            lora, frozen, opt, self._s_lora, self._s_frozen, self._s_opt,
            g_tokens, g_logits, g_h, g_valid, batches, pub_tokens, ks,
        )
        self._b_tokens, self._b_logits, self._b_h = pub_tokens, b_logits, b_h

        active, payloads = self._upload_manifests(cohort, states, ks, n_samples, send_h)
        sparse = None
        if active:
            take = torch.as_tensor(active, device=self.device)
            fields = {f: getattr(wire, f)[take] for f in wire._fields if f != "vocab"}
            sparse = type(wire)(vocab=wire.vocab, **fields)
        # write the advanced cohort rows back into the fleet
        for k in self._lora:
            self._lora[k][idx] = lora[k]
        for full, new in ((self._opt.m, opt.m), (self._opt.v, opt.v)):
            for k in full:
                full[k][idx] = new[k]
        self._opt.count[idx] = opt.count
        return ClientPhase(payloads=payloads, ks=ks, sparse=sparse)

