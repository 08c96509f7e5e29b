"""The whole-round engine — the port of ``repro/fed/engines/e2e.py``'s
``FusedE2EEngine.run_round``.

The fleet's state lives in the engines' device fleet store; a round
gathers the cohort's rows, runs the client phase and the server phase as
one function call with the sparse wire between them, and writes the
advanced rows back.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import BatchedChannelState, ChannelState
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import Client
from repro_torch.fed.engines.base import (
    BroadcastState,
    ClientPhase,
    _ServerOwnerMixin,
    check_unique_cohort,
    k_cap_bucket,
)
from repro_torch.fed.engines.batched import _FleetEngine

__all__ = ["FusedE2EEngine"]


class FusedE2EEngine(_ServerOwnerMixin, _FleetEngine):
    """Client phase and server phase of a round as one function call, with
    the uplink crossing to the server as the sparse wire."""

    name = "fused_e2e"

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
        compute_dtype: str = "float32",
    ):
        super().__init__(clients, cfg, local_steps=local_steps, value_bits=value_bits,
                         k_min=k_min, last_only=last_only, quantize_wire=quantize_wire)
        self._fn_kwargs = dict(
            lr=lr, distill_lr=distill_lr, temperature=temperature, lam=lam,
            restrict_to_support=restrict_to_support, local_steps=local_steps,
            distill_steps=distill_steps, server_distill_steps=server_distill_steps,
            aggregation=aggregation, last_only=last_only, use_kernels=use_kernels,
            quantize=quantize_wire, compute_dtype=compute_dtype,
        )
        self._num_classes = num_classes
        self._init_server_state(server)

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
        batches = self._stacked_batches(cohort, step_major=False)  # (C, S, ...)
        idx, lora, frozen, opt = self._store.fetch(sel)
        n_samples = int(pub_tokens.shape[0])
        ks = self._budgets(states, n_samples, adaptive_k, len(cohort), send_h)
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

        active, payloads, _rank = self._upload_manifests(cohort, states, ks, n_samples, send_h)
        sparse = None
        if active:
            take = torch.as_tensor(active, device=self.device)
            fields = {f: getattr(wire, f)[take] for f in wire._fields if f != "vocab"}
            sparse = type(wire)(vocab=wire.vocab, **fields)
        self._store.commit(idx, lora, opt)
        return ClientPhase(payloads=payloads, ks=ks, sparse=sparse)

