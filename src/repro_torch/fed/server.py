"""FL server: dense logit aggregation, LLM distillation and the broadcast
(Algorithm 1, server block: lines 1-2, 13-16) — the port of
``repro/fed/server.py``.

The ``sequential``, ``batched`` and ``fused`` engines hand the round loop a
dense stack of the transmitters' top-k masks, which the server aggregates
(:meth:`Server.aggregate_dense`), distills into its LLM
(:meth:`Server.distill`) and answers with a refreshed broadcast
(:meth:`Server.broadcast`).  The ``fused_e2e`` engine runs the same work
inside its round and only keeps the parameters here for evaluation.  A
caller holding a sparse wire outside a round aggregates it with
:meth:`Server.aggregate_sparse_wire`, which can gate it first
(``validate=True``: the corrupted rows quarantined).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregation import AggregationMode, aggregate, aggregate_wire
from repro_torch.core.faults import quarantine_wire, validate_wire
from repro_torch.core.protocol import downlink_bits
from repro_torch.core.topk import QuantizedWire, SparseWire, densify
from repro_torch.fed import steps as fed_steps
from repro_torch.fed.client import ClientUpload
from repro_torch.models import model as model_lib

__all__ = ["Server"]


class Server:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        seed: int = 42,
        distill_lr: float = 1e-3,
        temperature: float = 2.0,
        lam: float = 0.03,
        aggregation: AggregationMode = "adaptive",
        distill_steps: int = 2,
        use_kernels: bool = False,
        restrict_to_support: bool = False,
        last_only: bool = True,
        device: str | torch.device = "cuda",
        initial_params: dict | None = None,
    ):
        self.cfg = cfg
        self.aggregation: AggregationMode = aggregation
        self.distill_steps = distill_steps
        self.use_kernels = use_kernels
        self.last_only = last_only
        self.params = (
            initial_params if initial_params is not None else model_lib.init(cfg, seed, device)
        )
        self.opt = fed_steps.init_lora_opt(self.params, cfg)  # a client axis of 1
        self._distill_step = None  # made by the first distill
        self._distill_kwargs = dict(lr=distill_lr, temperature=temperature, lam=lam,
                                    restrict_to_support=restrict_to_support, last_only=last_only)

    # ---- Algorithm 1, line 15: aggregate client knowledge ----
    def aggregate_uploads(
        self, uploads: list[ClientUpload]
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(K_g (P, V), h_g (P, r) or None)`` from the transmitters'
        uploads, densified and stacked in order."""
        stack = torch.stack([densify(u.sparse) for u in uploads])  # (N, P, V)
        hs = [u.h for u in uploads if u.h is not None]
        return self.aggregate_dense(stack, torch.stack(hs) if hs else None)

    def aggregate_dense(
        self,
        stack: torch.Tensor,
        h_stack: torch.Tensor | None = None,
        *,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Aggregate the transmitters' dense ``(N, P, V)`` top-k stack (and
        their ``(N, P, r)`` projections: ``h_g`` is their mean).  Dropped
        stragglers are never in the stack; ``mask`` is the optional explicit
        transmit mask (else the ``!= 0`` sentinel)."""
        k_g = aggregate(stack, self.aggregation, mask=mask, use_kernel=self.use_kernels)
        h_g = torch.mean(h_stack, dim=0) if h_stack is not None else None
        return k_g, h_g

    def aggregate_sparse_wire(
        self,
        wire: SparseWire | QuantizedWire,
        h_stack: torch.Tensor | None = None,
        *,
        validate: bool = False,
        budget_bits=None,
        value_bits: int = 16,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Aggregate straight from the sparse wire (float or int8), with no
        dense stack: the wire scatter kernels (1 and 2) under
        ``use_kernels``.  ``validate=True`` runs the server-side integrity
        gate first (:func:`repro_torch.core.faults.validate_wire`:
        non-finite values, out-of-range indices and, with ``budget_bits``,
        fits-violating byte counts) and quarantines the offending rows
        through the transmit mask; their ``h`` rows leave the projection
        mean too."""
        if validate:
            ok, _reasons = validate_wire(wire, value_bits=value_bits, budget_bits=budget_bits)
            if not bool(np.all(ok)):
                wire = quarantine_wire(wire, ok)
                if h_stack is not None:
                    keep = np.flatnonzero(ok)
                    h_stack = (h_stack[torch.as_tensor(keep, device=h_stack.device)]
                               if len(keep) else None)
        k_g = aggregate_wire(wire, self.aggregation, use_kernel=self.use_kernels)
        h_g = torch.mean(h_stack, dim=0) if h_stack is not None else None
        return k_g, h_g

    # ---- Algorithm 1, line 16: update the LLM by distilling K_g, h_g ----
    def distill(self, public_tokens: torch.Tensor, k_g: torch.Tensor, h_g) -> dict:
        if self._distill_step is None:
            self._distill_step = fed_steps.make_distill_step(self.cfg, **self._distill_kwargs)
        metrics = {}
        for _ in range(self.distill_steps):
            self.params, self.opt, metrics = self._distill_step(
                self.params, self.opt, public_tokens, k_g, h_g
            )
        return {k: float(v) for k, v in metrics.items()}

    # ---- §II-B: broadcast the server's own refreshed knowledge ----
    def broadcast(self, public_tokens: torch.Tensor):
        """``(K_down (P, V), h_down (P, r) or None, downlink_bits)``: the
        server re-infers the public batch after its distillation update."""
        logits, h = fed_steps.public_logits(
            self.params, self.cfg, public_tokens, last_only=self.last_only
        )
        rank = self.cfg.lora.rank if (self.cfg.lora is not None and h is not None) else None
        return logits, h, downlink_bits(int(logits.shape[0]), int(logits.shape[-1]), rank)
