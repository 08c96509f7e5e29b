"""Round step functions (Algorithm 1) — the port of ``repro/fed/steps.py``
for the four engines and the server.

Task convention (paper §IV): class logits are the LM-head logits over the
first ``num_classes`` vocab ids at the LAST position; distillation works on
the full last-position vocab logits.  Only the LoRA group trains.

Where the reference vmaps one client's round body over the cohort, every
function here runs the cohort at once on a leading client axis: LoRA leaves
and optimizer state are ``(C, ...)``, the backbone is shared or ``(C, ...)``.
A step's loss is the SUM of the per-client losses, so one ``backward`` gives
each client exactly its own gradient; AdamW then clips per client.  A single
model (a sequential-engine client, the server) is a client axis of 1.
``lax.scan``/``fori_loop`` are Python loops, and the two data-dependent
round decisions of the reference (cold server in round 0, a round where
every client dropped) are host-side values here, so they are plain
branches that skip the work the reference computes and discards.

``compute_dtype`` (the fused engines' round body) casts the float
parameters to it inside every differentiated loss, as the reference's
``_cast_params`` does: the LoRA leaves and their AdamW state stay fp32
masters, and the cast's backward hands AdamW fp32 gradients.  The model
then computes in its own ``ModelConfig.compute_dtype``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregation import AggregationMode, aggregate_wire
from repro_torch.core.distill import kl_rows, teacher_log_probs, total_distill_loss
from repro_torch.core.topk import sparsify_wire, topk_mask_dynamic
from repro_torch.lora import merge_lora, split_lora
from repro_torch.models import forward
from repro_torch.optim import AdamWState, adamw_init, adamw_update

__all__ = [
    "EVAL_BATCH",
    "class_logits",
    "last_logits",
    "public_logits",
    "init_lora_opt",
    "make_finetune_step",
    "make_distill_step",
    "make_batched_finetune_step",
    "make_batched_distill_step",
    "make_batched_public_logits",
    "make_fused_round_fn",
    "make_bucket_client_phase_fn",
    "make_server_phase_fn",
    "make_fused_e2e_round_fn",
    "make_eval_fn",
    "make_scan_eval_fn",
    "make_channel_step_fn",
]

# Eval batch size: make_eval_fn and the in-block eval tap walk whole batches
# and drop the rest.
EVAL_BATCH = 64


def class_logits(logits_last: torch.Tensor, num_classes: int) -> torch.Tensor:
    return logits_last[..., :num_classes]


def last_logits(params, cfg: ModelConfig, tokens: torch.Tensor, *, last_only: bool = True,
                head_cols: int | None = None):
    """``(C, B, V)`` last-position logits + Aux.  ``last_only=False`` keeps
    the full-sequence head and slices it (``head_cols`` ignored there, as
    in the reference)."""
    if last_only:
        return forward(params, cfg, tokens, last_only=True, head_cols=head_cols)
    logits, aux = forward(params, cfg, tokens)
    return logits[:, :, -1], aux


def _cast_params(params: dict, compute_dtype: str) -> dict:
    """The float parameters cast to ``compute_dtype``; the identity (the
    same dict, no graph change) for float32."""
    if compute_dtype == "float32":
        return params
    dt = getattr(torch, compute_dtype)
    return {k: v.to(dt) if v.is_floating_point() else v for k, v in params.items()}


def _per_client_tokens(tokens: torch.Tensor, c: int) -> torch.Tensor:
    """One ``(P, L)`` batch shared by the whole cohort -> ``(C, P, L)``."""
    return tokens.expand((c,) + tuple(tokens.shape))


def _grads(loss_fn: Callable, lora: dict, *args):
    """``(per-client losses (C,), grads)`` of ``loss_fn(lora, *args)``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in lora.items()}
    with torch.enable_grad():
        losses = loss_fn(leaves, *args)
        # an adapter no layer reads (LoRA on ``o``: no layer applies it, as in
        # the reference) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return losses.detach(), dict(zip(leaves, grads))


def _finetune_loss_fn(cfg: ModelConfig, num_classes: int, last_only: bool = True,
                      compute_dtype: str = "float32") -> Callable:
    """loss(lora, frozen, tokens (C,B,L), labels (C,B)) -> per-client NLL plus
    0.01 times the MoE load-balance loss (C,); the LM head computes only the
    ``num_classes`` columns the loss reads."""

    def loss_fn(lora, frozen, tokens, labels):
        last, aux = last_logits(
            _cast_params(merge_lora(lora, frozen), compute_dtype), cfg, tokens,
            last_only=last_only,
            head_cols=num_classes if last_only else None,
        )
        logp = torch.log_softmax(class_logits(last, num_classes).float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean(dim=-1)
        return nll + 0.01 * aux.moe_aux

    return loss_fn


def _distill_loss_fn(cfg: ModelConfig, temperature: float, lam: float,
                     restrict_to_support: bool, last_only: bool = True,
                     compute_dtype: str = "float32") -> Callable:
    """loss(lora, frozen, tokens (C,P,L), g_logits (P,V), g_h (P,r)|None) ->
    (C,) eq. 10 per client through :func:`total_distill_loss`, the teacher
    softmaxed anew for each client (the reference's uncached form), plus
    0.01 times the MoE load-balance loss."""
    use_h = cfg.lora is not None

    def loss_fn(lora, frozen, tokens, g_logits, g_h):
        own, aux = last_logits(_cast_params(merge_lora(lora, frozen), compute_dtype), cfg, tokens,
                               last_only=last_only)
        return torch.stack([
            total_distill_loss(
                g_logits, own[i], g_h if use_h else None,
                aux.lora_h[i] if (use_h and aux.lora_h is not None) else None,
                temperature=temperature, lam=lam, restrict_to_support=restrict_to_support,
            )[0]
            for i in range(own.shape[0])
        ]) + 0.01 * aux.moe_aux

    return loss_fn


def _distill_loss_cached_fn(cfg: ModelConfig, temperature: float, lam: float,
                            last_only: bool = True, compute_dtype: str = "float32") -> Callable:
    """loss(lora, frozen, tokens, t_logp, th_logp, support) -> (C,) eq. 10
    with the teacher log-probs precomputed once per round, plus 0.01 times
    the MoE load-balance loss."""
    use_h = cfg.lora is not None

    def loss_fn(lora, frozen, tokens, t_logp, th_logp, support):
        own, aux = last_logits(_cast_params(merge_lora(lora, frozen), compute_dtype), cfg, tokens,
                               last_only=last_only)
        t2 = temperature**2
        loss = kl_rows(t_logp, own, temperature, mask=support).mean(dim=-1) * t2
        if use_h and th_logp is not None:
            loss = loss + lam * kl_rows(th_logp, aux.lora_h, temperature).mean(dim=-1) * t2
        return loss + 0.01 * aux.moe_aux

    return loss_fn


def _teacher_cache_fn(temperature: float, restrict_to_support: bool, use_h: bool) -> Callable:
    """teacher_cache(logits, h) -> (t_logp, th_logp, support): a round's
    teacher softmaxed once for every consumer."""

    def teacher_cache(logits, h):
        support = (logits != 0) if restrict_to_support else None
        t_logp = teacher_log_probs(logits, temperature, mask=support)
        th_logp = teacher_log_probs(h, temperature) if (use_h and h is not None) else None
        return t_logp, th_logp, support

    return teacher_cache


def _client_round_core(cfg: ModelConfig, num_classes: int, *, lr: float, weight_decay: float,
                       distill_lr: float, temperature: float, lam: float,
                       restrict_to_support: bool, local_steps: int, distill_steps: int,
                       last_only: bool, kd_loss: Callable | None = None,
                       compute_dtype: str = "float32") -> Callable:
    """The cohort's round body: ``distill_steps`` distillation updates
    (skipped when ``g_valid`` is False — the cold server of round 0),
    ``local_steps`` supervised updates, public last-position inference.

    ``kd_loss`` is called as ``kd_loss(lora, frozen, g_tokens, *kd_args)``
    with the teacher tuple the caller threads through; the default is the
    uncached :func:`_distill_loss_fn` on ``(g_logits, g_h)``."""
    ft_loss = _finetune_loss_fn(cfg, num_classes, last_only, compute_dtype)
    if kd_loss is None:
        kd_loss = _distill_loss_fn(cfg, temperature, lam, restrict_to_support, last_only,
                                   compute_dtype)

    def client_round(lora, frozen, opt, g_tokens, kd_args, g_valid: bool, batches, pub_tokens):
        c = next(iter(lora.values())).shape[0]
        # -- lines 5-7: local distillation against the broadcast knowledge --
        if g_valid:
            g_tok = _per_client_tokens(g_tokens, c)
            for _ in range(distill_steps):
                _, grads = _grads(kd_loss, lora, frozen, g_tok, *kd_args)
                lora, opt = adamw_update(grads, opt, lora, lr=distill_lr)
        # -- line 8: local fine-tuning --
        for s in range(local_steps):
            _, grads = _grads(ft_loss, lora, frozen, batches["tokens"][:, s], batches["labels"][:, s])
            lora, opt = adamw_update(grads, opt, lora, lr=lr, weight_decay=weight_decay)
        # -- line 9: public last-position inference --
        with torch.no_grad():
            last, aux = last_logits(_cast_params(merge_lora(lora, frozen), compute_dtype), cfg,
                                    _per_client_tokens(pub_tokens, c), last_only=last_only)
        return lora, opt, last, aux.lora_h

    return client_round


def public_logits(params, cfg: ModelConfig, tokens: torch.Tensor, *, last_only: bool = True):
    """One model's last-position vocab logits ``(B, V)`` and pooled LoRA
    projection ``(B, r)`` or None on a public batch ``(B, L)``."""
    with torch.no_grad():
        last, aux = last_logits(params, cfg, tokens[None], last_only=last_only)
    return last[0], None if aux.lora_h is None else aux.lora_h[0]


def init_lora_opt(params, cfg: ModelConfig) -> AdamWState:
    """AdamW state for one model's LoRA group, on a client axis of 1."""
    lora, _ = split_lora(params)
    return adamw_init({k: v[None] for k, v in lora.items()}, state_dtype=cfg.optimizer_state_dtype)


def make_batched_finetune_step(cfg: ModelConfig, num_classes: int, *, lr: float = 1e-3,
                               weight_decay: float = 1e-3, last_only: bool = True) -> Callable:
    """One fine-tune update for a whole cohort (paper eq. 2, LoRA only).

    step(lora (C,...), frozen, opt (C,...), batch {tokens (C,B,L), labels (C,B)})
    -> (lora, opt, {"loss": (C,)})"""
    loss_fn = _finetune_loss_fn(cfg, num_classes, last_only)

    def step(lora, frozen, opt, batch):
        losses, grads = _grads(loss_fn, lora, frozen, batch["tokens"], batch["labels"])
        lora, opt = adamw_update(grads, opt, lora, lr=lr, weight_decay=weight_decay)
        return lora, opt, {"loss": losses}

    return step


def make_batched_distill_step(cfg: ModelConfig, *, lr: float = 1e-3, temperature: float = 2.0,
                              lam: float = 0.03, restrict_to_support: bool = False,
                              last_only: bool = True) -> Callable:
    """Cohort distillation against one broadcast teacher (Algorithm 1 lines
    5-7): every client distills on the same public tokens and ``{K_g, h_g}``.

    step(lora (C,...), frozen, opt (C,...), tokens (P,L), g_logits (P,V), g_h)
    -> (lora, opt, {"loss": (C,)}); ``g_h`` None drops the λ-term."""
    loss_fn = _distill_loss_fn(cfg, temperature, lam, restrict_to_support, last_only)

    def step(lora, frozen, opt, tokens, g_logits, g_h):
        c = next(iter(lora.values())).shape[0]
        losses, grads = _grads(loss_fn, lora, frozen, _per_client_tokens(tokens, c), g_logits, g_h)
        lora, opt = adamw_update(grads, opt, lora, lr=lr)
        return lora, opt, {"loss": losses}

    return step


def _single(batched_step: Callable) -> Callable:
    """A cohort step run for one model on a client axis of 1:
    ``step(params, opt, *args) -> (params, opt, metrics)``, with ``opt``
    from :func:`init_lora_opt` and scalar metrics."""

    def step(params, opt, *args):
        lora, frozen = split_lora(params)
        lora, opt, metrics = batched_step({k: v[None] for k, v in lora.items()}, frozen, opt,
                                          *args)
        params = merge_lora({k: v[0] for k, v in lora.items()}, frozen)
        return params, opt, {k: v[0] for k, v in metrics.items()}

    return step


def make_finetune_step(cfg: ModelConfig, num_classes: int, *, lr: float = 1e-3,
                       weight_decay: float = 1e-3, last_only: bool = True) -> Callable:
    """One model's supervised fine-tuning update (paper eq. 2, LoRA only) —
    a sequential-engine client's Algorithm 1 line 8.

    step(params, opt (from :func:`init_lora_opt`), batch {tokens (B,L), labels (B,)})
    -> (params, opt, {"loss": ()})"""
    batched = _single(make_batched_finetune_step(cfg, num_classes, lr=lr,
                                                 weight_decay=weight_decay, last_only=last_only))

    def step(params, opt, batch):
        return batched(params, opt, {k: v[None] for k, v in batch.items()})

    return step


def make_distill_step(cfg: ModelConfig, *, lr: float = 1e-3, temperature: float = 2.0,
                      lam: float = 0.03, restrict_to_support: bool = False,
                      last_only: bool = True) -> Callable:
    """One model's distillation update against teacher knowledge (Algorithm
    1 lines 5-7 for a sequential-engine client, line 16 for the server),
    the cohort step on a client axis of 1.

    step(params, opt (from :func:`init_lora_opt`), tokens (P,L), g_logits, g_h)
    -> (params, opt, {"loss": ()})"""
    return _single(make_batched_distill_step(cfg, lr=lr, temperature=temperature, lam=lam,
                                             restrict_to_support=restrict_to_support,
                                             last_only=last_only))


def make_batched_public_logits(cfg: ModelConfig, *, last_only: bool = True) -> Callable:
    """Cohort public-set inference (Algorithm 1 line 9): (lora (C,...),
    frozen, tokens (P,L)) -> (logits (C,P,V), h (C,P,r) or None)."""

    @torch.no_grad()
    def public(lora, frozen, tokens):
        c = next(iter(lora.values())).shape[0]
        last, aux = last_logits(merge_lora(lora, frozen), cfg, _per_client_tokens(tokens, c),
                                last_only=last_only)
        return last, aux.lora_h

    return public


def make_fused_round_fn(
    cfg: ModelConfig,
    num_classes: int,
    *,
    lr: float = 1e-3,
    weight_decay: float = 1e-3,
    distill_lr: float = 1e-3,
    temperature: float = 2.0,
    lam: float = 0.03,
    restrict_to_support: bool = False,
    local_steps: int = 4,
    distill_steps: int = 2,
    last_only: bool = True,
    use_kernels: bool = False,
    compute_dtype: str = "float32",
) -> Callable:
    """The whole client phase of Algorithm 1 (lines 5-11) as one function.

    fn(lora (C,...), frozen, opt (C,...), g_tokens (P,L), g_logits (P,V),
       g_h (P,r)|None, batches {tokens (C,S,B,L), labels (C,S,B)},
       pub_tokens (P,L), ks [C ints], shard=None)
    -> (lora, opt, dense (C,P,V), h (C,P,r)|None)

    ``distill_steps`` distillation updates, ``local_steps``
    supervised updates and the public inference, then the per-client
    adaptive top-k with one budget per client row: the bisection CUDA
    kernel (:func:`repro_torch.kernels.ops.topk_mask_dynamic`) with
    ``use_kernels``, else :func:`repro_torch.core.topk.topk_mask_dynamic` —
    the same threshold (ties-kept) semantics.  ``distill_steps=0`` builds
    the cold round (no broadcast exists yet; the g_* operands are unused).
    ``compute_dtype`` is the round body's (see the module docstring).

    ``shard`` (a :class:`repro_torch.sharding.CohortShard`, ``None`` for
    the unsharded call) runs the phase on this rank's block of the padded
    cohort: ``lora``, ``frozen`` (per-client backbones), ``opt`` and
    ``batches`` are the block's rows, ``ks`` the real cohort's budgets (a
    pad row's is 0).  The block's outputs are then gathered, the pad rows
    dropped, and the function returns the real cohort's, as unsharded."""
    client_round = _client_round_core(
        cfg, num_classes, lr=lr, weight_decay=weight_decay, distill_lr=distill_lr,
        temperature=temperature, lam=lam, restrict_to_support=restrict_to_support,
        local_steps=local_steps, distill_steps=distill_steps, last_only=last_only,
        compute_dtype=compute_dtype,
    )

    def fn(lora, frozen, opt, g_tokens, g_logits, g_h, batches, pub_tokens, ks, shard=None):
        lora, opt, last, h = client_round(
            lora, frozen, opt, g_tokens, (g_logits, g_h), True, batches, pub_tokens
        )
        # -- line 10: adaptive top-k over the (C·P, V) rows, one budget per client --
        kk = torch.as_tensor(ks, dtype=torch.int32, device=last.device)
        if shard is not None:
            kk = shard.block_ks(kk)
        kk = kk[:, None]
        if use_kernels:
            from repro_torch.kernels import ops as kops

            rows_k = kk.expand(last.shape[:-1]).contiguous()
            dense = kops.topk_mask_dynamic(last.contiguous(), rows_k)
        else:
            dense = topk_mask_dynamic(last, kk)
        if shard is not None:  # the reference's shard_map ends here
            lora, opt, dense, h = shard.gather((lora, opt, dense, h))
        return lora, opt, dense, h

    return fn


def make_server_phase_fn(
    server_cfg: ModelConfig,
    *,
    distill_lr: float = 1e-3,
    temperature: float = 2.0,
    lam: float = 0.03,
    restrict_to_support: bool = False,
    server_distill_steps: int = 12,
    aggregation: AggregationMode = "adaptive",
    send_h: bool = True,
    last_only: bool = True,
    use_kernels: bool = False,
    compute_dtype: str = "float32",
) -> Callable:
    """The server phase of one round (Algorithm 1 lines 13-16 + the next
    broadcast), reading the cohort's wire.

    fn(s_lora (1,...), s_frozen, s_opt, wire, h (N,P,r)|None, ks, pub_tokens (P,L),
       ks_dev=None)
    -> (s_lora, s_opt, b_logits (P,V), b_h (P,r)|None, d_loss)

    ``ks`` are the host's ints, which decide the branches; ``ks_dev`` the
    same budgets as an int32 device tensor (made from ``ks`` when None), of
    which the transmit mask is made on the device.  The aggregation runs
    every round.  When every client dropped (all ``ks == 0``) the server
    does not distill and ``d_loss`` is a NaN on the device; the broadcast
    still refreshes on the current public batch."""
    kd_loss = _distill_loss_cached_fn(server_cfg, temperature, lam, last_only, compute_dtype)
    teacher_cache = _teacher_cache_fn(temperature, restrict_to_support, True)

    def fn(s_lora, s_frozen, s_opt, wire, h, ks: Sequence[int], pub_tokens, ks_dev=None):
        n_tx = sum(1 for k in ks if k > 0)
        # -- line 15: aggregation from the wire (eqs. 6-7) --
        k_g = aggregate_wire(wire, aggregation, num_transmitters=n_tx, use_kernel=use_kernels)
        h_g = None
        if send_h and h is not None:
            if ks_dev is None:
                ks_dev = torch.as_tensor(ks, dtype=torch.int32, device=h.device)
            tx = (ks_dev > 0).to(h.dtype)
            h_g = torch.sum(h * tx[:, None, None], dim=0) / max(n_tx, 1)
        # -- line 16: server distillation against the teacher softmaxed once --
        d_loss = torch.full((), float("nan"), device=pub_tokens.device)
        if n_tx > 0:
            kg_logp, kg_h_logp, kg_support = teacher_cache(k_g, h_g)
            tokens = _per_client_tokens(pub_tokens, 1)
            for _ in range(server_distill_steps):
                losses, grads = _grads(kd_loss, s_lora, s_frozen, tokens, kg_logp,
                                       kg_h_logp, kg_support)
                s_lora, s_opt = adamw_update(grads, s_opt, s_lora, lr=distill_lr)
                d_loss = losses[0]
        # -- lines 1-2 of the NEXT round: refreshed broadcast knowledge --
        with torch.no_grad():
            b_last, b_aux = last_logits(_cast_params(merge_lora(s_lora, s_frozen), compute_dtype),
                                        server_cfg, _per_client_tokens(pub_tokens, 1),
                                        last_only=last_only)
        b_h = None if b_aux.lora_h is None else b_aux.lora_h[0]
        return s_lora, s_opt, b_last[0], b_h, d_loss

    return fn


def make_bucket_client_phase_fn(
    cfg: ModelConfig,
    num_classes: int,
    *,
    k_cap: int,
    lr: float = 1e-3,
    weight_decay: float = 1e-3,
    distill_lr: float = 1e-3,
    temperature: float = 2.0,
    lam: float = 0.03,
    restrict_to_support: bool = False,
    local_steps: int = 4,
    distill_steps: int = 2,
    last_only: bool = True,
    quantize: bool = False,
    compute_dtype: str = "float32",
) -> Callable:
    """The client phase of a round for a cohort that runs ``cfg`` (the whole
    cohort of ``fused_e2e``, or one family bucket of a mixed fleet's), up
    to the sparse wire.

    fn(lora (C,...), frozen, opt (C,...), g_tokens (P,L), g_logits (P,V),
       g_h (P,r)|None, g_valid bool, batches {tokens (C,S,B,L), labels (C,S,B)},
       pub_tokens (P,L), ks_dev (C,) int32, shard=None)
    -> (lora, opt, wire (C,P,k_cap), h (C,P,r)|None)

    The broadcast teacher is softmaxed once for the cohort; ``g_valid``
    False (the cold server of round 0) skips the distillation.  The wire is
    int8 with ``quantize``.  ``shard`` (a
    :class:`repro_torch.sharding.CohortShard`, ``None`` unsharded) runs the
    phase on this rank's block of the padded cohort, as
    :func:`make_fused_round_fn` does, with ``ks_dev`` the real cohort's;
    the block's state, wire and projections are gathered and the pad rows
    dropped, so the function returns what the unsharded call returns."""
    client_round = _client_round_core(
        cfg, num_classes, lr=lr, weight_decay=weight_decay, distill_lr=distill_lr,
        temperature=temperature, lam=lam, restrict_to_support=restrict_to_support,
        local_steps=local_steps, distill_steps=distill_steps, last_only=last_only,
        kd_loss=_distill_loss_cached_fn(cfg, temperature, lam, last_only, compute_dtype),
        compute_dtype=compute_dtype,
    )
    teacher_cache = _teacher_cache_fn(temperature, restrict_to_support, cfg.lora is not None)

    def fn(lora, frozen, opt, g_tokens, g_logits, g_h, g_valid, batches, pub_tokens, ks_dev,
           shard=None):
        t_cache = teacher_cache(g_logits, g_h) if g_valid else None
        lora, opt, last, h = client_round(
            lora, frozen, opt, g_tokens, t_cache, g_valid, batches, pub_tokens
        )
        if shard is None:
            wire = sparsify_wire(last, ks_dev, k_cap, quantize=quantize)
        else:  # the block's wire; the reference's shard_map ends here
            wire = sparsify_wire(last, shard.block_ks(ks_dev), k_cap, quantize=quantize)
            lora, opt, wire, h = shard.gather((lora, opt, wire, h))
        return lora, opt, wire, h

    return fn


def make_fused_e2e_round_fn(
    client_cfg: ModelConfig,
    server_cfg: ModelConfig,
    num_classes: int,
    *,
    k_cap: int,
    lr: float = 1e-3,
    weight_decay: float = 1e-3,
    distill_lr: float = 1e-3,
    temperature: float = 2.0,
    lam: float = 0.03,
    restrict_to_support: bool = False,
    local_steps: int = 4,
    distill_steps: int = 2,
    server_distill_steps: int = 12,
    aggregation: AggregationMode = "adaptive",
    send_h: bool = True,
    last_only: bool = True,
    use_kernels: bool = False,
    quantize: bool = False,
    compute_dtype: str = "float32",
) -> Callable:
    """One whole federated round — client phase and server phase.

    fn(lora (C,...), frozen, opt, s_lora, s_frozen, s_opt,
       g_tokens (P,L), g_logits (P,V), g_h (P,r)|None, g_valid bool,
       batches {tokens (C,S,B,L), labels (C,S,B)}, pub_tokens (P,L), ks [C ints],
       ks_dev=None, shard=None)
    -> (lora, opt, s_lora, s_opt, wire (C,P,k_cap), b_logits (P,V),
        b_h (P,r)|None, d_loss)

    The uplink leaves the client phase (:func:`make_bucket_client_phase_fn`)
    as the sparse wire of width ``k_cap`` (int8 with ``quantize``) and is
    aggregated straight from it.  ``ks_dev`` is ``ks`` as an int32 device
    tensor, made here when None: a multi-round block stages it before its
    first launch.  ``compute_dtype`` is the round body's (see the module
    docstring).  ``shard`` splits the client phase over the ranks (see
    :func:`make_bucket_client_phase_fn`); the server phase, replicated on
    every rank, reads exactly the unsharded round's operands."""
    client_phase = make_bucket_client_phase_fn(
        client_cfg, num_classes, k_cap=k_cap, lr=lr, weight_decay=weight_decay,
        distill_lr=distill_lr, temperature=temperature, lam=lam,
        restrict_to_support=restrict_to_support, local_steps=local_steps,
        distill_steps=distill_steps, last_only=last_only, quantize=quantize,
        compute_dtype=compute_dtype,
    )
    server_phase = make_server_phase_fn(
        server_cfg, distill_lr=distill_lr,
        temperature=temperature, lam=lam, restrict_to_support=restrict_to_support,
        server_distill_steps=server_distill_steps, aggregation=aggregation, send_h=send_h,
        last_only=last_only, use_kernels=use_kernels, compute_dtype=compute_dtype,
    )

    def fn(lora, frozen, opt, s_lora, s_frozen, s_opt, g_tokens, g_logits, g_h, g_valid,
           batches, pub_tokens, ks, ks_dev=None, shard=None):
        if ks_dev is None:
            ks_dev = torch.as_tensor(ks, dtype=torch.int32, device=pub_tokens.device)
        lora, opt, wire, h = client_phase(lora, frozen, opt, g_tokens, g_logits, g_h, g_valid,
                                          batches, pub_tokens, ks_dev, shard=shard)
        s_lora, s_opt, b_last, b_h, d_loss = server_phase(
            s_lora, s_frozen, s_opt, wire, h, ks, pub_tokens, ks_dev
        )
        return lora, opt, s_lora, s_opt, wire, b_last, b_h, d_loss

    return fn


def _eval_correct_fn(cfg: ModelConfig, num_classes: int, last_only: bool) -> Callable:
    """correct(params, tokens (B,L), labels (B,)) -> () fp32 count of correct
    last-position class predictions on the device: the one copy of the eval
    math that :func:`make_eval_fn` and :func:`make_scan_eval_fn` share."""

    def correct(params, tokens, labels):
        last, _ = last_logits(
            params, cfg, tokens[None], last_only=last_only,
            head_cols=num_classes if last_only else None,
        )
        pred = torch.argmax(class_logits(last[0], num_classes), dim=-1)
        return torch.sum((pred == labels).float())

    return correct


def make_scan_eval_fn(cfg: ModelConfig, num_classes: int, *, last_only: bool = True) -> Callable:
    """The in-block eval tap of ``run_rounds``:
    acc(lora, frozen, tokens (N,L), labels (N,)) -> () fp32 accuracy of one
    model as a DEVICE scalar (nothing crosses to the host), walking the
    split in ``EVAL_BATCH`` chunks — :func:`make_eval_fn`'s per-sample math.
    ``N`` must be a non-empty multiple of ``EVAL_BATCH``, so that both read
    the same samples."""
    correct = _eval_correct_fn(cfg, num_classes, last_only)

    @torch.no_grad()
    def acc(lora, frozen, tokens, labels):
        params = merge_lora(lora, frozen)
        n = int(labels.shape[0])
        if n == 0 or n % EVAL_BATCH:
            raise ValueError(
                f"eval split must be a non-empty multiple of EVAL_BATCH={EVAL_BATCH}, got {n}"
            )
        total = sum(correct(params, tokens[i:i + EVAL_BATCH], labels[i:i + EVAL_BATCH])
                    for i in range(0, n, EVAL_BATCH))
        return total / n

    return acc


def make_eval_fn(cfg: ModelConfig, num_classes: int, *, last_only: bool = True) -> Callable:
    """evaluate(params, tokens (N,L), labels (N,)) -> accuracy of one model
    over whole ``EVAL_BATCH`` batches (the remainder is dropped), as a host
    float."""
    correct = _eval_correct_fn(cfg, num_classes, last_only)

    @torch.no_grad()
    def evaluate(params, tokens, labels) -> float:
        n = tokens.shape[0]
        total = 0.0
        for i in range(0, n - EVAL_BATCH + 1, EVAL_BATCH):
            total += float(correct(params, tokens[i:i + EVAL_BATCH], labels[i:i + EVAL_BATCH]))
        return total / max(1, (n // EVAL_BATCH) * EVAL_BATCH)

    return evaluate


def make_channel_step_fn() -> Callable:
    """One round of the block's channel dynamics, on the device (the port of
    the reference's in-scan ``repro.core.scenario`` replica).

    channel_step(z, bad, w, u, base_snr_db, rho, p_gb, p_bg, fade_scale)
        -> (z', bad', snr_db)

    The AR(1) fading state ``z`` and the Gilbert-Elliott outage state
    ``bad`` (each ``(N,)``, the whole fleet) evolve from the host's
    precomputed copula normals ``w`` and outage uniforms ``u``
    (:meth:`repro_torch.core.channel.ChannelSimulator.scan_channel_inputs`);
    every scenario parameter is an fp32 tensor operand, so ``rho = 0``
    replays the i.i.d. channel and ``fade_scale = 0`` a fading-free one.
    fp32 tensor math, no host read: the block calls it between launches.
    It is the observability replica of the host's f64 realisation (the
    budgets stay host-side scalar math); the fp32 recursion tracks the f64
    chain to ~1e-2 dB over a block (the AR(1) map is contracting).
    """

    def channel_step(z, bad, w, u, base_snr_db, rho, p_gb, p_bg, fade_scale):
        z = rho * z + torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * w
        u_fade = torch.clamp(torch.special.ndtr(z), 1e-7, 1.0 - 1e-7)
        power = -torch.log1p(-u_fade)
        fade_db = 10.0 * torch.log10(torch.clamp(power, min=1e-6))
        bad = torch.where(bad, u < 1.0 - p_bg, u < p_gb)
        snr_db = torch.where(bad, torch.full_like(z, float("-inf")),
                             base_snr_db + fade_scale * fade_db)
        return z, bad, snr_db

    return channel_step
