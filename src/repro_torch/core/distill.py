"""Distillation losses (paper §III-B, eqs. 9-10) — the port of
``repro/core/distill.py``'s cached-teacher form.

    L_logits = mean_x KL( softmax(K_g(x)/T) || softmax(K_n(x)/T) )   (eq. 9)
    L_total  = L_logits + λ · KL over the LoRA projections h = A·x   (eq. 10)

Within a round the teacher is a constant, so its log-softmax is computed
once (:func:`teacher_log_probs`) and reused by every client and step.  The
λ-term is assembled by the round's loss (``repro_torch.fed.steps``).
"""

from __future__ import annotations

import torch

__all__ = ["teacher_log_probs", "kl_rows", "kl_divergence_from_log_probs"]

DEFAULT_TEMPERATURE = 2.0
_NEG = -1e30


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    return x - torch.logsumexp(x, dim=-1, keepdim=True)


def teacher_log_probs(
    logits: torch.Tensor,
    temperature: float = DEFAULT_TEMPERATURE,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``log σ(t/T)`` of the teacher; ``mask`` restricts it to a support."""
    t = logits / temperature
    if mask is not None:
        t = torch.where(mask, t, _NEG)
    return _log_softmax(t)


def kl_rows(
    teacher_log_p: torch.Tensor,
    student_logits: torch.Tensor,
    temperature: float = DEFAULT_TEMPERATURE,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row ``KL(p_teacher || σ(s/T))`` over the last axis (no T²)."""
    s = student_logits / temperature
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    log_q = _log_softmax(s)
    return torch.sum(torch.exp(teacher_log_p) * (teacher_log_p - log_q), dim=-1)


def kl_divergence_from_log_probs(
    teacher_log_p: torch.Tensor,
    student_logits: torch.Tensor,
    temperature: float = DEFAULT_TEMPERATURE,
    *,
    mask: torch.Tensor | None = None,
    scale_by_t2: bool = True,
) -> torch.Tensor:
    """Mean over all leading axes of :func:`kl_rows`, times T² (Hinton's
    gradient-scale correction) unless ``scale_by_t2=False``."""
    kl = kl_rows(teacher_log_p, student_logits, temperature, mask=mask).mean()
    return kl * (temperature**2) if scale_by_t2 else kl
