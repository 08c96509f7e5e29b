"""Distillation losses (paper §III-B, eqs. 9-10) — the port of
``repro/core/distill.py``.

    L_logits = mean_x KL( softmax(K_g(x)/T) || softmax(K_n(x)/T) )   (eq. 9)
    L_total  = L_logits + λ · KL over the LoRA projections h = A·x   (eq. 10)

Two forms: the uncached losses (:func:`total_distill_loss`), which the
``sequential``, ``batched`` and ``fused`` engines and the server's
distillation use (``use_kernel=True`` reaches the fused KL kernel, forward
only, as in the reference: no engine sets it), and
the cached-teacher form of the ``fused_e2e`` round — within a round the
teacher is a constant, so its log-softmax is computed once
(:func:`teacher_log_probs`) and reused by every client and step.
"""

from __future__ import annotations

import torch

__all__ = [
    "soft_labels",
    "teacher_log_probs",
    "kl_rows",
    "kl_divergence",
    "kl_divergence_from_log_probs",
    "logits_distill_loss",
    "lora_projection_loss",
    "total_distill_loss",
]

DEFAULT_TEMPERATURE = 2.0
DEFAULT_LAMBDA = 0.03
_NEG = -1e30


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    return x - torch.logsumexp(x, dim=-1, keepdim=True)


def soft_labels(logits: torch.Tensor, temperature: float = DEFAULT_TEMPERATURE) -> torch.Tensor:
    """The global soft-label distribution ``σ(K/T)`` (paper §II-B)."""
    return torch.softmax(logits / temperature, dim=-1)


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


def kl_divergence(
    teacher_logits: torch.Tensor,
    student_logits: torch.Tensor,
    temperature: float = DEFAULT_TEMPERATURE,
    *,
    mask: torch.Tensor | None = None,
    scale_by_t2: bool = True,
) -> torch.Tensor:
    """``KL(σ(t/T) || σ(s/T))``, mean over all leading axes, times T²
    unless ``scale_by_t2=False``; ``mask`` drops the entries off a support
    from both distributions."""
    return kl_divergence_from_log_probs(
        teacher_log_probs(teacher_logits, temperature, mask=mask), student_logits,
        temperature, mask=mask, scale_by_t2=scale_by_t2,
    )


def logits_distill_loss(
    global_logits: torch.Tensor,
    client_logits: torch.Tensor,
    temperature: float = DEFAULT_TEMPERATURE,
    *,
    restrict_to_support: bool = False,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Paper eq. 9 over a public batch; ``restrict_to_support`` softmaxes
    over the teacher's non-zero support only.  ``use_kernel`` (without
    ``restrict_to_support``) computes it through the fused KL kernel
    (:func:`repro_torch.kernels.ops.distill_kl`), which is forward only:
    it raises on a student that requires grad."""
    if use_kernel and not restrict_to_support:
        from repro_torch.kernels import ops as kops

        return kops.distill_kl(global_logits, client_logits, temperature)
    mask = (global_logits != 0) if restrict_to_support else None
    return kl_divergence(global_logits, client_logits, temperature, mask=mask)


def lora_projection_loss(
    global_h: torch.Tensor, client_h: torch.Tensor, temperature: float = DEFAULT_TEMPERATURE
) -> torch.Tensor:
    """§III-B: eq. 9 between the softmaxed LoRA projections ``h = A·x``."""
    return kl_divergence(global_h, client_h, temperature)


def total_distill_loss(
    global_logits: torch.Tensor,
    client_logits: torch.Tensor,
    global_h: torch.Tensor | None = None,
    client_h: torch.Tensor | None = None,
    *,
    temperature: float = DEFAULT_TEMPERATURE,
    lam: float = DEFAULT_LAMBDA,
    restrict_to_support: bool = False,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Paper eq. 10, ``L_logits + λ·L_h``, and its two parts; without a
    projection on either side the λ-term drops (the 'Adaptive' baseline)."""
    l_logits = logits_distill_loss(
        global_logits, client_logits, temperature,
        restrict_to_support=restrict_to_support, use_kernel=use_kernel,
    )
    if global_h is None or client_h is None:
        return l_logits, {"logits": l_logits, "lora": torch.zeros_like(l_logits)}
    l_h = lora_projection_loss(global_h, client_h, temperature)
    return l_logits + lam * l_h, {"logits": l_logits, "lora": l_h}
