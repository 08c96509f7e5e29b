"""Synthetic datasets matching the paper's experimental statistics.

Banking77 [arXiv:2003.04807] is an intent-classification set: 13,083 online
banking queries over 77 intents.  The real corpus is not available offline,
so we synthesise a *statistics-matched* stand-in: 77 classes, 13,083
samples, short token sequences whose distribution is class-conditional (each
class owns a token-frequency profile plus a few "keyword" tokens), making the
task genuinely learnable — models must pick up class-token correlations, and
harder class pairs share keywords (non-trivial decision boundaries).

Classification head convention (GPT-2 style, as the paper fine-tunes
decoder-only LMs for intent detection): class logits are read from the
LM head restricted to the first 77 vocab ids at the last position.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["IntentDataset", "make_banking77_like", "make_fed_benchmark_dataset", "make_lm_stream"]

BANKING77_NUM_CLASSES = 77
BANKING77_TOTAL = 13_083


@dataclasses.dataclass
class IntentDataset:
    tokens: np.ndarray  # (N, S) int32
    labels: np.ndarray  # (N,) int32
    num_classes: int
    vocab_size: int
    seq_len: int

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def subset(self, idx: np.ndarray) -> "IntentDataset":
        return IntentDataset(
            tokens=self.tokens[idx],
            labels=self.labels[idx],
            num_classes=self.num_classes,
            vocab_size=self.vocab_size,
            seq_len=self.seq_len,
        )


def make_banking77_like(
    *,
    vocab_size: int = 1024,
    seq_len: int = 32,
    num_classes: int = BANKING77_NUM_CLASSES,
    total: int = BANKING77_TOTAL,
    keyword_strength: float = 0.35,
    shared_frac: float = 0.3,
    seed: int = 0,
) -> IntentDataset:
    """Class-conditional token sequences.

    Each class c gets 4 keyword tokens; with prob ``keyword_strength`` a
    position emits one of them, else a draw from a class-tilted background
    distribution.  ``shared_frac`` of classes share one keyword with a
    neighbour class (confusable intents, as in real Banking77).
    """
    rng = np.random.default_rng(seed)
    # Reserve ids [0, num_classes) for the label-token readout convention.
    lo = num_classes
    keywords = rng.integers(lo, vocab_size, size=(num_classes, 4))
    for c in range(int(num_classes * shared_frac)):
        keywords[c, 3] = keywords[(c + 1) % num_classes, 0]  # confusable pair

    # class-tilted background: Dirichlet token profile per class
    base = rng.dirichlet(np.full(vocab_size - lo, 0.1), size=num_classes)

    labels = rng.integers(0, num_classes, size=total).astype(np.int32)
    tokens = np.empty((total, seq_len), np.int32)
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        if idx.size == 0:
            continue
        n = idx.size * seq_len
        bg = rng.choice(vocab_size - lo, size=n, p=base[c]) + lo
        kw = keywords[c][rng.integers(0, 4, size=n)]
        use_kw = rng.random(n) < keyword_strength
        seq = np.where(use_kw, kw, bg).reshape(idx.size, seq_len).astype(np.int32)
        tokens[idx] = seq
    return IntentDataset(
        tokens=tokens,
        labels=labels,
        num_classes=num_classes,
        vocab_size=vocab_size,
        seq_len=seq_len,
    )


def make_lm_stream(
    *, vocab_size: int, seq_len: int, num_samples: int, seed: int = 0
) -> np.ndarray:
    """Synthetic LM token stream with mild bigram structure, (N, S) int32.

    Used for training-throughput benchmarks and the public distillation set
    when no labels are needed.
    """
    rng = np.random.default_rng(seed)
    # sparse bigram transition: each token prefers a small successor set
    succ = rng.integers(0, vocab_size, size=(min(vocab_size, 4096), 8))
    out = np.empty((num_samples, seq_len), np.int64)
    cur = rng.integers(0, vocab_size, size=num_samples)
    for t in range(seq_len):
        out[:, t] = cur
        stay = rng.random(num_samples) < 0.7
        nxt_pref = succ[cur % succ.shape[0], rng.integers(0, 8, size=num_samples)]
        nxt_rand = rng.integers(0, vocab_size, size=num_samples)
        cur = np.where(stay, nxt_pref, nxt_rand)
    return out.astype(np.int32)


def make_fed_benchmark_dataset(vocab_size: int, *, seed: int = 0, total: int = 2500) -> IntentDataset:
    """The tuned-hardness dataset used by the FL benchmarks/tests: weak
    keywords + many confusable intents, so (i) the 80-step client pretrain
    lands at moderate accuracy (~0.4) and (ii) distillation rounds have
    headroom to demonstrate transfer (DESIGN §1 calibration)."""
    return make_banking77_like(
        vocab_size=vocab_size, seq_len=20, total=total,
        keyword_strength=0.08, shared_frac=0.7, seed=seed,
    )
