"""ServeSession: the public serving API — the port of
``repro/serve/session.py``.

One session = one shared frozen backbone + one decode cache + (optionally)
an :class:`~repro_torch.serve.AdapterCache` of tenant adapters::

    cfg = ServeConfig(model=model_cfg, batch=8)
    sess = ServeSession(cfg, params, adapters=cache)
    sess.attach([17, 3, 3, 99, ...])      # tenant id per request
    sess.prefill(prompts)                  # (B, L) int32
    tokens, logits = sess.decode(32)       # (B, 32) greedy or sampled
    sess.stats()                           # cache hits/misses, timing, ...

Two step functions serve every mix: the single-adapter step (detached)
and the stacked multi-tenant step (attached); tenant mix, slot assignment
and tokens are data.  Prefill teacher-forces the prompt through the same
decode step.  The decode cache lives on the session's device and is
updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.lora import split_lora
from repro_torch.models import init_cache
from repro_torch.models import frontends
from repro_torch.models.model import _run_encoder
from repro_torch.serve.cache import AdapterCache
from repro_torch.serve.steps import make_decode_step, make_stacked_decode_step

__all__ = ["ServeConfig", "ServeSession"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen serving knobs."""

    model: ModelConfig
    batch: int = 4  # requests per decode step
    cache_len: int = 128  # decode-cache capacity (prompt + generated)
    temperature: float = 0.0  # 0 = greedy
    window: int | None = None  # sliding-window override (None = cfg default)
    seed: int = 0  # sampling generator seed


class ServeSession:
    """Stateful serving loop over the step functions, on ``device`` (the
    card unless the caller asks for ``"cpu"``)."""

    def __init__(self, cfg: ServeConfig, params: dict, *, adapters: AdapterCache | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.adapters = adapters
        self._lora, self._frozen = split_lora(self.params)
        mc = cfg.model
        self._steps = {
            "single": make_decode_step(mc, window=cfg.window),
            "stacked": make_stacked_decode_step(mc, window=cfg.window),
        }
        self._slot_idx: torch.Tensor | None = None  # (B,) int64 slab slots when attached
        self._cache: dict | None = None
        self._length = 0  # host copy of the cache's length
        self._logits: torch.Tensor | None = None
        # torch.Generator draws differ from jax.random's under the same seed
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.tokens_decoded = 0
        # per-mode first-call wall time + steady accumulators
        self._first_s: dict[str, float] = {}
        self._steady_s = 0.0
        self._steady_steps = 0

    # -- adapter attach / detach -----------------------------------------
    def attach(self, adapter_ids: Sequence[int], *, reset: bool = True) -> np.ndarray:
        """Bind tenant ``adapter_ids[b]`` to request b (len == batch),
        paging misses through the AdapterCache.  Resets the decode cache by
        default — new tenants mean new requests.  Returns the slot map."""
        if self.adapters is None:
            raise ValueError("ServeSession was built without an AdapterCache — pass adapters= "
                             "to serve per-request tenants")
        if len(adapter_ids) != self.cfg.batch:
            raise ValueError(f"got {len(adapter_ids)} adapter ids for batch {self.cfg.batch}")
        slots = self.adapters.lookup(adapter_ids)
        self._slot_idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        if reset:
            self.reset()
        return slots

    def detach(self) -> None:
        """Back to single-adapter mode (the session's own ``params``)."""
        self._slot_idx = None

    @property
    def attached(self) -> bool:
        return self._slot_idx is not None

    # -- decode-cache lifecycle -------------------------------------------
    def reset(self, *, frontend=None) -> None:
        """A fresh decode cache; an audio model's encoder runs once here, on
        ``frontend (B, F, d)`` (the stub's draw when None) with the
        session's own ``params`` (tenants attached or not, as in the
        reference), and its output stays in the cache for every decode
        step to cross-attend to."""
        mc = self.cfg.model
        enc_out = None
        if mc.family == "audio":
            if frontend is None:
                frontend = frontends.synth_frontend_embeddings(mc, self.cfg.batch,
                                                               device=self.device)
            with torch.no_grad():
                enc_out = _run_encoder(self.params, mc,
                                       torch.as_tensor(frontend, device=self.device)[None])[0]
        self._cache = init_cache(mc, self.cfg.batch, self.cfg.cache_len, window=self.cfg.window,
                                 enc_out=enc_out, device=self.device)
        self._length = 0
        self._logits = None

    # -- the one decode step ----------------------------------------------
    def _timed(self, name: str, *args):
        t0 = time.perf_counter()
        logits, cache = self._steps[name](*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if name not in self._first_s:
            self._first_s[name] = dt
        else:
            self._steady_s += dt
            self._steady_steps += 1
        return logits, cache

    def step(self, tokens) -> torch.Tensor:
        """Feed one token per request, return next-token logits (B, V)."""
        if self._cache is None:
            self.reset()
        if self._length >= self.cfg.model.max_seq_len:
            raise ValueError(f"position {self._length} is past the model's max_seq_len "
                             f"{self.cfg.model.max_seq_len}")
        tok = torch.as_tensor(tokens, device=self.device).long()
        if self._slot_idx is not None:
            self._logits, self._cache = self._timed(
                "stacked", self._frozen, self.adapters.slab, self._slot_idx, self._cache, tok
            )
        else:
            self._logits, self._cache = self._timed("single", self.params, self._cache, tok)
        self._length += 1
        return self._logits

    # -- serving loops ------------------------------------------------------
    def prefill(self, prompts) -> torch.Tensor:
        """Teacher-force ``prompts (B, L)`` through the decode step
        (resetting the cache first); returns last-position logits (B, V)."""
        prompts = torch.as_tensor(np.asarray(prompts), device=self.device)
        self.reset()
        for t in range(prompts.shape[1]):
            logits = self.step(prompts[:, t])
        return logits

    def decode(self, num_tokens: int, *, temperature: float | None = None):
        """Generate ``num_tokens`` per request from the current state: greedy
        at temperature 0, else drawn from ``softmax(logits / T)`` with the
        session's generator.  Returns ``(tokens (B, num_tokens) np.int32,
        last logits)``."""
        if self._logits is None:
            raise RuntimeError("decode() before prefill()/step() — no logits yet")
        temp = self.cfg.temperature if temperature is None else temperature
        out = []
        logits = self._logits
        for _ in range(num_tokens):
            if temp > 0:
                probs = torch.softmax(logits.float() / temp, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits = self.step(nxt)
        self.tokens_decoded += num_tokens * self.cfg.batch
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy(), logits

    # -- stats taps ---------------------------------------------------------
    def executables(self) -> dict:
        """Step functions per mode that have run: the reference counts its
        jit caches (one compile per mode); the port compiles nothing and
        reports 1 for each mode whose step function has run, else 0."""
        return {name: int(name in self._first_s) for name in self._steps}

    def stats(self) -> dict:
        steady = self._steady_s / self._steady_steps if self._steady_steps else 0.0
        s = {
            "tokens_decoded": self.tokens_decoded,
            "first_step_s": dict(self._first_s),
            "steady_step_s": steady,
            "steady_steps": self._steady_steps,
            "executables": self.executables(),
            "attached": self.attached,
        }
        if self.adapters is not None:
            s["adapter_cache"] = self.adapters.stats.as_dict()
            s["adapter_slots"] = self.adapters.slots
            s["resident_adapters"] = list(self.adapters.resident())
        return s
