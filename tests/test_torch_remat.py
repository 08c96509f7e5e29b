"""Remat (activation rematerialisation, ``cfg.remat``) in the port's layer
stacks, on the CPU: ``stack_apply`` runs each repeat of the period under
``torch.utils.checkpoint`` (non-reentrant), and for a period of several
positions each position inside it too, as the reference's nested
``jax.checkpoint`` (``repro/models/transformer.py``).

For the six smoke families (dense yi-9b, MoE granite, SSM mamba2-130m, the
hybrid jamba whose smoke period is 4, audio seamless with its encoder, VLM
internvl2), with ``remat=True``:

* the port's ``make_train_step`` gives the loss and the updated parameters
  of its ``remat=False`` step bitwise (the recompute runs the same ops on
  the same inputs);
* the port's loss and gradients are the reference's ``remat=True``
  ``jax.grad`` on the bridged parameters: the loss within rtol 1e-5, each
  gradient leaf within atol 1e-5 times ``max(1, max |g|)`` of the leaf
  (``tests/test_torch_model.py``'s bound: fp32, the same operations in
  another order).

Remat is held to do something: a uniform stack's step peaks lower
(``MemTracker``, forward and backward), and so does a hybrid of one
period, where only the per-position checkpoint can lower it.  Prefill,
decode and a serving session never checkpoint and stay bitwise; one
``fused_e2e`` round of a ``remat=True`` client is its ``remat=False``
round, integers and floats alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.utils.checkpoint  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.steps import chunked_lm_loss as j_chunked_lm_loss  # noqa: E402
from repro.models import backbone as j_backbone  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import REDUCED_SERVER, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig  # noqa: E402
from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.data import make_banking77_like  # noqa: E402
from repro_torch.fed import FedConfig, run_federated  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    full_grads,
    init_train_opt,
    make_train_loss,
    make_train_step,
)
from repro_torch.models.frontends import frontend_embedding_shape  # noqa: E402
from repro_torch.models.model import decode_step, init, init_cache  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession, make_prefill_step  # noqa: E402

FAMILIES = ["yi-9b", "granite-moe-1b-a400m", "mamba2-130m", "jamba-1.5-large-398b",
            "seamless-m4t-large-v2", "internvl2-76b"]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
B, S = 2, 16


def _batch(cfg, seed: int):
    """Tokens ``(B, S)`` and, for a VLM or audio model, a frontend ``(B, F,
    d)``, drawn from numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = rng.normal(size=frontend_embedding_shape(cfg, B)).astype(np.float32)
    return tokens, fe


def _t_batch(tokens, fe):
    out = {"tokens": torch.as_tensor(tokens)}
    if fe is not None:
        out["frontend"] = torch.as_tensor(fe)
    return out


def _j_loss(cfg):
    """The reference's train loss (its ``make_train_step``'s ``loss_fn``)."""

    def loss_fn(params, batch):
        h, aux = j_backbone(params, cfg, batch)
        targets = batch["tokens"][:, 1:]
        loss = j_chunked_lm_loss(params, cfg, h[:, :-1], targets,
                                 jnp.ones_like(targets, jnp.float32))
        return loss + 0.01 * aux.moe_aux, loss

    return loss_fn


@pytest.fixture(scope="module")
def families():
    """``arch -> (reference config, port config, reference params, port
    params)``, ``remat=True`` and one microbatch; the port's init, bridged
    into the reference's tree."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        jc = j_smoke(arch).with_overrides(remat=True, microbatches=1)
        tc = get_smoke_config(arch).with_overrides(remat=True, microbatches=1)
        tp = init(tc, i, device="cpu")
        out[arch] = (jc, tc, jax.tree.map(jnp.asarray, bridge.to_numpy_tree(tp)), tp)
    return out


class _Spy:
    """Counts the calls of ``torch.utils.checkpoint.checkpoint``."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = torch.utils.checkpoint.checkpoint

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_remat_train_step_is_the_plain_step_bitwise(families, arch, monkeypatch):
    _, tc, _, tp = families[arch]
    batch = _t_batch(*_batch(tc, 10))
    spy = _Spy(monkeypatch)
    got_p, _, got = make_train_step(tc, lr=1e-3)(tp, init_train_opt(tp, tc), batch)
    assert spy.calls > 0
    plain = tc.with_overrides(remat=False)
    calls = spy.calls
    want_p, _, want = make_train_step(plain, lr=1e-3)(tp, init_train_opt(tp, plain), batch)
    assert spy.calls == calls  # the plain step checkpoints nothing (its CE has one chunk)
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["ce"], want["ce"])
    assert set(got_p) == set(want_p)
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_loss_and_gradients_are_the_references(families, arch):
    jc, tc, jp, tp = families[arch]
    tokens, fe = _batch(tc, 11)
    j_batch = {"tokens": jnp.asarray(tokens)}
    if fe is not None:
        j_batch["frontend"] = jnp.asarray(fe)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(_j_loss(jc), has_aux=True))(jp, j_batch)
    (loss, _), grads = full_grads(make_train_loss(tc), tp, torch.as_tensor(tokens),
                                  None if fe is None else torch.as_tensor(fe))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    want = bridge.flatten(jax.tree.map(np.asarray, j_grads))
    assert set(want) == set(grads)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(1.0, float(np.abs(w).max())), err_msg=k)


def _grad_peak(cfg, params, batch) -> int:
    """``MemTracker``'s peak bytes over one forward and backward of the
    train loss."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    with tracker:
        full_grads(make_train_loss(cfg), params, batch["tokens"], batch.get("frontend"))
    return tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]


@pytest.mark.parametrize("arch,layers", [("yi-9b", 4), ("jamba-1.5-large-398b", 4)])
def test_remat_lowers_the_peak(arch, layers):
    """yi-9b at 4 layers keeps one repeat's input where the plain pass keeps
    every layer's activations: the outer checkpoint lowers the peak.  jamba
    at 4 layers is ONE repeat of its period of 4, so the outer checkpoint
    alone recomputes the whole period at once in the backward and holds
    what the plain pass holds; only the per-position checkpoint inside it
    lowers the peak."""
    cfg = get_smoke_config(arch).with_overrides(num_layers=layers, microbatches=1)
    params = init(cfg, 3, device="cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, size=(4, 128))
    batch = {"tokens": torch.as_tensor(tokens.astype(np.int32))}
    plain = _grad_peak(cfg, params, batch)
    remat = _grad_peak(cfg.with_overrides(remat=True), params, batch)
    assert remat < 0.8 * plain, (remat, plain)


def test_serving_never_checkpoints_and_is_unchanged(families, monkeypatch):
    """A ``remat=True`` model's prefill step, decode steps and a serving
    session (prefill, then greedy decode) never call the checkpoint, and
    give the ``remat=False`` model's logits bitwise."""
    _, tc, _, tp = families["jamba-1.5-large-398b"]
    spy = _Spy(monkeypatch)
    tokens, _ = _batch(tc, 13)
    outs = {}
    for remat in (True, False):
        cfg = tc.with_overrides(remat=remat)
        prefill = make_prefill_step(cfg)(tp, {"tokens": torch.as_tensor(tokens)})
        cache = init_cache(cfg, B, S + 4, device="cpu")
        steps = []
        for t in range(S):
            logits, cache = decode_step(tp, cfg, cache, torch.as_tensor(tokens[:, t]))
            steps.append(logits)
        sess = ServeSession(ServeConfig(model=cfg, batch=B, cache_len=S + 4), tp, device="cpu")
        first = sess.prefill(tokens[:, :8])
        toks, _ = sess.decode(4)
        outs[remat] = [prefill, *steps, first, torch.as_tensor(toks)]
    assert spy.calls == 0
    for got, want in zip(outs[True], outs[False]):
        assert torch.equal(got, want)


def test_a_fused_e2e_round_with_remat_is_the_plain_round(monkeypatch):
    """One ``fused_e2e`` round of a granite-smoke fleet with ``remat=True``
    against the same round with ``remat=False``: the budgets, the ledger and
    the transmitters identical, the accuracies and the distillation loss
    bitwise; the remat round's client steps checkpoint."""
    lora = LoRAConfig(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
    client = get_smoke_config("granite-moe-1b-a400m").with_overrides(
        d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, vocab_size=256, max_seq_len=32,
        lora=lora)
    server = REDUCED_SERVER.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2,
                                           d_ff=192, vocab_size=256, max_seq_len=32, lora=lora)
    data = make_banking77_like(vocab_size=256, seq_len=12, total=300, seed=0)
    fed = FedConfig(method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2,
                    rounds=1, public_size=32, public_batch=16, eval_size=32, local_steps=1,
                    distill_steps=1, server_distill_steps=1, seed=0, pretrain_steps=0,
                    use_kernels=True, channel=ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0))
    spy = _Spy(monkeypatch)
    got = run_federated(client.with_overrides(remat=True), server, data, fed, device="cpu")
    assert spy.calls > 0
    calls = spy.calls
    want = run_federated(client.with_overrides(remat=False), server, data, fed, device="cpu")
    assert spy.calls == calls
    assert got.per_client_k == want.per_client_k
    assert [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters) for r in got.ledger.rounds] == [
        (r.uplink_bytes, r.downlink_bytes, r.num_transmitters) for r in want.ledger.rounds]
    for field in ("server_acc", "client_acc", "mean_k", "distill_loss"):
        assert getattr(got, field) == getattr(want, field), field
