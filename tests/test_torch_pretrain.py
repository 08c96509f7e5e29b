"""The port's backbone pretraining against the JAX reference, on the CPU.

``models.backbone``, ``launch.steps.chunked_lm_loss`` and
``make_train_step``, ``fed.pretrain``'s ``pretrain_classifier`` and
``pretrain_lm``, and ``run_federated`` with ``pretrain_steps=2``,
``server_pretrain_steps=2`` and ``server_pretrain`` in ``"lm"``,
``"supervised"`` and ``"none"`` on ``fused_e2e`` and ``batched`` (2
rounds, the clients on one shared pretrained backbone: the fleet store's
shared layout), on the tiny configs
of ``tests/test_engine.py`` with the JAX init bridged into the port (both
packages start from the same weights; ``repro_torch.models.model.init`` is
replaced for the module).

Tolerances:

* hidden states, losses and gradients of one step: 1e-5 of their scale
  (fp32 sums in another order);
* parameters after training steps: every element within 1e-4 (1.7 % of
  the 6e-3 that 3 steps of lr 2e-3 can move it), except that up to 0.1 %
  of a leaf's elements, rounded up, may stray, each by at most
  2 · lr · steps: Adam's normalised step turns a last-bit difference in a
  near-zero gradient into a step of order lr.  The attention's key bias is held to
  the stray bound alone: its gradient is zero in exact arithmetic (the
  softmax is shift-invariant), so both packages train it on rounding
  noise;
* step metrics (loss, accuracy): rtol 1e-5, accuracy exactly;
* the reset adapters: bitwise the bridged ``init(cfg, seed + 1)``, B zero;
* the federations: integers (per-client k, bytes, transmitters)
  identical, accuracies within two eval samples and the server-distill
  loss within rtol 1e-3, ten times ``tests/test_torch_round.py``'s bounds:
  there both packages start from the same weights, here from backbones
  trained in each package, which differ by the bound above (and the
  port's CPU matmuls round differently with the thread count the math
  library picks under load: the loss sat 1.7e-5 from the reference alone,
  1.7e-4 beside another test process).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.pretrain as j_pre  # noqa: E402
import repro.fed.rounds as j_rounds  # noqa: E402
import repro.launch.steps as j_steps  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.models import backbone as j_backbone  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import global_norm as j_global_norm  # noqa: E402
import repro_torch.fed.pretrain as t_pre  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
import repro_torch.launch.steps as t_steps  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.launch import init_train_opt  # noqa: E402
from repro_torch.lora import is_lora_path  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402

PORT_INIT = t_model.init  # the port's own init, before the module's fixture bridges it
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
# the same configs with two gradient-accumulation microbatches
J_MICRO, T_MICRO = J_CLIENT.with_overrides(microbatches=2), T_CLIENT.with_overrides(microbatches=2)
CFG_MAP = {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER, T_MICRO: J_MICRO}
LR, STEPS = 2e-3, 3
NOISE_LEAVES = ("stack/pos0/attn/wk/b",)  # zero gradient in exact arithmetic


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), CFG_MAP[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(autouse=True, scope="module")
def bridged():
    """The bridged init and empty pretraining caches for the whole module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    mp.setattr(t_pre, "_CACHE", {})
    mp.setattr(j_pre, "_CACHE", {})
    yield
    mp.undo()


def _params(cfg, seed):
    j = j_init(jax.random.PRNGKey(seed), CFG_MAP[cfg])
    return j, bridge.to_torch(jax.tree.map(np.asarray, j), "cpu")


def _close(t, j, rtol=1e-5):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * max(np.abs(j).max(), 1e-30))


def _trained_params_match(t_params: dict, j_tree, lr: float, steps: int) -> None:
    """The module docstring's bound for parameters after training steps."""
    j_flat = bridge.flatten(jax.tree.map(np.asarray, j_tree))
    assert set(t_params) == set(j_flat)
    stray_bound = 2 * lr * steps
    for key, t in t_params.items():
        diff = np.abs(t.detach().numpy() - j_flat[key])
        assert diff.max() <= stray_bound, (key, diff.max())
        if key not in NOISE_LEAVES:
            strays = int(np.sum(diff > 1e-4))
            assert strays <= np.ceil(1e-3 * diff.size), (key, strays, diff.max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("last_only", [False, True])
def test_backbone_matches_reference(last_only):
    """Hidden states post final-norm, pre head, of one model (a client axis
    of 1 in the port), and ``forward`` reads the same stack."""
    j, t = _params(T_CLIENT, 1)
    tokens = _tokens(2, (4, 12))
    j_h, j_aux = j_backbone(j, J_CLIENT, {"tokens": jnp.asarray(tokens)}, last_only=last_only)
    t_h, t_aux = t_model.backbone(t, T_CLIENT, torch.as_tensor(tokens)[None], last_only=last_only)
    assert t_h.shape == (1,) + tuple(j_h.shape)
    _close(t_h[0].numpy(), j_h)
    _close(t_aux.lora_h[0].numpy(), j_aux.lora_h)
    logits, _ = t_model.forward(t, T_CLIENT, torch.as_tensor(tokens)[None], last_only=last_only)
    head = t_model._lm_logits(t, T_CLIENT, t_h, None)
    assert torch.equal(logits, head[:, :, 0] if last_only else head)


@pytest.mark.parametrize("chunk", [16, 11, 4], ids=["S-below-chunk", "S-equal-chunk", "S-above-chunk"])
def test_chunked_lm_loss_matches_reference(monkeypatch, chunk):
    """The next-token CE over S = 11 positions, and its gradients with
    respect to the hidden states and the head, with ``CE_CHUNK`` above,
    equal to and below S (4: three chunks, the last padded by one masked
    position; the port recomputes each chunk in the backward pass)."""
    monkeypatch.setattr(j_steps, "CE_CHUNK", chunk)
    monkeypatch.setattr(t_steps, "CE_CHUNK", chunk)
    j, t = _params(T_CLIENT, 3)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, 11, 64)).astype(np.float32)
    targets = rng.integers(0, 256, size=(3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) > 0.2).astype(np.float32)

    def j_loss(h, params):
        return j_steps.chunked_lm_loss(params, J_CLIENT, h, jnp.asarray(targets), jnp.asarray(mask))

    j_val, (j_gh, j_gp) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(h), j)
    th = torch.as_tensor(h).requires_grad_(True)
    embed = t["embed"].clone().requires_grad_(True)
    t_val = t_steps.chunked_lm_loss({**t, "embed": embed}, T_CLIENT, th[None],
                                    torch.as_tensor(targets)[None], torch.as_tensor(mask)[None])
    t_gh, t_ge = torch.autograd.grad(t_val, [th, embed])
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    _close(t_gh.numpy(), j_gh)
    _close(t_ge.numpy(), j_gp["embed"])


@pytest.mark.parametrize("cfg", [T_CLIENT, T_MICRO], ids=["microbatches-1", "microbatches-2"])
def test_train_step_matches_reference(cfg):
    """Three full-parameter AdamW steps of the LM train step, with one and
    two microbatches: the losses, and the parameters under the module's
    bound.  The first step's global gradient norm is over three times the
    clip (1.0), so the clip is taken, and it spans the whole tree: a clip
    per layer or per leaf would scale the gradients otherwise."""
    j, t = _params(cfg, 5)
    j_step = jax.jit(j_steps.make_train_step(CFG_MAP[cfg], lr=LR, weight_decay=1e-4))
    t_step = t_steps.make_train_step(cfg, lr=LR, weight_decay=1e-4)
    j_opt, t_opt = j_adamw_init(j), init_train_opt(t, cfg)
    batches = [_tokens(10 + i, (4, 12)) for i in range(STEPS)]

    def j_ce(params, tokens):
        h, _ = j_backbone(params, CFG_MAP[cfg], {"tokens": tokens})
        return j_steps.chunked_lm_loss(params, CFG_MAP[cfg], h[:, :-1], tokens[:, 1:],
                                       jnp.ones(tokens[:, 1:].shape, jnp.float32))

    assert float(j_global_norm(jax.grad(j_ce)(j, jnp.asarray(batches[0])))) > 3.0
    for tokens in batches:
        j, j_opt, j_m = j_step(j, j_opt, {"tokens": jnp.asarray(tokens)})
        t, t_opt, t_m = t_step(t, t_opt, {"tokens": torch.as_tensor(tokens)})
        np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(t_m["ce"]), float(j_m["ce"]), rtol=1e-5)
    assert t_opt.count.tolist() == [STEPS]
    _trained_params_match(t, j, LR, STEPS)


def test_adamw_bias_correction_is_bitwise_the_host_scalar_form():
    """``1 - b ** count`` on the fp32 count, with the python scalar in the
    kernel, equals the earlier ``1 - pow(tensor(b, fp32), count)`` bitwise,
    and so does a whole update."""
    count = torch.tensor([1, 2, 3, 7, 100, 1000, 54321], dtype=torch.int32).float()
    for b in (0.9, 0.999):
        old = 1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), count)
        assert torch.equal(1.0 - b**count, old)
    rng = np.random.default_rng(0)
    p = {"w": torch.as_tensor(rng.normal(size=(7, 5, 3)).astype(np.float32))}
    g = {"w": torch.as_tensor(rng.normal(size=(7, 5, 3)).astype(np.float32))}
    state = adamw_init(p)._replace(count=torch.arange(7, dtype=torch.int32) * 13)
    new_p, _ = adamw_update(g, state, p, lr=1e-3, weight_decay=0.1)
    cf = (state.count + 1).float()
    bc1 = (1.0 - torch.pow(torch.tensor(0.9, dtype=torch.float32), cf)).reshape(7, 1, 1)
    bc2 = (1.0 - torch.pow(torch.tensor(0.999, dtype=torch.float32), cf)).reshape(7, 1, 1)
    scale = torch.clamp(1.0 / (torch.sqrt(torch.sum(g["w"] ** 2, dim=(1, 2))) + 1e-9), max=1.0)
    gw = g["w"] * scale.reshape(7, 1, 1)
    m, v = gw * (1.0 - 0.9), torch.square(gw) * (1.0 - 0.999)
    want = p["w"] - 1e-3 * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + 0.1 * p["w"])
    assert torch.equal(new_p["w"], want)


def _capture_steps(module, name, into, traced=False):
    """Wrap ``module.name`` (a step factory) so every step's metrics are
    kept; ``traced``: the step runs under ``jax.jit``, and the metrics leave
    it through a debug callback."""
    make = getattr(module, name)

    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            if traced:
                jax.debug.callback(lambda m: into.append({k: float(v) for k, v in m.items()}),
                                   metrics)
            else:
                into.append({k: float(v) for k, v in metrics.items()})
            return params, opt, metrics

        return recorded

    return factory


def _pretrain_both(kind, monkeypatch):
    j_ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=0).subset(np.arange(100))
    t_ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0).subset(np.arange(100))
    j_metrics, t_metrics = [], []
    if kind == "classifier":
        monkeypatch.setattr(j_pre, "_supervised_step", _capture_steps(j_pre, "_supervised_step", j_metrics))
        monkeypatch.setattr(t_pre, "_supervised_step", _capture_steps(t_pre, "_supervised_step", t_metrics))
        kw = dict(num_classes=j_ds.num_classes, steps=STEPS, lr=LR, batch_size=32, seed=3)
        j = j_pre.pretrain_classifier(J_CLIENT, j_ds, **kw)
        t = t_pre.pretrain_classifier(T_CLIENT, t_ds, device="cpu", **kw)
        return T_CLIENT, j, t, j_metrics, t_metrics, lambda: t_pre.pretrain_classifier(
            T_CLIENT, t_ds, device="cpu", **kw)
    monkeypatch.setattr(j_steps, "make_train_step", _capture_steps(j_steps, "make_train_step", j_metrics,
                                                                       traced=True))
    monkeypatch.setattr(t_pre, "make_train_step", _capture_steps(t_pre, "make_train_step", t_metrics))
    kw = dict(steps=STEPS, lr=LR, batch_size=32, seed=3)
    j = j_pre.pretrain_lm(J_SERVER, j_ds, **kw)
    t = t_pre.pretrain_lm(T_SERVER, t_ds, device="cpu", **kw)
    return T_SERVER, j, t, j_metrics, t_metrics, lambda: t_pre.pretrain_lm(
        T_SERVER, t_ds, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["classifier", "lm"])
def test_pretrain_matches_reference(monkeypatch, kind):
    """``pretrain_classifier`` (client config) and ``pretrain_lm`` (server
    config), 3 steps of batch 32 on 100 samples: every step's metrics, the
    frozen backbone under the module's bound, the adapters reset bitwise to
    the bridged ``init(cfg, seed + 1)`` with ``B`` all zero.  A second call
    is served from the cache with equal values, in tensors of its own."""
    cfg, j, t, j_metrics, t_metrics, again = _pretrain_both(kind, monkeypatch)
    assert len(t_metrics) == len(j_metrics) == STEPS
    for tm, jm in zip(t_metrics, j_metrics):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        if kind == "classifier":
            assert tm["acc"] == jm["acc"]
    fresh = _bridged_init(cfg, 4, "cpu")  # seed + 1
    lora_keys = [k for k in t if is_lora_path(k)]
    assert lora_keys
    for k in lora_keys:
        assert torch.equal(t[k], fresh[k]), k
        if k.endswith("/B"):
            assert not t[k].any(), k
    frozen = {k: v for k, v in t.items() if not is_lora_path(k)}
    j_frozen = {k: v for k, v in bridge.flatten(j).items() if not is_lora_path(k)}
    _trained_params_match(frozen, bridge.unflatten(j_frozen), LR, STEPS)

    before = {k: v.clone() for k, v in t.items()}
    t[lora_keys[0]].add_(1.0)  # written in place, as the fleet store writes
    t["embed"].zero_()
    cached = again()
    assert len(t_metrics) == STEPS  # no step ran: the cache answered
    for k, v in cached.items():
        assert v is not t[k] and torch.equal(v, before[k]), k


# run_federated with pretraining: engine x server_pretrain
PRETRAIN_CASES = [(engine, sp) for engine in ("fused_e2e", "batched")
                  for sp in ("lm", "supervised", "none")]
EVAL_SIZE = 64


def _fed(engine, server_pretrain, package):
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    return fed(method="adald", engine=engine, num_clients=4, clients_per_round=2, rounds=2,
               public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=2,
               distill_steps=1, server_distill_steps=2, seed=0, pretrain_steps=2,
               server_pretrain=server_pretrain, server_pretrain_steps=2,
               channel=chan(bandwidth_hz=2e5, mean_snr_db=2.0),
               **({} if package == "jax" else {"use_kernels": True}))


@pytest.fixture(scope="module")
def pretrained_runs():
    """{case: (reference run, port run, port engine)}."""
    out, built = {}, []
    make = t_rounds.make_engine
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_rounds, "make_engine", lambda *a, **k: built.append(make(*a, **k)) or built[-1])
        for case in PRETRAIN_CASES:
            j_run = j_rounds.run_federated(
                J_CLIENT, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(*case, "jax"))
            t_run = t_rounds.run_federated(
                T_CLIENT, T_SERVER, t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(*case, "torch"), device="cpu")
            out[case] = (j_run, t_run, built[-1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", PRETRAIN_CASES, ids=[f"{e}-{sp}" for e, sp in PRETRAIN_CASES])
def test_pretrained_run_matches_reference(pretrained_runs, case):
    """A pretrained federation in both packages: the reference's k, bytes
    and transmitters, its accuracies and distill loss (NaN off the e2e
    path); the fleet rides one shared backbone."""
    j_run, t_run, t_eng = pretrained_runs[case]
    assert t_run.per_client_k == j_run.per_client_k
    assert len(t_run.ledger.rounds) == len(j_run.ledger.rounds) == 2
    for t, j in zip(t_run.ledger.rounds, j_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
    two_samples = 2.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=two_samples)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=two_samples)
    np.testing.assert_allclose(t_run.distill_loss, j_run.distill_loss, rtol=1e-3, equal_nan=True)
    assert np.isnan(t_run.distill_loss).all() == (t_eng.name == "batched")
    assert t_eng._store.shared


def test_the_cache_keys_on_the_whole_config_and_the_data(monkeypatch):
    """Pretrained backbones are cached per config and per pretraining
    split, not per name, depth and width and the split's length: two
    configs alike in those but for their LoRA rank each get adapters of
    their own rank (the cache once handed the second the first's, and a
    later run in the same process failed its server distillation on the
    mismatched projection), one config on two splits of one length gets two
    backbones, and the same call again is the cached result."""
    monkeypatch.setattr(t_model, "init", PORT_INIT)
    monkeypatch.setattr(t_pre, "_CACHE", {})
    eight = T_CLIENT.with_overrides(lora=TLoRA(**{**_LORA, "rank": 8}))
    data, other = (t_dataset(vocab_size=256, seq_len=12, total=64, seed=s) for s in (0, 1))
    kw = dict(num_classes=data.num_classes, steps=1, batch_size=16, device="cpu")
    four_p = t_pre.pretrain_classifier(T_CLIENT, data, **kw)
    eight_p = t_pre.pretrain_classifier(eight, data, **kw)
    assert four_p["lora_head/A"].shape[-1] == 4 and eight_p["lora_head/A"].shape[-1] == 8
    other_p = t_pre.pretrain_classifier(T_CLIENT, other, **kw)
    assert not torch.equal(four_p["embed"], other_p["embed"])
    again = t_pre.pretrain_classifier(T_CLIENT, data, **kw)
    assert all(torch.equal(four_p[k], again[k]) for k in four_p)
    lm = t_pre.pretrain_lm(eight, data, steps=1, batch_size=16, device="cpu")
    assert lm["lora_head/A"].shape[-1] == 8
