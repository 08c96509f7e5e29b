"""The port's ``train`` and ``serve`` CLIs, its LR schedules and its
architecture registry against the reference's, on the CPU.

* ``train``: 3 steps of the ``gpt2-paper`` smoke config on the same
  synthetic LM stream, the port's model init replaced by the bridged JAX
  init: every step's loss within rtol 1e-5 of the reference CLI's (the
  same fp32 arithmetic in another order; the reference's losses are read
  exactly, through a host callback inside its jitted step).
* ``serve``, one adapter: every step's logits within 1e-5 of the largest
  magnitude of the reference CLI's (prompt and decode, both teacher-forced
  through one decode step), and the greedy tokens equal until a request's
  reference top two logits lie within twice that bound, where a last-bit
  difference may pick the other (the request is compared no further).
* ``serve``, 8 tenants in 8 slots: the tenant-to-slot map and the adapter
  cache's stats equal to the reference's.  Its synthetic adapters come from
  another generator than the reference's (ROADMAP.md, Known deviations),
  so its tokens are not compared.
* The schedules over a grid of steps: ``constant`` and ``warmup_linear``
  within one fp32 ulp of the reference's value (the same operations in
  the same order); ``warmup_cosine`` within one fp32 ulp of ``peak_lr``:
  the fp32 cosines of XLA and of torch differ by up to an ulp, and
  ``1 + cos`` cancels toward the end of the decay, which turns that ulp
  into up to 5 ulps of the value, never more than one of ``peak_lr``.
* ``train --arch`` and ``serve --arch`` of the SSM and hybrid smoke
  configs, held as the GPT-2 pair is; ``train --arch internvl2-76b`` (a
  stub frontend in each batch) and ``serve --arch seamless-m4t-large-v2``
  (the encoder run once a request batch) likewise, the port's stub the
  reference's draw (``_torch_modal``).
* What the port does not carry raises: a dtype name outside fp32, bf16 and
  fp16 on the VLM and audio families; ``--production`` exits as the
  reference's does, naming the dry run.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_draw  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.launch.serve as j_serve  # noqa: E402
import repro.launch.train as j_train  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
import repro_torch.launch.train as t_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import frontends as t_frontends  # noqa: E402
from repro_torch.optim import schedule as t_schedule  # noqa: E402

LOGIT_TOL = 1e-5  # of the largest logit magnitude (see the module docstring)


def _bridged_init(cfg, seed, device="cuda", arch="gpt2-paper"):
    assert cfg == get_smoke_config(arch)
    tree = j_init(jax.random.PRNGKey(seed), j_smoke(arch))
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


def test_train_cli_losses_are_the_references(monkeypatch, tmp_path):
    _train_losses_held(["--steps", "3", "--batch", "2", "--seq", "32"], monkeypatch, tmp_path)


def _train_losses_held(argv, monkeypatch, tmp_path, arch="gpt2-paper"):
    """Both train CLIs on ``argv``, the port from the reference's init: the
    losses of the three steps within rtol 1e-5."""
    j_losses, t_losses = [], []
    j_make = j_train.make_train_step

    def j_recording(cfg, **kw):
        step = j_make(cfg, **kw)

        def recorded(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            jax.debug.callback(lambda loss: j_losses.append(float(loss)), metrics["loss"])
            return params, opt, metrics

        return recorded

    t_make = t_train.make_train_step

    def t_recording(cfg, **kw):
        step = t_make(cfg, **kw)

        def recorded(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            t_losses.append(float(metrics["loss"]))
            return params, opt, metrics

        return recorded

    monkeypatch.setattr(j_train, "make_train_step", j_recording)
    monkeypatch.setattr(t_train, "make_train_step", t_recording)
    monkeypatch.setattr(t_train, "model_init", functools.partial(_bridged_init, arch=arch))
    assert j_train.main(argv) == 0
    assert t_train.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    assert len(t_losses) == len(j_losses) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert (tmp_path / "step_00000003.npz").exists()


def _recording_session(base, into: dict):
    """``base`` (either package's ServeSession) keeping every step's logits,
    the slot map and the stats."""

    class Recording(base):
        def step(self, tokens):
            logits = super().step(tokens)
            into.setdefault("logits", []).append(np.asarray(
                logits.cpu() if isinstance(logits, torch.Tensor) else logits))
            return logits

        def attach(self, adapter_ids, **kw):
            slots = super().attach(adapter_ids, **kw)
            into["slots"] = np.asarray(slots).tolist()
            return slots

        def decode(self, num_tokens, **kw):
            into["gen"], logits = super().decode(num_tokens, **kw)
            into["stats"] = self.stats()
            return into["gen"], logits

    return Recording


def _serve(argv, monkeypatch, arch="gpt2-paper"):
    j_got, t_got = {}, {}
    monkeypatch.setattr(j_serve, "ServeSession", _recording_session(j_serve.ServeSession, j_got))
    monkeypatch.setattr(t_serve, "ServeSession", _recording_session(t_serve.ServeSession, t_got))
    monkeypatch.setattr(t_serve, "model_init", functools.partial(_bridged_init, arch=arch))
    assert j_serve.main(argv) == 0
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    return j_got, t_got


def test_serve_cli_single_adapter_decodes_as_the_reference(monkeypatch):
    _serve_held(monkeypatch, vocab=1024)


def _serve_held(monkeypatch, vocab, arch="gpt2-paper"):
    """Both serve CLIs, one adapter, batch 4: the logits at every step up
    to a greedy token taken at a near-tie of the reference's own logits,
    and most of the decode held token for token."""
    prompt, tokens = 8, 12
    j_got, t_got = _serve(["--arch", arch, "--batch", "4", "--prompt-len", str(prompt),
                           "--tokens", str(tokens)], monkeypatch, arch)
    j_logits, t_logits = np.stack(j_got["logits"]), np.stack(t_got["logits"])
    assert j_logits.shape == t_logits.shape == (prompt + tokens, 4, vocab)
    atol = LOGIT_TOL * np.abs(j_logits).max()
    # the logits each greedy token is taken from: the prompt's last, then each decode step's
    chosen_from = j_logits[prompt - 1:prompt - 1 + tokens]
    top2 = np.sort(chosen_from, axis=-1)[..., -2:]
    compared = 0
    for b in range(4):
        differ = np.flatnonzero(t_got["gen"][b] != j_got["gen"][b])
        last = tokens if len(differ) == 0 else int(differ[0])
        if last < tokens:  # a near-tie at the reference's own logits
            assert top2[last, b, 1] - top2[last, b, 0] <= 2 * atol, (b, last)
        # every step up to the one that takes the first differing token
        np.testing.assert_allclose(t_logits[:prompt + last, b], j_logits[:prompt + last, b],
                                   rtol=0, atol=atol)
        compared += last
    assert compared >= 2 * tokens  # most of the decode is held token for token


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_train_and_serve_clis_carry_the_ssm_and_hybrid(arch, monkeypatch, tmp_path):
    """``train --arch`` and ``serve --arch`` of the SSM and the hybrid smoke
    configs, held to the reference's CLIs as the GPT-2 pair is."""
    _train_losses_held(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32"],
                       monkeypatch, tmp_path, arch)
    _serve_held(monkeypatch, vocab=get_smoke_config(arch).vocab_size, arch=arch)


def test_serve_cli_tenants_page_as_in_the_reference(monkeypatch):
    j_got, t_got = _serve(["--batch", "8", "--adapters", "8", "--slots", "8", "--tokens", "4",
                           "--prompt-len", "8"], monkeypatch)
    assert t_got["slots"] == j_got["slots"]
    assert t_got["stats"]["adapter_cache"] == j_got["stats"]["adapter_cache"]
    assert t_got["stats"]["adapter_slots"] == j_got["stats"]["adapter_slots"] == 8
    assert t_got["stats"]["resident_adapters"] == list(j_got["stats"]["resident_adapters"])
    assert t_got["gen"].shape == j_got["gen"].shape == (8, 4)


def test_random_adapters_are_seeded_per_tenant():
    params = t_serve.model_init(get_smoke_config("gpt2-paper"), 0, "cpu")
    a, b = t_serve._RandomAdapters(params, 4, seed=3), t_serve._RandomAdapters(params, 4, seed=3)
    for key, leaf in a.lora_row(2).items():
        assert torch.equal(leaf, b.lora_row(2)[key]) and bool(leaf.abs().sum() > 0)
        assert not torch.equal(leaf, a.lora_row(1)[key])
        assert not torch.equal(leaf, t_serve._RandomAdapters(params, 4, seed=4).lora_row(2)[key])


SCHEDULES = [
    ("constant", (3e-4,), {}),
    ("warmup_linear", (3e-4, 20, 200), {}),
    ("warmup_linear", (2e-3, 1, 1), {}),
    ("warmup_cosine", (3e-4, 20, 200), {}),
    ("warmup_cosine", (1e-3, 0, 50), dict(final_frac=0.0)),
    ("warmup_cosine", (2.5e-3, 100, 1000), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{n}-{'-'.join(map(str, a))}" for n, a, _ in SCHEDULES])
def test_schedules_are_the_references(name, args, kw):
    steps = np.arange(0, 1200)
    want = np.asarray(getattr(j_schedule, name)(*args, **kw)(steps), np.float32)
    fn = getattr(t_schedule, name)(*args, **kw)
    got = fn(torch.as_tensor(steps)).numpy()
    assert got.dtype == np.float32 and fn(7).dtype == torch.float32 and fn(7).shape == ()
    ulp = np.spacing(np.float32(args[0])) if name == "warmup_cosine" else np.spacing(np.abs(want))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)


def test_the_registry_is_the_references_and_carries_gpt2():
    from repro.configs import ARCHITECTURES as J_ARCH
    from repro.configs import get_config as j_config

    assert list(ARCHITECTURES) == list(J_ARCH)
    for get, j_get in ((get_config, j_config), (get_smoke_config, j_smoke)):
        assert get("gpt2-paper").name == j_get("gpt2-paper").name
    with pytest.raises(KeyError):
        get_config("gpt2-xl")


@pytest.mark.parametrize("arch,vocab", [
    pytest.param("internvl2-76b", 512, id="train-arch"),
    pytest.param("seamless-m4t-large-v2", 512, id="serve-arch"),
])
def test_the_launchers_carry_the_vlm_and_audio(arch, vocab, monkeypatch, tmp_path):
    """``train --arch`` and ``serve --arch`` of the VLM and the audio smoke
    configs (each case was the refusal of its call), held to the
    reference's CLIs as the GPT-2 pair is."""
    monkeypatch.setattr(t_frontends, "synth_frontend_embeddings", reference_draw)
    _train_losses_held(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32"],
                       monkeypatch, tmp_path, arch)
    _serve_held(monkeypatch, vocab=vocab, arch=arch)


# every id resolves and every family runs, in fp32, bf16 and fp16; a dtype
# name outside those is refused when a model is built, before anything is
# drawn (the registry cases build one: seamless is audio, internvl2 a VLM)
@pytest.mark.parametrize("call,exc,match", [
    pytest.param(lambda: t_serve.model_init(get_config("seamless-m4t-large-v2").with_overrides(
        param_dtype="float64"), 0, "cpu"), ValueError, "param_dtype='float64'", id="registry"),
    pytest.param(lambda: t_serve.model_init(get_smoke_config("internvl2-76b").with_overrides(
        compute_dtype="float64"), 0, "cpu"), ValueError, "compute_dtype='float64'",
        id="smoke-registry"),
    pytest.param(lambda: t_train.main(["--production", "--device", "cpu"]), SystemExit,
                 r"16x16 production mesh of 256 cards.*repro_torch\.launch\.dryrun",
                 id="train-production"),
])
def test_what_the_launchers_do_not_carry_raises(call, exc, match):
    with pytest.raises(exc, match=match):
        call()
