"""Audio serving and an audio fleet's checkpoint, the port against the JAX
reference, on the CPU.

seamless-smoke at d 64 (a 2-layer bidirectional encoder over 8 stub frames
and a 2-layer decoder with cross-attention, GQA 4/2, vocab 256) with LoRA
on q, v and the head: the encoder's adapters are adapters like the
decoder's.  The reference's init with live B factors is bridged into the
port, every tenant's adapter (the encoder's included) has A and B drawn
from a numpy seed, and the port's stub frontend is the reference's draw
(``_torch_modal``).  Logits are held within 1e-5 of their largest
magnitude, the bound of ``tests/test_torch_serve.py``.

* ``ServeSession.reset`` runs the encoder once on the session's own params
  (tenants attached or not, as the reference does) and keeps its output in
  the cache; the session against the reference's, attached to 3 tenants:
  slot maps identical, the cache's ``enc_out`` and the logits at every
  step (the reference's greedy tokens fed to both) within the bound, the
  greedy tokens equal; a given frontend is encoded instead of the stub.
* The stacked decode against each request run alone with its adapter
  merged (the encoder's adapters the session's own) on its own frames of
  the batch's stub, within the bound.
* The adapter template, the slab and the export carry the encoder's
  adapters, as the reference's ``split_lora`` does.
* The reference resumes an audio fleet's checkpoint that the port wrote
  after round 1 (its encoder adapters and AdamW state among the leaves)
  to the port's uninterrupted 2-round run: per-client k, bytes and
  transmitters identical, accuracies within one eval sample (1/64), the
  distill loss within rtol 1e-4.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_frontend  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.lora import lora_template as j_template  # noqa: E402
from repro.lora import split_lora as j_split  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.serve import AdapterCache as JCache  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.store import DeviceFleetStore  # noqa: E402
from repro_torch.lora import lora_template, merge_lora, split_lora  # noqa: E402
from repro_torch.models import frontends as t_frontends  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve import AdapterCache, ServeConfig, ServeSession, export_adapters  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_SHAPE = dict(name="audio-serve", d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=64, frontend_len=8)
JCFG = j_smoke("seamless-m4t-large-v2").with_overrides(**_SHAPE, lora=JLoRA(**_LORA))
TCFG = get_smoke_config("seamless-m4t-large-v2").with_overrides(**_SHAPE, lora=TLoRA(**_LORA))
_SERVER = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
               max_seq_len=32)
J_SERVER = J_RS.with_overrides(**_SERVER, lora=JLoRA(**_LORA))
T_SERVER = T_RS.with_overrides(**_SERVER, lora=TLoRA(**_LORA))
N_TENANTS, PROMPT, GEN = 5, 4, 6
EVAL = 64


def _close(t, j, rel=1e-5):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * max(np.abs(j).max(), 1e-30))


def _to_port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


class ListSource:
    def __init__(self, rows):
        self.rows = list(rows)
        self.num_adapters = len(rows)

    def lora_row(self, cid):
        return self.rows[int(cid)]


@pytest.fixture(scope="module")
def model():
    """The reference init with live B factors, and N_TENANTS adapters with A
    and B drawn from a numpy seed, as reference and port rows."""
    rng = np.random.default_rng(0)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape).astype(np.float32))
        return x

    jp = jax.tree_util.tree_map_with_path(live_b, j_init(jax.random.PRNGKey(0), JCFG))
    lora, _ = j_split(jp)
    j_rows = [jax.tree.map(lambda x: jnp.asarray(0.05 * rng.normal(size=x.shape).astype(
        np.float32)), lora) for _ in range(N_TENANTS)]
    return jp, _to_port(jp), j_rows, [_to_port(r) for r in j_rows]


def _prompts(batch, length=PROMPT, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (batch, length)).astype(np.int32)


def _sessions(model, batch, slots):
    jp, tp, j_rows, t_rows = model
    j_sess = JSession(JServeConfig(model=JCFG, batch=batch, cache_len=PROMPT + GEN), jp,
                      adapters=JCache(ListSource(j_rows), like=j_template(jp), slots=slots))
    t_sess = ServeSession(ServeConfig(model=TCFG, batch=batch, cache_len=PROMPT + GEN), tp,
                          adapters=AdapterCache(ListSource(t_rows), like=lora_template(tp),
                                                slots=slots, device="cpu"),
                          device="cpu")
    return j_sess, t_sess


def test_the_adapters_carry_the_encoders(model):
    jp, tp, _, t_rows = model
    want = set(bridge.flatten(jax.tree.map(np.asarray, j_split(jp)[0])))
    assert set(lora_template(tp)) == set(t_rows[0]) == want
    assert any(k.startswith("encoder/") for k in want)
    _, frozen = split_lora(tp)
    store = DeviceFleetStore(t_rows, [frozen] * N_TENANTS, shared=True)
    src = export_adapters(store)
    row = src.lora_row(3)
    assert set(row) == want and all(torch.equal(row[k], t_rows[3][k]) for k in row)
    cache = AdapterCache(src, like=lora_template(tp), slots=2, device="cpu")
    slot = int(cache.lookup([3])[0])
    assert all(torch.equal(cache.slab[k][slot], t_rows[3][k]) for k in want)


def test_audio_session_matches_reference(model):
    batch, ids = 4, [0, 2, 2, 1]
    j_sess, t_sess = _sessions(model, batch, slots=3)
    prompts = _prompts(batch)
    np.testing.assert_array_equal(t_sess.attach(ids), j_sess.attach(ids))
    j_toks, _ = (j_sess.prefill(prompts), j_sess.decode(GEN))[1]
    j_sess.attach(ids)
    j_logits = [np.asarray(j_sess.prefill(prompts))]
    j_logits += [np.asarray(j_sess.step(j_toks[:, i])) for i in range(GEN)]
    t_logits = [t_sess.prefill(prompts).numpy()]
    _close(t_sess._cache["enc_out"].numpy(), j_sess._cache["enc_out"])
    t_logits += [t_sess.step(j_toks[:, i]).numpy() for i in range(GEN)]
    for t, j in zip(t_logits, j_logits):
        _close(t, j)
    t_sess.attach(ids)
    t_sess.prefill(prompts)
    np.testing.assert_array_equal(t_sess.decode(GEN)[0], j_toks)
    # a given frontend is what the encoder reads
    frames = np.random.default_rng(4).normal(size=(batch, 8, 64)).astype(np.float32)
    j_sess.reset(frontend=jnp.asarray(frames))
    t_sess.reset(frontend=torch.as_tensor(frames))
    _close(t_sess._cache["enc_out"].numpy(), j_sess._cache["enc_out"])
    want = t_model._run_encoder(model[1], TCFG, torch.as_tensor(frames)[None])[0]
    assert torch.equal(t_sess._cache["enc_out"], want)


def test_audio_stacked_decode_matches_each_request_alone(model):
    _, tp, _, t_rows = model
    ids = [0, 3, 3, 1]
    _, t_sess = _sessions(model, len(ids), slots=4)
    prompts = _prompts(len(ids))
    t_sess.attach(ids)
    logits = [t_sess.prefill(prompts)]
    toks, _ = t_sess.decode(GEN)
    t_sess.attach(ids)
    t_sess.prefill(prompts)
    logits += [t_sess.step(toks[:, i]) for i in range(GEN - 1)]
    _, frozen = split_lora(tp)
    frames = t_frontends.synth_frontend_embeddings(TCFG, len(ids), device="cpu")
    for b, cid in enumerate(ids):
        # the encoder runs on the session's own params, so the solo session
        # keeps tp's encoder adapters under the tenant's decoder adapters,
        # and it encodes the request's own frames of the batch's stub
        own = {k: (tp[k] if k.startswith("encoder/") else v) for k, v in t_rows[cid].items()}
        solo = ServeSession(ServeConfig(model=TCFG, batch=1, cache_len=PROMPT + GEN),
                            merge_lora(own, frozen), device="cpu")
        solo.reset(frontend=frames[b:b + 1])
        solo_logits = [[solo.step(prompts[b:b + 1, t]) for t in range(PROMPT)][-1]]
        solo_logits += [solo.step(toks[b:b + 1, i]) for i in range(GEN - 1)]
        for s, st in zip(solo_logits, logits):
            _close(s[0].numpy(), st[b].numpy())


# -- an audio fleet's checkpoint, written by the port and resumed by the reference ------------


def _fed(cls, rounds):
    return cls(method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2,
               rounds=rounds, public_size=64, public_batch=16, eval_size=EVAL, local_steps=1,
               distill_steps=1, server_distill_steps=2, seed=0, pretrain_steps=1,
               server_pretrain_steps=1)


def test_the_reference_resumes_an_audio_fleets_checkpoint(tmp_path):
    def bridged(cfg, seed, device="cuda", **_):
        tree = j_init(jax.random.PRNGKey(seed), {TCFG: JCFG, T_SERVER: J_SERVER}[cfg])
        return bridge.to_torch(jax.tree.map(np.asarray, tree), device)

    ckpt = str(tmp_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", bridged)
    try:
        want = t_rounds.run_federated(TCFG, T_SERVER, t_dataset(vocab_size=256, seq_len=12,
                                                                total=400, seed=0),
                                      _fed(TFed, 2), ckpt_dir=ckpt, device="cpu")
    finally:
        mp.undo()
    for name in os.listdir(ckpt):  # keep the checkpoint after round 1
        if name.startswith("step_00000002"):
            os.remove(os.path.join(ckpt, name))
    with np.load(os.path.join(ckpt, "step_00000001.npz")) as f:
        assert any(k.startswith("fleet__lora__encoder__pos0__lora") for k in f.files)
        assert any(k.startswith("fleet__opt__m__encoder__pos0__lora") for k in f.files)
    got = j_rounds.run_federated(JCFG, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=400,
                                                           seed=0),
                                 _fed(JFed, 2), ckpt_dir=ckpt, resume=True)
    assert got.client_acc[0] == want.client_acc[0]  # round 0 came from the checkpoint
    assert got.per_client_k == want.per_client_k
    for t, j in zip(want.ledger.rounds, got.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes, t.num_transmitters) == (
            j.uplink_bytes, j.downlink_bytes, j.num_transmitters)
    np.testing.assert_allclose(got.server_acc, want.server_acc, rtol=0, atol=1 / EVAL + 1e-9)
    np.testing.assert_allclose(got.client_acc, want.client_acc, rtol=0, atol=1 / EVAL + 1e-9)
    np.testing.assert_allclose(got.distill_loss[1:], want.distill_loss[1:], rtol=1e-4)
