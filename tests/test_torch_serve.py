"""The port's serving path — decode cache, decode step, prefill (the chunked
attention from S = 1024 on), the adapter slab and cache, the session and
the fleet-store export — against the JAX reference, on the CPU.

A 2-layer d 64 vocab 256 config with LoRA on q, v, o and the LM head (the
config of ``tests/test_serve.py``); the JAX init with live B factors is
bridged into the port, and every tenant's adapter has A and B drawn from a
numpy seed.  Logits are held within 1e-5 of their largest magnitude (fp32
matmuls of either framework, summed in another order).  The reference's
own claim that a stacked multi-tenant decode is bit-identical to each
request run alone does not hold on this tree (its test fails), so the port
holds its stacked decode against its solo decodes within the same bound,
and against the reference's stacked decode: the reference's greedy tokens
are fed to the port so a last-bit difference cannot send the two down
different paths, the logits agree at every step, and the port's own greedy
tokens equal the reference's.  Cache hit, miss and eviction counts and slot
maps are integers and must be identical.  Sampling at ``temperature > 0``
draws from a ``torch.Generator`` and cannot match ``jax.random``'s draws:
it is checked for determinism under its seed only.

An attention-free model (mamba2's smoke config at d 64, vocab 256) serves
through the same session: its tenants carry the head adapter alone, its
decode cache is the conv histories and the fp32 SSM state, and it is held
to the reference's session and its stacked decode to solo decodes at the
same bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.lora import lora_template as j_template  # noqa: E402
from repro.lora import merge_lora as j_merge  # noqa: E402
from repro.lora import split_lora as j_split  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.serve import AdapterCache as JCache  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSession as JSession  # noqa: E402
from repro.serve import make_prefill_step as j_prefill_step  # noqa: E402
from repro.serve.adapters import gather_adapters as j_gather  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.fed.store import DeviceFleetStore  # noqa: E402
from repro_torch.lora import lora_template, map_lora, merge_lora, split_lora  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdapterCache,
    ServeConfig,
    ServeSession,
    export_adapters,
    make_prefill_step,
    make_stacked_decode_step,
    serving_params,
)
from repro_torch.serve.export import MonolithicSource, ShardDirSource  # noqa: E402

_SHAPE = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
              max_seq_len=64)
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "o", "head"))
JCFG = J_RC.with_overrides(**_SHAPE, lora=JLoRA(**_LORA))
TCFG = T_RC.with_overrides(**_SHAPE, lora=TLoRA(**_LORA))
# one layer at S = 1024: the reference's chunked-attention branch
_LONG = dict(_SHAPE, num_layers=1, max_seq_len=1024)
J_LONG = J_RC.with_overrides(**_LONG, lora=JLoRA(**_LORA))
T_LONG = T_RC.with_overrides(**_LONG, lora=TLoRA(**_LORA))
N_TENANTS, PROMPT, GEN = 5, 4, 6


def _close(t, j, rel=1e-5):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * max(np.abs(j).max(), 1e-30))


def _jax_params(cfg, seed=0):
    """The reference init with live (non-zero) LoRA B factors."""
    rng = np.random.default_rng(seed)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(live_b, j_init(jax.random.PRNGKey(seed), cfg))


def _to_port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _adapter_rows(jparams, n=N_TENANTS, seed=7):
    """n tenants' adapters, A and B both drawn nonzero, as reference rows
    (``split_lora`` structure) and port rows (flat dicts)."""
    rng = np.random.default_rng(seed)
    lora, _ = j_split(jparams)
    j_rows = [jax.tree.map(lambda x: jnp.asarray(0.05 * rng.normal(size=x.shape).astype(np.float32)),
                           lora) for _ in range(n)]
    return j_rows, [_to_port(r) for r in j_rows]


class ListSource:
    def __init__(self, rows):
        self.rows = list(rows)
        self.num_adapters = len(rows)

    def lora_row(self, cid):
        return self.rows[int(cid)]


@pytest.fixture(scope="module")
def model():
    jp = _jax_params(JCFG)
    j_rows, t_rows = _adapter_rows(jp)
    return jp, _to_port(jp), j_rows, t_rows


def _prompts(batch, length=PROMPT, seed=3, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, length)).astype(np.int32)


def test_init_cache_matches_reference():
    j_cache = j_init_cache(JCFG, 3, 8)
    t_cache = t_init_cache(TCFG, 3, 8, device="cpu")
    j_kv, t_kv = j_cache["layers"]["pos0"], t_cache["layers"]["pos0"]
    for field in ("k", "v", "pos", "length"):
        np.testing.assert_array_equal(getattr(t_kv, field).numpy(), np.asarray(getattr(j_kv, field)))
    assert int(t_cache["length"]) == int(j_cache["length"]) == 0
    assert t_kv.pos.dtype == torch.int32


@pytest.mark.parametrize("mode", ["single", "stacked"])
def test_decode_step_matches_reference(model, mode):
    """Ten tokens through a cache of eight slots (the ring wraps), one
    model's params or per-request adapters from a slab: logits at every
    step and the final cache."""
    jp, tp, j_rows, t_rows = model
    batch, steps = 3, 10
    ids = [4, 1, 1]
    if mode == "single":
        j_params, t_params = jp, tp
    else:
        j_cache_ad = JCache(ListSource(j_rows), like=j_template(jp), slots=4)
        t_cache_ad = AdapterCache(ListSource(t_rows), like=lora_template(tp), slots=4, device="cpu")
        j_slots, t_slots = j_cache_ad.lookup(ids), t_cache_ad.lookup(ids)
        np.testing.assert_array_equal(t_slots, j_slots)
        j_params = j_merge(j_gather(j_cache_ad.slab, jnp.asarray(j_slots)), j_split(jp)[1])
        t_step = make_stacked_decode_step(TCFG)
        _, t_frozen = split_lora(tp)
    j_cache, t_cache = j_init_cache(JCFG, batch, 8), t_init_cache(TCFG, batch, 8, device="cpu")
    toks = _prompts(batch, steps, seed=9)
    for t in range(steps):
        j_logits, j_cache = j_decode(j_params, JCFG, j_cache, jnp.asarray(toks[:, t]))
        tok = torch.as_tensor(toks[:, t]).long()
        if mode == "single":
            t_logits, t_cache = t_decode(t_params, TCFG, t_cache, tok)
        else:
            t_logits, t_cache = t_step(t_frozen, t_cache_ad.slab, torch.as_tensor(t_slots).long(),
                                       t_cache, tok)
        _close(t_logits.numpy(), j_logits)
    j_kv, t_kv = j_cache["layers"]["pos0"], t_cache["layers"]["pos0"]
    _close(t_kv.k.numpy(), j_kv.k)
    _close(t_kv.v.numpy(), j_kv.v)
    np.testing.assert_array_equal(t_kv.pos.numpy(), np.asarray(j_kv.pos))
    np.testing.assert_array_equal(t_kv.length.numpy(), np.asarray(j_kv.length))
    assert int(t_cache["length"]) == int(j_cache["length"]) == steps


# granite's smoke config (4 experts, top-2, d 256) with LoRA on q, v and the head
_MOE_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
J_MOE = j_smoke("granite-moe-1b-a400m").with_overrides(lora=JLoRA(**_MOE_LORA))
T_MOE = get_smoke_config("granite-moe-1b-a400m").with_overrides(lora=TLoRA(**_MOE_LORA))


def _reference_drops(into: list):
    """A wrapper for the reference's ``moe_apply`` that appends, for every
    call, how many (token, slot) choices its router sent past an expert's
    capacity (its own expression, groups of ``min(1024, B·S)``)."""
    def wrap(moe_apply):
        def call(params, x, cfg):
            moe = cfg.moe
            b, s, d = x.shape
            tg = min(1024, b * s)
            probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", x.reshape(-1, tg, d),
                                              params["router"]["w"]).astype(jnp.float32), axis=-1)
            _, idx = jax.lax.top_k(probs, moe.top_k)
            cap = min(int(max(4, round(moe.capacity_factor * moe.top_k * tg / moe.num_experts))),
                      tg)
            per_expert = jax.nn.one_hot(idx, moe.num_experts).sum(axis=(1, 2))  # (G, E)
            jax.debug.callback(lambda n: into.append(int(n)),
                               jnp.maximum(per_expert - cap, 0).sum())
            return moe_apply(params, x, cfg)

        return call

    return wrap


@pytest.mark.parametrize("batch", [1, 8])
def test_stacked_moe_decode_matches_reference(batch, monkeypatch):
    """The stacked decode of an MoE model routes the batch's tokens as ONE
    group set over the shared experts, as the reference's stacked step
    does: five tenants through each package's ``AdapterCache``, ten steps,
    the port's logits within 1e-5 of the reference's largest at every step.
    At batch 8 the reference's router sends choices past an expert's
    capacity, so the case covers the drops that routing each request alone
    would never make."""
    import repro.models.transformer as j_transformer

    drops: list = []
    monkeypatch.setattr(j_transformer, "moe_apply", _reference_drops(drops)(
        j_transformer.moe_apply))
    jp = _jax_params(J_MOE, seed=2)
    j_rows, t_rows = _adapter_rows(jp)
    tp = _to_port(jp)
    ids = [0, 1, 2, 3, 4, 0, 2, 4][:batch]
    j_cache_ad = JCache(ListSource(j_rows), like=j_template(jp), slots=N_TENANTS)
    t_cache_ad = AdapterCache(ListSource(t_rows), like=lora_template(tp), slots=N_TENANTS,
                              device="cpu")
    j_slots, t_slots = j_cache_ad.lookup(ids), t_cache_ad.lookup(ids)
    np.testing.assert_array_equal(t_slots, j_slots)
    j_params = j_merge(j_gather(j_cache_ad.slab, jnp.asarray(j_slots)), j_split(jp)[1])
    t_step, (_, t_frozen) = make_stacked_decode_step(T_MOE), split_lora(tp)
    j_cache, t_cache = j_init_cache(J_MOE, batch, 16), t_init_cache(T_MOE, batch, 16, device="cpu")
    toks = _prompts(batch, 10, seed=5, vocab=J_MOE.vocab_size)
    for t in range(10):
        j_logits, j_cache = j_decode(j_params, J_MOE, j_cache, jnp.asarray(toks[:, t]))
        t_logits, t_cache = t_step(t_frozen, t_cache_ad.slab, torch.as_tensor(t_slots).long(),
                                   t_cache, torch.as_tensor(toks[:, t]).long())
        _close(t_logits.numpy(), j_logits)
    assert len(drops) == 10 * J_MOE.num_layers
    assert (max(drops) > 0) == (batch == 8), drops


@pytest.mark.parametrize("long", [False, True], ids=["dense-S12", "chunked-S1024"])
def test_prefill_matches_reference(model, long):
    if long:
        jp = _jax_params(J_LONG, seed=1)
        tp, jcfg, tcfg, tokens = _to_port(jp), J_LONG, T_LONG, _prompts(1, 1024, vocab=256)
    else:
        jp, tp = model[0], model[1]
        jcfg, tcfg, tokens = JCFG, TCFG, _prompts(3, 12)
    j_logits = j_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(tokens)})
    t_logits = make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(tokens).long()})
    assert t_logits.shape == (tokens.shape[0], 256)
    _close(t_logits.numpy(), j_logits)


def test_chunked_attention_is_the_dense_attention():
    """At S = 1024 the chunked path computes the dense path's function."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 1024, 2, 32)).astype(np.float32))
               for _ in range(3))
    chunked = t_attn._chunked_attention(q, k, v)
    dense = t_attn._dense_attention(q, k, v)
    assert chunked.shape == (2, 1024, 64)
    _close(chunked.numpy(), dense.numpy(), rel=1e-6)


def _sessions(model, batch, slots):
    jp, tp, j_rows, t_rows = model
    j_sess = JSession(JServeConfig(model=JCFG, batch=batch, cache_len=PROMPT + GEN), jp,
                      adapters=JCache(ListSource(j_rows), like=j_template(jp), slots=slots))
    t_sess = ServeSession(ServeConfig(model=TCFG, batch=batch, cache_len=PROMPT + GEN), tp,
                          adapters=AdapterCache(ListSource(t_rows), like=lora_template(tp),
                                                slots=slots, device="cpu"),
                          device="cpu")
    return j_sess, t_sess


def test_session_matches_reference(model):
    """Two tenant mixes (the second pages in through eviction): the same
    slot maps and cache stats, the logits at every step with the
    reference's tokens fed to both, and the same greedy tokens."""
    batch = 4
    j_sess, t_sess = _sessions(model, batch, slots=3)
    prompts = _prompts(batch)
    for ids in ([0, 2, 2, 1], [3, 2, 4, 4]):
        np.testing.assert_array_equal(t_sess.attach(ids), j_sess.attach(ids))
        j_toks, _ = (j_sess.prefill(prompts), j_sess.decode(GEN))[1]
        j_sess.attach(ids)  # replay the reference run step by step for its logits
        j_logits = [np.asarray(j_sess.prefill(prompts))]
        j_logits += [np.asarray(j_sess.step(j_toks[:, i])) for i in range(GEN)]
        t_logits = [t_sess.prefill(prompts).numpy()]
        t_logits += [t_sess.step(j_toks[:, i]).numpy() for i in range(GEN)]
        for t, j in zip(t_logits, j_logits):
            _close(t, j)
        t_sess.attach(ids)
        t_sess.prefill(prompts)
        t_toks, _ = t_sess.decode(GEN)
        np.testing.assert_array_equal(t_toks, j_toks)
        assert t_toks.dtype == np.int32 and t_toks.shape == (batch, GEN)
    j_stats, t_stats = j_sess.stats(), t_sess.stats()
    assert t_stats["adapter_cache"] == j_stats["adapter_cache"]
    assert t_stats["resident_adapters"] == j_stats["resident_adapters"]
    assert t_stats["adapter_cache"]["evictions"] >= 1
    assert t_stats["executables"] == {"single": 0, "stacked": 1}
    assert t_stats["tokens_decoded"] == j_stats["tokens_decoded"]


def test_stacked_decode_matches_each_request_alone(model):
    """Each request of a stacked batch against the same request alone
    (batch 1) with its adapter merged into the params, the stacked run's
    tokens fed to the solo run."""
    jp, tp, _, t_rows = model
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
    for b, cid in enumerate(ids):
        solo = ServeSession(ServeConfig(model=TCFG, batch=1, cache_len=PROMPT + GEN),
                            merge_lora(t_rows[cid], frozen), device="cpu")
        solo_logits = [solo.prefill(prompts[b:b + 1])]
        solo_logits += [solo.step(toks[b:b + 1, i]) for i in range(GEN - 1)]
        for s, st in zip(solo_logits, logits):
            _close(s[0].numpy(), st[b].numpy())
        assert solo.stats()["executables"] == {"single": 1, "stacked": 0}


@pytest.mark.parametrize("slots,batches", [
    pytest.param(2, [[0, 1], [0, 1], [0, 2], [2, 2]], id="lru-eviction-and-duplicates"),
    pytest.param(2, [[0, 1], [0, 2]], id="pinned-slot-survives"),
    pytest.param(1, [[0], [1], [0], [1]], id="capacity-one-thrash"),
])
def test_adapter_cache_matches_reference(model, slots, batches):
    jp, tp, j_rows, t_rows = model
    j_cache = JCache(ListSource(j_rows), like=j_template(jp), slots=slots)
    t_cache = AdapterCache(ListSource(t_rows), like=lora_template(tp), slots=slots, device="cpu")
    for ids in batches:
        np.testing.assert_array_equal(t_cache.lookup(ids), j_cache.lookup(ids))
        assert t_cache.stats.as_dict() == j_cache.stats.as_dict()
        assert t_cache.resident() == j_cache.resident()
    for cid in t_cache.resident():  # the paged rows are the tenants' adapters
        slot = t_cache.lookup([cid])[0]
        for k, v in t_rows[cid].items():
            assert torch.equal(t_cache.slab[k][slot], v)
    too_many = list(range(slots + 1))
    with pytest.raises(ValueError, match="distinct adapters"):
        t_cache.lookup(too_many)
    with pytest.raises(ValueError, match="distinct adapters"):
        j_cache.lookup(too_many)


def test_export_from_a_live_fleet_store(model):
    jp, tp, _, t_rows = model
    lora, frozen = split_lora(tp)
    store = DeviceFleetStore(t_rows, [frozen] * len(t_rows), shared=True)
    src = export_adapters(store)
    assert src.num_adapters == len(t_rows)
    for cid in (0, 3):
        row = src.lora_row(cid)
        assert set(row) == set(t_rows[cid])
        assert all(torch.equal(row[k], t_rows[cid][k]) for k in row)
    fresh = t_model.init(TCFG, 5, "cpu")
    params = serving_params(src, fresh)
    for k, v in params.items():
        assert torch.equal(v, fresh[k] if "lora" in k else frozen[k]), k
    # a tenant paged from the store decodes as that tenant's merged params
    cache = AdapterCache(src, like=lora_template(params), slots=2, device="cpu")
    sess = ServeSession(ServeConfig(model=TCFG, batch=2, cache_len=PROMPT + GEN), params,
                        adapters=cache, device="cpu")
    sess.attach([3, 0])
    stacked = sess.prefill(_prompts(2))
    solo = ServeSession(ServeConfig(model=TCFG, batch=2, cache_len=PROMPT + GEN),
                        merge_lora(t_rows[3], frozen), device="cpu").prefill(_prompts(2))
    _close(stacked[0].numpy(), solo[0].numpy())
    # a per-client backbone has no shared tree to serve against
    per_client = DeviceFleetStore(t_rows[:2], [frozen, map_lora(lambda x: x, frozen)], shared=False)
    with pytest.raises(ValueError, match="PER-CLIENT backbone"):
        export_adapters(per_client).frozen_tree()


def test_checkpoint_sources_refuse_what_is_not_a_checkpoint(tmp_path):
    """A directory with no shards and no step file, a missing step file, a
    source that is not a store or a path (serving from real checkpoints:
    ``tests/test_torch_ckpt.py``)."""
    for make in (lambda: export_adapters(str(tmp_path)), lambda: ShardDirSource(str(tmp_path)),
                 lambda: export_adapters(str(tmp_path / "step_00000001.npz"))):
        with pytest.raises(FileNotFoundError):
            make()
    with pytest.raises(FileNotFoundError):
        MonolithicSource(str(tmp_path / "step_00000001.npz"))
    with pytest.raises(TypeError):
        export_adapters(42)


def test_sampling_is_seeded(model):
    """``temperature > 0`` draws from the session's ``torch.Generator``:
    the same seed gives the same tokens (the draws cannot match
    ``jax.random.categorical``'s)."""
    _, tp, _, _ = model
    outs = []
    for seed in (1, 1, 2):
        sess = ServeSession(ServeConfig(model=TCFG, batch=3, cache_len=PROMPT + GEN,
                                        temperature=1.5, seed=seed), tp, device="cpu")
        sess.prefill(_prompts(3))
        outs.append(sess.decode(GEN)[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert all(((o >= 0) & (o < 256)).all() for o in outs)
    assert not np.array_equal(outs[0], outs[2])


def test_serving_refuses_what_the_port_does_not_carry(model):
    _, tp, _, _ = model
    # a sliding window, an SSM decode cache and an audio model's (the fixed
    # encoder output beside the layers' caches) serve now, in fp16 too; a
    # dtype the port does not take (float64) does not
    audio = get_smoke_config("seamless-m4t-large-v2")
    cache = t_init_cache(audio, 2, 8, window=4, device="cpu")
    assert tuple(cache["enc_out"].shape) == (2, audio.frontend_len, audio.d_model)
    assert cache["layers"]["pos0"].k.shape[2] == 4
    half = t_init_cache(audio.with_overrides(compute_dtype="float16"), 2, 8, window=4, device="cpu")
    assert half["layers"]["pos0"].k.dtype == torch.float16
    with pytest.raises(ValueError, match="compute_dtype='float64'"):
        t_init_cache(audio.with_overrides(compute_dtype="float64"), 2, 8, window=4, device="cpu")
    sess = ServeSession(ServeConfig(model=TCFG, batch=1, cache_len=PROMPT + GEN), tp, device="cpu")
    with pytest.raises(ValueError, match="AdapterCache"):
        sess.attach([0])
    with pytest.raises(RuntimeError, match="prefill"):
        sess.decode(1)


# -- an attention-free model: the SSM decode cache and head-only adapters ------------------------

_SSM_SHAPE = dict(d_model=64, vocab_size=256, max_seq_len=64)
J_SSM = j_smoke("mamba2-130m").with_overrides(
    **_SSM_SHAPE, lora=JLoRA(**_LORA), ssm=JSSM(state_dim=16, head_dim=16, expand=2, chunk_size=4))
T_SSM = get_smoke_config("mamba2-130m").with_overrides(
    **_SSM_SHAPE, lora=TLoRA(**_LORA), ssm=TSSM(state_dim=16, head_dim=16, expand=2, chunk_size=4))


@pytest.fixture(scope="module")
def ssm_model():
    jp = _jax_params(J_SSM, seed=2)
    j_rows, t_rows = _adapter_rows(jp, seed=8)
    return jp, _to_port(jp), j_rows, t_rows


def _ssm_sessions(ssm_model, batch, slots):
    jp, tp, j_rows, t_rows = ssm_model
    j_sess = JSession(JServeConfig(model=J_SSM, batch=batch, cache_len=PROMPT + GEN), jp,
                      adapters=JCache(ListSource(j_rows), like=j_template(jp), slots=slots))
    t_sess = ServeSession(ServeConfig(model=T_SSM, batch=batch, cache_len=PROMPT + GEN), tp,
                          adapters=AdapterCache(ListSource(t_rows), like=lora_template(tp),
                                                slots=slots, device="cpu"),
                          device="cpu")
    return j_sess, t_sess


def test_ssm_session_matches_reference(ssm_model):
    """An SSM model's tenants carry the head adapter alone (the slab has no
    stack leaves); its decode cache is the conv histories and the fp32
    state.  The session against the reference's, as for the attention
    model: slot maps, the logits at every step with the reference's tokens
    fed to both, the greedy tokens, and the final cache."""
    jp, tp, _, t_rows = ssm_model
    assert set(t_rows[0]) == {"lora_head/A", "lora_head/B"}
    j_cache, t_cache = j_init_cache(J_SSM, 3, 8), t_init_cache(T_SSM, 3, 8, device="cpu")
    for field in ("conv_x", "conv_bc", "state"):
        np.testing.assert_array_equal(getattr(t_cache["layers"]["pos0"], field).numpy(),
                                      np.asarray(getattr(j_cache["layers"]["pos0"], field)))
    assert t_cache["layers"]["pos0"].state.dtype == torch.float32
    batch, ids = 4, [0, 2, 2, 1]
    j_sess, t_sess = _ssm_sessions(ssm_model, batch, slots=3)
    prompts = _prompts(batch)
    np.testing.assert_array_equal(t_sess.attach(ids), j_sess.attach(ids))
    j_toks, _ = (j_sess.prefill(prompts), j_sess.decode(GEN))[1]
    j_sess.attach(ids)
    j_logits = [np.asarray(j_sess.prefill(prompts))]
    j_logits += [np.asarray(j_sess.step(j_toks[:, i])) for i in range(GEN)]
    t_logits = [t_sess.prefill(prompts).numpy()]
    t_logits += [t_sess.step(j_toks[:, i]).numpy() for i in range(GEN)]
    for t, j in zip(t_logits, j_logits):
        _close(t, j)
    for field in ("conv_x", "conv_bc", "state"):
        _close(getattr(t_sess._cache["layers"]["pos0"], field).numpy(),
               getattr(j_sess._cache["layers"]["pos0"], field))
    t_sess.attach(ids)
    t_sess.prefill(prompts)
    np.testing.assert_array_equal(t_sess.decode(GEN)[0], j_toks)


def test_ssm_stacked_decode_matches_each_request_alone(ssm_model):
    """Each request of a stacked SSM batch against the same request alone
    with its head adapter merged, the stacked run's tokens fed to the solo
    run: within 1e-5 of the largest logit, the bound of the attention
    model (the reference's bitwise claim, its ``[ssm]`` case, fails on this
    tree)."""
    _, tp, _, t_rows = ssm_model
    ids = [0, 3, 3, 1]
    _, t_sess = _ssm_sessions(ssm_model, len(ids), slots=4)
    prompts = _prompts(len(ids))
    t_sess.attach(ids)
    logits = [t_sess.prefill(prompts)]
    toks, _ = t_sess.decode(GEN)
    t_sess.attach(ids)
    t_sess.prefill(prompts)
    logits += [t_sess.step(toks[:, i]) for i in range(GEN - 1)]
    _, frozen = split_lora(tp)
    for b, cid in enumerate(ids):
        solo = ServeSession(ServeConfig(model=T_SSM, batch=1, cache_len=PROMPT + GEN),
                            merge_lora(t_rows[cid], frozen), device="cpu")
        solo_logits = [solo.prefill(prompts[b:b + 1])]
        solo_logits += [solo.step(toks[b:b + 1, i]) for i in range(GEN - 1)]
        for s, st in zip(solo_logits, logits):
            _close(s[0].numpy(), st[b].numpy())
