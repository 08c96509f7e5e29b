"""The port's VLM and audio encoder-decoder models against the JAX
reference, on the CPU.

internvl2-smoke (the VLM: 16 stub patches prepended to the text, RoPE,
RMSNorm, SwiGLU, GQA 4/2) and seamless-smoke (the audio encoder-decoder: a
2-layer bidirectional encoder over 16 stub frames and a 2-layer decoder
that cross-attends to it), each with LoRA on q, v and the head, the
reference's init bridged into the port.  The port's stub frontend is the
reference's draw while this module runs (``_torch_modal``).

* The init has the reference's keys and shapes (smoke configs drawn; the
  full configs through ``jax.eval_shape`` against ``meta`` tensors), the
  encoder's adapters among the adapters; the port's init crosses the
  bridge to the reference, which computes the port's logits from it, and
  back leaf for leaf.
* forward (the stub frontend and a given one), ``backbone`` with
  ``last_only``, prefill, ``_run_encoder``, the non-causal self-attention
  (dense and chunked), cross-attention with GQA, ``init_cache`` with and
  without ``enc_out`` and decode steps, against the reference at rtol 1e-4
  / atol 1e-5 (``RTOL``/``ATOL``, the model tests' bound).  The VLM's
  decode is held to the reference's ``decode_step``, as the reference's
  own test skips it against a forward; the audio decode also to its own
  forward within 2e-3, the reference's decode-vs-forward bound.
* The encoder is bidirectional: changing the last frame moves the first
  frame's output; causal attention would not.
* Two clients with their own adapters (the encoder's included) on the
  client axis are each its own single-model call.
* One LM train step with a frontend in the batch: the loss and every
  updated leaf within the bound.
* fp16 builds on these families, and float64 is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_frontend  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models.frontends import synth_frontend_embeddings as j_synth  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.launch.steps import init_train_opt, make_train_step  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
DECODE_TOL = 2e-3  # the reference's decode-vs-forward bound (tests/test_models_smoke.py)
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
ARCHS = ["internvl2-76b", "seamless-m4t-large-v2"]
IDS = ["vlm", "audio"]
B, S = 2, 10


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.array(x))


def _live(params, seed):
    """The adapters' B made non-zero (a fresh B is 0: the adapters would
    not show), the rest as drawn."""
    rng = np.random.default_rng(seed)

    def bump(path, v):
        keys = [getattr(p, "key", "") for p in path]
        if "B" in keys:
            return v + jnp.asarray(0.05 * rng.normal(size=v.shape), v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(bump, params)


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def model(request):
    arch = request.param
    jc = j_smoke(arch).with_overrides(lora=JLoRA(**_LORA))
    tc = get_smoke_config(arch).with_overrides(lora=TLoRA(**_LORA))
    jp = _live(j_model.init(jax.random.PRNGKey(0), jc), 1)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, tokens


# -- the init -------------------------------------------------------------------------------------


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in bridge.flatten(tree).items()}


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_init_has_the_references_layout_smoke(arch):
    jc = j_smoke(arch).with_overrides(lora=JLoRA(**_LORA))
    tc = get_smoke_config(arch).with_overrides(lora=TLoRA(**_LORA))
    want = _shapes(jax.eval_shape(lambda: j_model.init(jax.random.PRNGKey(0), jc)))
    got = t_model.init(tc, 0, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    only = t_model.init(tc, 0, "cpu", adapters_only=True)
    assert set(only) == {k for k in want if "lora" in k}
    assert all(torch.equal(only[k], got[k]) for k in only)
    if tc.family == "audio":
        assert {"encoder/pos0/lora/q/A", "enc_norm/scale", "stack/pos0/cross/wk/w",
                "stack/pos0/norm_x/scale"} <= set(got)
        assert abs(float(got["stack/pos0/cross/wq/w"].std()) * tc.d_model**0.5 - 0.88) < 0.05


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_init_has_the_references_layout_full(arch):
    jc = j_config(arch).with_overrides(lora=JLoRA(**_LORA))
    tc = get_config(arch).with_overrides(lora=TLoRA(**_LORA))
    want = _shapes(jax.eval_shape(lambda: j_model.init(jax.random.PRNGKey(0), jc)))
    got = t_model.param_shapes(tc)
    assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_input_token_len_is_the_references():
    for arch in ARCHS + ["gpt2-paper"]:
        jc, tc = j_config(arch), get_config(arch)
        assert t_model.input_token_len(tc, 1024) == j_model.input_token_len(jc, 1024)
    assert t_model.input_token_len(get_config("internvl2-76b"), 1024) == 768


def test_the_bridge_carries_every_leaf_both_ways(model):
    """The port's own init (its ``encoder/``, ``enc_norm``, ``norm_x`` and
    ``cross`` leaves among them) crosses to a reference tree that the
    reference runs to the port's logits, and back leaf for leaf."""
    jc, tc, _, _, tokens = model
    tp = t_model.init(tc, 5, "cpu")
    tree = bridge.to_numpy_tree(tp)
    want, _ = j_model.forward(jax.tree.map(jnp.asarray, tree), jc, {"tokens": jnp.asarray(tokens)})
    got, _ = t_model.forward(tp, tc, _t(tokens)[None])
    _close(got[0], want)
    back = bridge.to_torch(tree, "cpu")
    assert set(back) == set(tp) and all(torch.equal(back[k], tp[k]) for k in tp)


# -- forward, backbone, prefill -------------------------------------------------------------------


def test_forward_matches_reference(model):
    jc, tc, jp, tp, tokens = model
    want, j_aux = j_model.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    got, t_aux = t_model.forward(tp, tc, _t(tokens)[None])
    assert tuple(got.shape) == (1, B, S, tc.vocab_size)
    _close(got[0], want)
    _close(t_aux.lora_h[0], j_aux.lora_h)
    _close(t_aux.moe_aux[0], j_aux.moe_aux)
    # a frontend given in the batch
    fe = np.asarray(j_synth(jc, B, seed=5))
    want, _ = j_model.forward(jp, jc, {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(fe)})
    got, _ = t_model.forward(tp, tc, _t(tokens)[None], frontend=_t(fe))
    _close(got[0], want)
    # the same frontend given per client is the same
    per_client, _ = t_model.forward(tp, tc, _t(tokens)[None], frontend=_t(fe)[None])
    assert torch.equal(per_client, got)


def test_backbone_last_only_and_prefill_match_reference(model):
    jc, tc, jp, tp, tokens = model
    want, j_aux = j_model.backbone(jp, jc, {"tokens": jnp.asarray(tokens)}, last_only=True)
    got, t_aux = t_model.backbone(tp, tc, _t(tokens)[None], last_only=True)
    assert tuple(got.shape) == (1, B, 1, tc.d_model)
    _close(got[0], want)
    _close(t_aux.lora_h[0], j_aux.lora_h)
    full, _ = t_model.backbone(tp, tc, _t(tokens)[None])
    assert tuple(full.shape) == (1, B, S, tc.d_model)  # the text region of a VLM
    _close(full[0, :, -1:], got[0], rtol=0, atol=1e-6)
    want, j_aux = j_model.prefill(jp, jc, {"tokens": jnp.asarray(tokens)})
    got, t_aux = t_model.prefill(tp, tc, {"tokens": _t(tokens)})
    assert tuple(got.shape) == (B, tc.vocab_size)
    _close(got, want)
    _close(t_aux.lora_h, j_aux.lora_h)


# -- the encoder and the attention ----------------------------------------------------------------


def _audio():
    jc = j_smoke("seamless-m4t-large-v2").with_overrides(lora=JLoRA(**_LORA))
    tc = get_smoke_config("seamless-m4t-large-v2").with_overrides(lora=TLoRA(**_LORA))
    jp = _live(j_model.init(jax.random.PRNGKey(0), jc), 1)
    return jc, tc, jp, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def test_run_encoder_matches_reference_and_is_bidirectional():
    jc, tc, jp, tp = _audio()
    fe = np.asarray(j_synth(jc, B, seed=3))
    want = j_model._run_encoder(jp, jc, jnp.asarray(fe))
    got = t_model._run_encoder(tp, tc, _t(fe)[None])
    assert tuple(got.shape) == (1, B, tc.frontend_len, tc.d_model)
    _close(got[0], want)
    late = fe.copy()
    late[:, -1] += 1.0
    moved = t_model._run_encoder(tp, tc, _t(late)[None])
    # the first frame sees the last
    assert float((moved[0, :, 0] - got[0, :, 0]).abs().max()) > 1e-3
    _close(moved[0], j_model._run_encoder(jp, jc, jnp.asarray(late)))
    # the encoder's adapters move its output
    no_enc_lora = {k: (torch.zeros_like(v) if k.startswith("encoder/") and k.endswith("/B") else v)
                   for k, v in tp.items()}
    assert float((t_model._run_encoder(no_enc_lora, tc, _t(fe)[None]) - got).abs().max()) > 1e-4


@pytest.mark.parametrize("seq", [16, 1024], ids=["dense", "chunked"])
def test_non_causal_attention_matches_reference(seq):
    jc = j_smoke("seamless-m4t-large-v2").with_overrides(d_model=32, num_heads=4, num_kv_heads=2)
    tc = get_smoke_config("seamless-m4t-large-v2").with_overrides(d_model=32, num_heads=4,
                                                                  num_kv_heads=2)
    params = j_attention.attn_init(jax.random.PRNGKey(4), jc)
    lp = {f"attn/{k}": v for k, v in bridge.to_torch(jax.tree.map(np.asarray, params),
                                                     "cpu").items()}
    x = np.random.default_rng(4).normal(size=(1, seq, 32)).astype(np.float32)
    pos = jnp.arange(seq, dtype=jnp.int32)
    for causal in (False, True):
        want, _, _ = j_attention.attn_apply(params, jnp.asarray(x), jc, positions=pos,
                                            causal=causal)
        got, _ = t_attention.attn_apply(lp, _t(x)[None], tc, causal=causal)
        _close(got[0], want)
    # a window does not limit the bidirectional mask, as in the reference
    want, _, _ = j_attention.attn_apply(params, jnp.asarray(x), jc, positions=pos, window=4,
                                        causal=False)
    _close(t_attention.attn_apply(lp, _t(x)[None], tc, window=4, causal=False)[0][0], want)


def test_cross_attention_matches_reference():
    jc = j_smoke("seamless-m4t-large-v2").with_overrides(num_kv_heads=2, use_bias=True)
    tc = get_smoke_config("seamless-m4t-large-v2").with_overrides(num_kv_heads=2, use_bias=True)
    params = j_attention.attn_init(jax.random.PRNGKey(6), jc)
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda v: v + jnp.asarray(0.05 * rng.normal(size=v.shape), v.dtype),
                          params)  # live biases
    lp = {f"cross/{k}": v for k, v in bridge.to_torch(jax.tree.map(np.asarray, params),
                                                      "cpu").items()}
    x = rng.normal(size=(B, 3, tc.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, 7, tc.d_model)).astype(np.float32)
    want = j_attention.cross_attn_apply(params, jnp.asarray(x), jnp.asarray(enc), jc)
    got = t_attention.cross_attn_apply(lp, _t(x)[None], _t(enc)[None], tc)
    _close(got[0], want)
    # B requests of batch 1 on the client axis: the same rows
    rows = t_attention.cross_attn_apply(lp, _t(x)[:, None], _t(enc)[:, None], tc)
    _close(rows[:, 0], got[0], rtol=0, atol=1e-6)


# -- the decode cache and decode steps ------------------------------------------------------------


def test_init_cache_carries_the_encoder_output():
    jc, tc, jp, tp = _audio()
    want = j_model.init_cache(jc, B, 8)
    got = t_model.init_cache(tc, B, 8, device="cpu")
    assert tuple(got["enc_out"].shape) == tuple(want["enc_out"].shape) == (B, 16, tc.d_model)
    assert not bool(got["enc_out"].any()) and got["enc_out"].dtype == torch.float32
    enc = torch.ones(B, 16, tc.d_model)
    assert t_model.init_cache(tc, B, 8, enc_out=enc, device="cpu")["enc_out"] is enc
    dense = get_smoke_config("stablelm-1.6b")
    assert "enc_out" not in t_model.init_cache(dense, B, 8, enc_out=enc, device="cpu")


def test_decode_matches_reference(model):
    jc, tc, jp, tp, tokens = model
    enc_j = enc_t = None
    if tc.family == "audio":
        fe = np.asarray(j_synth(jc, B, seed=7))
        enc_j = j_model._run_encoder(jp, jc, jnp.asarray(fe))
        enc_t = t_model._run_encoder(tp, tc, _t(fe)[None])[0]
    j_cache = j_model.init_cache(jc, B, 16, enc_out=enc_j)
    t_cache = t_model.init_cache(tc, B, 16, enc_out=enc_t, device="cpu")
    j_step = jax.jit(lambda p, c, tok: j_model.decode_step(p, jc, c, tok))
    outs = []
    for t in range(S):
        want, j_cache = j_step(jp, j_cache, jnp.asarray(tokens[:, t]))
        got, t_cache = t_model.decode_step(tp, tc, t_cache, _t(tokens[:, t]))
        _close(got, want)
        outs.append(got)
    assert int(t_cache["length"]) == S
    if tc.family == "audio":  # the decode against the teacher-forced forward
        full, _ = t_model.forward(tp, tc, _t(tokens)[None], frontend=_t(fe))
        _close(torch.stack(outs, 1), full[0], rtol=0, atol=DECODE_TOL)
        # per-request adapters (B rows of batch 1 over the shared backbone) are the same rows
        rows = {k: (v.expand((B,) + tuple(v.shape)) if "lora" in k else v) for k, v in tp.items()}
        cache = t_model.init_cache(tc, B, 16, enc_out=enc_t, device="cpu")
        for t in range(S):
            got, cache = t_model.decode_step(rows, tc, cache, _t(tokens[:, t]))
            _close(got, outs[t], rtol=0, atol=1e-5)


# -- the client axis ------------------------------------------------------------------------------


def test_two_clients_are_their_own_single_calls(model):
    jc, tc, jp, tp, tokens = model
    other = bridge.to_torch(jax.tree.map(np.asarray, _live(jp, 9)), "cpu")
    both = {k: (torch.stack([tp[k], other[k]]) if "lora" in k else v) for k, v in tp.items()}
    two = np.stack([tokens, tokens[::-1]])
    got, aux = t_model.forward(both, tc, _t(two))
    for i, params in enumerate((tp, other)):
        one, one_aux = t_model.forward(params, tc, _t(two[i])[None])
        _close(got[i], one[0], rtol=0, atol=1e-5)
        _close(aux.lora_h[i], one_aux.lora_h[0], rtol=0, atol=1e-6)
    assert float((got[0] - got[1]).abs().max()) > 1e-3


# -- training -------------------------------------------------------------------------------------


def test_a_train_step_with_a_frontend_matches_reference(model):
    jc, tc, jp, tp, tokens = model
    fe = np.asarray(j_synth(jc, B, seed=8))
    jc1, tc1 = jc.with_overrides(microbatches=1), tc.with_overrides(microbatches=1)
    j_params, _, j_metrics = jax.jit(j_train_step(jc1, lr=1e-3))(
        jp, j_adamw_init(jp, state_dtype=jc1.optimizer_state_dtype),
        {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(fe)})
    params = {k: v.clone() for k, v in tp.items()}
    t_params, _, t_metrics = make_train_step(tc1, lr=1e-3)(
        params, init_train_opt(params, tc1), {"tokens": _t(tokens), "frontend": _t(fe)})
    _close(t_metrics["loss"], j_metrics["loss"])
    want = bridge.flatten(jax.tree.map(np.asarray, j_params))
    assert set(want) == set(t_params)
    for key, w in want.items():  # Adam's first step is lr * sign(g): a wider bound
        _close(t_params[key], w, rtol=0, atol=1e-4)
    # two microbatches of one sample: the frontend splits with the tokens
    tc2 = tc.with_overrides(microbatches=2)
    params = {k: v.clone() for k, v in tp.items()}
    _, _, m2 = make_train_step(tc2, lr=1e-3)(params, init_train_opt(params, tc2),
                                             {"tokens": _t(tokens), "frontend": _t(fe)})
    halves = []
    for i in range(2):
        params = {k: v.clone() for k, v in tp.items()}
        halves.append(float(make_train_step(tc1, lr=1e-3)(
            params, init_train_opt(params, tc1),
            {"tokens": _t(tokens[i:i + 1]), "frontend": _t(fe[i:i + 1])})[2]["loss"]))
    _close(m2["loss"], np.mean(halves), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_fp16_builds_and_float64_is_refused(arch):
    """fp16 builds on these families (held to the reference in
    ``tests/test_torch_fp16.py``); a dtype outside fp32, bf16 and fp16 is
    refused before anything is drawn."""
    half = get_smoke_config(arch).with_overrides(param_dtype="float16", compute_dtype="float16")
    assert all(v.dtype == torch.float16 for v in t_model.init(half, 0, "cpu").values())
    with pytest.raises(ValueError, match="compute_dtype='float64'"):
        t_model.init(get_smoke_config(arch).with_overrides(compute_dtype="float64"), 0, "cpu")
