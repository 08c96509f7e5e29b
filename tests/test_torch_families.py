"""The port's model families against the JAX reference, on the CPU: the
Llama-style layers (RMSNorm, RoPE, SwiGLU), grouped-query attention with
and without a sliding window, the MoE MLP, and the six dense and MoE smoke
configs, the SSM one (mamba2) and the hybrid one (jamba: a period of four
layers) end to end; the attention-free model's eq. 8 projection from its
head adapter, ``lora_h``'s zero start where a period has attention, and a
hybrid tree through the bridge.

Weights are the reference's init bridged into the port (LoRA B factors
made non-zero, so every adapter is live); inputs are drawn from numpy
seeds.  Tolerances:

* layers, attention and the MoE MLP: atol 1e-5 (fp32, the same operations
  in another order; the MoE's routing — its top-k, its ties and its drops —
  is exact, or its output would differ by whole expert outputs);
* the models' forward logits, ``lora_h`` and decode logits: atol 1e-5
  (the SSM's chunked SSD and its recurrence too: ``exp`` and ``cumsum`` in
  fp32 over 12 positions stay inside it); ``moe_aux``: rtol 1e-5;
* decode against the port's own forward at the last position: atol 2e-3
  (the reference's bound in ``tests/test_models_smoke.py``; MoE configs at
  capacity factor 8 there too, so that the full sequence's groups drop
  nothing, as one token's decode group never does);
* one ``launch/steps`` train step (full-parameter AdamW, lr 1e-3): the loss
  within rtol 1e-5; in every updated leaf at most one element in a thousand
  off by more than 1e-5, and none by more than 2 lr (AdamW's first step is
  ``lr · g / (|g| + eps)``, so an element whose gradient is a rounding error
  from zero may take a different step, of at most lr each way).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCH  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models.attention import attn_apply as j_attn  # noqa: E402
from repro.models.attention import attn_init as j_attn_init  # noqa: E402
from repro.models.layers import apply_rope as j_rope  # noqa: E402
from repro.models.layers import mlp_apply as j_mlp  # noqa: E402
from repro.models.layers import mlp_init as j_mlp_init  # noqa: E402
from repro.models.layers import norm_apply as j_norm  # noqa: E402
from repro.models.moe import moe_apply as j_moe  # noqa: E402
from repro.models.moe import moe_init as j_moe_init  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.launch.steps import init_train_opt, make_train_step  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.model import backbone, decode_step, forward, init, init_cache  # noqa: E402

# the six dense and MoE architectures, the SSM and the hybrid
ARCHS = ["stablelm-1.6b", "llama4-scout-17b-a16e", "yi-9b", "moonshot-v1-16b-a3b",
         "command-r-35b", "granite-moe-1b-a400m", "mamba2-130m", "jamba-1.5-large-398b"]
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
ATOL = 1e-5


def _cfgs(arch: str, **over):
    """The arch's smoke config with LoRA, in both packages."""
    return (j_smoke(arch).with_overrides(lora=JLoRA(**_LORA), **over),
            get_smoke_config(arch).with_overrides(lora=TLoRA(**_LORA), **over))


def _live(tree, seed: int):
    """The reference tree with every LoRA B factor made non-zero."""
    rng = np.random.default_rng(seed)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(live_b, tree)


def _bridged(tree) -> dict:
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_every_config_is_the_references():
    assert list(ARCHITECTURES) == list(J_ARCH)
    for arch in ARCHITECTURES:
        for t_get, j_get in ((get_config, j_config), (get_smoke_config, j_smoke)):
            assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch)), arch


# -- the layers -----------------------------------------------------------------------------


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(2, 5, 48))).astype(np.float32)
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = j_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), kind="rmsnorm")
    got = t_layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale))
    _close(got, want)
    # the dispatch: RMSNorm reads no bias, LayerNorm reads one
    params = {"n/scale": torch.as_tensor(scale)}
    assert torch.equal(t_layers.norm_apply(params, "n", torch.as_tensor(x), "rmsnorm"), got)
    with pytest.raises(KeyError):
        t_layers.norm_apply(params, "n", torch.as_tensor(x), "layernorm")


@pytest.mark.parametrize("start", [0, 1000])
def test_rope_rotates_split_halves_as_the_reference(start):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)  # (B, S, H, Dh)
    pos = np.arange(start, start + 7, dtype=np.int32)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0)
    got = t_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta=10000.0)
    _close(got, want, atol=ATOL * (1 + start / 100))  # fp32 angles of large positions
    # split halves: the first coordinate pairs with the one Dh/2 further on
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = t_layers.apply_rope(torch.as_tensor(one), torch.tensor([1])).numpy()[0, 0, 0]
    np.testing.assert_allclose(rot[[0, 8]], [np.cos(1.0), np.sin(1.0)], atol=1e-6)
    assert np.count_nonzero(rot) == 2


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_reference(activation):
    params = j_mlp_init(jax.random.PRNGKey(2), 32, 64, activation=activation, use_bias=True)
    x = np.random.default_rng(2).normal(size=(2, 6, 32)).astype(np.float32)
    want = j_mlp(params, jnp.asarray(x), activation=activation)
    lp = {f"mlp/{k}": v for k, v in _bridged(params).items()}
    got = t_layers.mlp_apply(lp, torch.as_tensor(x)[None], activation=activation)[0]
    _close(got, want)


# -- grouped-query attention --------------------------------------------------------------

ATTN_CASES = {
    "gqa": dict(seq=12, window=None),
    "gqa-window": dict(seq=12, window=4),
    # 2 * Q_CHUNK positions: the chunked full-sequence path, windowed
    "gqa-chunked-window": dict(seq=1024, window=300),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_gqa_attention_matches_reference(case):
    seq, window = ATTN_CASES[case]["seq"], ATTN_CASES[case]["window"]
    jc, tc = _cfgs("yi-9b", d_model=32, num_heads=4, num_kv_heads=2, head_dim=8)
    params = j_attn_init(jax.random.PRNGKey(3), jc)
    rng = np.random.default_rng(3)
    lora = {t: {"A": jnp.asarray(rng.normal(size=(32, 4)).astype(np.float32) / 6),
                "B": jnp.asarray(rng.normal(size=(4, 4 * 8 if t == "q" else 2 * 8))
                                 .astype(np.float32) / 6)} for t in ("q", "v")}
    x = rng.normal(size=(1, seq, 32)).astype(np.float32)
    want, _, want_h = j_attn(params, jnp.asarray(x), jc, positions=jnp.arange(seq),
                             window=window, lora=lora)
    lp = {f"attn/{k}": v for k, v in _bridged(params).items()}
    lp.update({f"lora/{k}": v for k, v in _bridged(lora).items()})
    got, got_h = t_attention.attn_apply(lp, torch.as_tensor(x)[None], tc, window=window)
    _close(got[0], want)
    _close(got_h[0], want_h)


# -- the MoE MLP ----------------------------------------------------------------------------


def _moe_cfgs(**moe):
    """granite's smoke MoE at d 32: 4 experts, top-2 unless ``moe`` says."""
    spec = {**dict(num_experts=4, top_k=2, d_ff=48), **moe}
    jc, tc = _cfgs("granite-moe-1b-a400m", d_model=32)
    return jc.with_overrides(moe=JMoE(**spec)), tc.with_overrides(moe=TMoE(**spec))


def _moe_params(jc, seed, tie=False):
    params = j_moe_init(jax.random.PRNGKey(seed), jc)
    if tie:  # experts 0 and 3 share a router column, of halves and ones on inputs in
        # quarters: their logits are exact and equal, so every token ties them
        w = np.random.default_rng(seed).choice([-1.0, -0.5, 0.5, 1.0], size=(32, 4))
        w[:, 3] = w[:, 0]
        params["router"]["w"] = jnp.asarray(w.astype(np.float32))
    return params


MOE_CASES = {
    "random": dict(moe=dict(), x="random"),
    # every token alike: experts past their capacity (cf 1: 8 places for 32
    # tokens' 64 slots) drop tokens
    "capacity-drop": dict(moe=dict(capacity_factor=1.0), x="alike"),
    # top-1 with experts 0 and 3 tied on every token: lax.top_k takes 0
    "tied-row": dict(moe=dict(top_k=1, capacity_factor=8.0), x="random", tie=True),
}


def _moe_x(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if kind == "alike":
        x = rng.normal(size=shape[-1:]).astype(np.float32) + 0.01 * x
    return x


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    spec = MOE_CASES[case]
    jc, tc = _moe_cfgs(**spec["moe"])
    params = _moe_params(jc, 4, tie=spec.get("tie", False))
    x = _moe_x(spec["x"], (2, 16, 32), 4)
    if spec.get("tie"):
        x = np.round(4 * x) / 4
    want, want_aux = j_moe(params, jnp.asarray(x), jc)
    lp = {f"mlp/{k}": v for k, v in _bridged(params).items()}
    got, got_aux = t_moe.moe_apply(lp, torch.as_tensor(x)[None], tc)
    _close(got[0], want)
    np.testing.assert_allclose(float(got_aux[0]), float(want_aux), rtol=1e-5)
    if case == "capacity-drop":  # tokens past both their experts' capacity output zeros
        assert int((got[0].abs().sum(-1) == 0).sum()) > 0
    if case == "tied-row":  # expert 0 served every token: expert 3's weights change nothing
        lp3 = dict(lp, **{f"mlp/{k}": lp[f"mlp/{k}"].clone().index_fill_(0, torch.tensor([3]), 7.0)
                          for k in ("up", "down", "gate")})
        assert torch.equal(t_moe.moe_apply(lp3, torch.as_tensor(x)[None], tc)[0], got)


def test_moe_routes_each_client_in_groups_of_its_own():
    """A two-client call is two single-client calls: each client's tokens
    form their own groups, so the capacity and the drops are its own (the
    tokens pooled into shared groups would drop others)."""
    jc, tc = _moe_cfgs(capacity_factor=1.0)
    x = np.stack([_moe_x("alike", (2, 16, 32), 5), _moe_x("random", (2, 16, 32), 6)])
    shared = {f"mlp/{k}": v for k, v in _bridged(_moe_params(jc, 5)).items()}
    other = {f"mlp/{k}": v for k, v in _bridged(_moe_params(jc, 6)).items()}
    per_client = {k: torch.stack([shared[k], other[k]]) for k in shared}
    for lp, rows in ((shared, (shared, shared)), (per_client, (shared, other))):
        both, both_aux = t_moe.moe_apply(lp, torch.as_tensor(x), tc)
        for c in range(2):
            one, one_aux = t_moe.moe_apply(rows[c], torch.as_tensor(x[c:c + 1]), tc)
            _close(both[c], one[0], atol=1e-6)
            np.testing.assert_allclose(float(both_aux[c]), float(one_aux[0]), rtol=1e-6)
    pooled, _ = t_moe.moe_apply(shared, torch.as_tensor(x.reshape(1, 4, 16, 32)), tc)
    assert not np.allclose(pooled.numpy().reshape(x.shape), both.numpy(), atol=1e-3)


# -- the models -----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_aux_and_decode_match_reference(arch):
    over = {}
    if j_smoke(arch).moe is not None:  # see the module docstring
        over["moe"] = dataclasses.replace(j_smoke(arch).moe, capacity_factor=8.0)
    jc, tc = _cfgs(arch, **over)
    jp = _live(j_init(jax.random.PRNGKey(0), jc), 0)
    tp = _bridged(jp)
    fresh = init(tc, 0, "cpu")  # the port's own init: the reference's layout
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}
    tokens = np.random.default_rng(0).integers(0, tc.vocab_size, size=(2, 12)).astype(np.int32)
    want, want_aux = j_forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    got, got_aux = forward(tp, tc, torch.as_tensor(tokens)[None])
    _close(got[0], want)
    _close(got_aux.lora_h[0], want_aux.lora_h)
    np.testing.assert_allclose(float(got_aux.moe_aux[0]), float(want_aux.moe_aux), rtol=1e-5)
    assert (float(want_aux.moe_aux) > 0) == (tc.moe is not None)

    j_cache, t_cache = j_init_cache(jc, 2, 16), init_cache(tc, 2, 16, device="cpu")
    j_step = jax.jit(j_decode, static_argnums=(1,))
    for t in range(8):
        j_logits, j_cache = j_step(jp, jc, j_cache, jnp.asarray(tokens[:, t]))
        t_logits, t_cache = decode_step(tp, tc, t_cache, torch.as_tensor(tokens[:, t]))
        _close(t_logits, j_logits)
    _close(t_logits, got[0, :, 7], atol=2e-3)


def test_sliding_window_decode_matches_reference():
    """The reference's own case (``tests/test_models_smoke.py``): a window of
    6 over 16 steps, the decode cache a ring of 6 slots."""
    jc, tc = _cfgs("yi-9b", sliding_window=6)
    jp = _live(j_init(jax.random.PRNGKey(0), jc), 1)
    tp = _bridged(jp)
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, size=(1, 16)).astype(np.int32)
    want, _ = j_forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    got, _ = forward(tp, tc, torch.as_tensor(tokens)[None])
    _close(got[0], want)
    cache = init_cache(tc, 1, 64, device="cpu")
    assert cache["layers"]["pos0"].k.shape[2] == 6
    for t in range(16):
        logits, cache = decode_step(tp, tc, cache, torch.as_tensor(tokens[:, t]))
        _close(logits, got[0, :, t], atol=2e-3)
    # the window is live: without it the last position reads other keys
    unwindowed, _ = forward(tp, tc.with_overrides(sliding_window=None),
                            torch.as_tensor(tokens)[None])
    assert not np.allclose(unwindowed[0, :, -1].numpy(), got[0, :, -1].numpy(), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jc = j_smoke(arch)
    tc = get_smoke_config(arch)
    jp = j_init(jax.random.PRNGKey(1), jc)
    tokens = np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 16)).astype(np.int32)
    j_params, _, j_metrics = jax.jit(j_train_step(jc, lr=1e-3))(
        jp, j_adamw_init(jp, state_dtype=jc.optimizer_state_dtype),
        {"tokens": jnp.asarray(tokens)})
    tp = _bridged(jp)
    t_params, _, t_metrics = make_train_step(tc, lr=1e-3)(
        tp, init_train_opt(tp, tc), {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(float(t_metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    for k, want in bridge.flatten(jax.tree.map(np.asarray, j_params)).items():
        diff = np.abs(t_params[k].numpy() - want)
        assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 2 * 1e-3, (k, diff.max())


def test_bridge_carries_the_moe_and_rmsnorm_trees():
    jc, tc = _cfgs("granite-moe-1b-a400m")
    tree = jax.tree.map(np.asarray, _live(j_init(jax.random.PRNGKey(2), jc), 2))
    flat = bridge.to_torch(tree, "cpu")
    assert "stack/pos0/mlp/up" in flat and "stack/pos0/mlp/router/w" in flat
    assert "stack/pos0/norm1/bias" not in flat and "pos_embed" not in flat and "lm_head" in flat
    back = bridge.to_numpy_tree(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# -- the eq. 8 projection without attention, and the hybrid's tree ----------------------------


def test_the_ssm_fallback_projection_norms_the_whole_sequence():
    """An attention-free model's ``lora_h`` is ``mean_s(norm(h) · lora_head.A)``
    over every position, with ``last_only`` too (the final norm then runs
    over the whole sequence, and only then is the last position taken)."""
    jc, tc = _cfgs("mamba2-130m")
    jp = _live(j_init(jax.random.PRNGKey(3), jc), 3)
    tp = _bridged(jp)
    tokens = np.random.default_rng(3).integers(0, tc.vocab_size, size=(2, 12)).astype(np.int32)
    full, full_aux = forward(tp, tc, torch.as_tensor(tokens)[None])
    last, last_aux = forward(tp, tc, torch.as_tensor(tokens)[None], last_only=True)
    want, want_aux = j_forward(jp, jc, {"tokens": jnp.asarray(tokens)}, last_only=True)
    _close(last[0], want)
    _close(last_aux.lora_h[0], want_aux.lora_h)
    assert torch.equal(last_aux.lora_h, full_aux.lora_h)
    _close(last, full[:, :, -1])
    # the projection of the last position alone is another vector
    h_last, _ = backbone(tp, tc, torch.as_tensor(tokens)[None], last_only=True)
    alone = (h_last[:, :, 0] @ tp["lora_head/A"]).numpy()
    assert not np.allclose(alone, last_aux.lora_h.numpy(), atol=1e-3)


ZERO_H_CASES = {  # arch, LoRA targets, what lora_h is
    "dense-k": ("yi-9b", ("k", "head"), "zeros"),
    "hybrid-head": ("jamba-1.5-large-398b", ("head",), "zeros"),
    "hybrid-qv": ("jamba-1.5-large-398b", ("q", "v", "head"), "projection"),
    "ssm-head": ("mamba2-130m", ("head",), "projection"),
}


@pytest.mark.parametrize("case", list(ZERO_H_CASES))
def test_lora_h_starts_at_zeros_as_the_reference(case):
    """A stack with an attention position and LoRA starts ``lora_h`` at zeros
    (the reference's start): adapters on no q or v report zeros, not the
    head fallback; a hybrid's projection is its last attention layer's q
    adapter's; an SSM stack starts at None, so the fallback applies."""
    arch, targets, kind = ZERO_H_CASES[case]
    over = {}
    if j_smoke(arch).moe is not None:
        over["moe"] = dataclasses.replace(j_smoke(arch).moe, capacity_factor=8.0)
    jc = j_smoke(arch).with_overrides(lora=JLoRA(**dict(_LORA, targets=targets)), **over)
    tc = get_smoke_config(arch).with_overrides(lora=TLoRA(**dict(_LORA, targets=targets)), **over)
    jp = _live(j_init(jax.random.PRNGKey(4), jc), 4)
    tp = _bridged(jp)
    tokens = np.random.default_rng(4).integers(0, tc.vocab_size, size=(2, 8)).astype(np.int32)
    _, want = j_forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    logits, got = forward(tp, tc, torch.as_tensor(tokens)[None])
    assert got.lora_h.shape == (1, 2, 4) and got.lora_h.dtype == torch.float32
    _close(got.lora_h[0], want.lora_h)
    assert (float(got.lora_h.abs().max()) == 0.0) == (kind == "zeros")


def test_bridge_carries_the_hybrid_tree():
    """jamba-smoke's period of four (``stack/pos0..pos3``: SSM at 0, 1, 3,
    attention at 2, MoE at 1 and 3) crosses both ways leaf for leaf."""
    jc, tc = _cfgs("jamba-1.5-large-398b")
    tree = jax.tree.map(np.asarray, _live(j_init(jax.random.PRNGKey(5), jc), 5))
    flat = bridge.to_torch(tree, "cpu")
    assert {k.split("/")[1] for k in flat if k.startswith("stack/")} == {
        "pos0", "pos1", "pos2", "pos3"}
    assert "stack/pos2/attn/wq/w" in flat and "stack/pos2/lora/q/A" in flat
    assert "stack/pos0/ssm/conv_x_w" in flat and "stack/pos0/lora/q/A" not in flat
    assert "stack/pos1/mlp/router/w" in flat and "stack/pos0/mlp/up/w" in flat
    assert flat["stack/pos1/mlp/up"].shape[0] == 1  # 4 layers / period 4: one repeat
    back = bridge.to_numpy_tree(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
