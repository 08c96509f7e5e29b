"""The port's GPT-2-family model, LoRA gradients and AdamW against the JAX
reference, on the CPU.

A 2-layer d 64 vocab 256 config with LoRA on q, v and the LM head; the JAX
package's init (with random B factors, so every adapter is live) is
bridged into the port.  Forward values are held at atol 1e-5, gradients
and optimizer updates at the same bound relative to their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_REDUCED  # noqa: E402
from repro.fed import steps as jsteps  # noqa: E402
from repro.lora import split_lora as j_split  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_REDUCED  # noqa: E402
from repro_torch.fed import steps as tsteps  # noqa: E402
from repro_torch.lora import split_lora as t_split  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init as t_init  # noqa: E402
from repro_torch.optim import adamw_init as t_adamw_init  # noqa: E402
from repro_torch.optim import adamw_update as t_adamw_update  # noqa: E402

_SHAPE = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
              vocab_size=256, max_seq_len=32)
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
JCFG = J_REDUCED.with_overrides(**_SHAPE, lora=JLoRA(**_LORA))
TCFG = T_REDUCED.with_overrides(**_SHAPE, lora=TLoRA(**_LORA))
NUM_CLASSES = 77


def _jax_params(seed):
    """The reference init with random (non-zero) LoRA B factors."""
    rng = np.random.default_rng(seed)
    params = j_init(jax.random.PRNGKey(seed), JCFG)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape).astype(np.float32))
        return x

    return jax.tree_util.tree_map_with_path(live_b, params)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, TCFG.vocab_size, size=shape).astype(np.int32)


def _stack(dicts):
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def test_init_matches_reference_layout():
    j_flat = bridge.flatten(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JCFG)))
    t_params = t_init(TCFG, 0, "cpu")
    assert set(t_params) == set(j_flat)
    for k, v in j_flat.items():
        assert tuple(t_params[k].shape) == v.shape, k
    w = t_params["stack/pos0/mlp/up/w"]
    assert abs(float(w.std()) - float(np.std(j_flat["stack/pos0/mlp/up/w"]))) < 0.01
    assert float(w.abs().max()) <= 2.0 / 64**0.5 + 1e-6  # truncated at two std
    assert torch.equal(t_init(TCFG, 0, "cpu")["embed"], t_params["embed"])


def test_bridge_round_trip():
    tree = jax.tree.map(np.asarray, _jax_params(1))
    back = bridge.to_numpy_tree(bridge.to_torch(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("last_only,head_cols", [(False, None), (True, None), (True, NUM_CLASSES)])
def test_forward_matches_reference(last_only, head_cols):
    jp = _jax_params(2)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(3, (4, 12))
    j_logits, j_aux = j_forward(jp, JCFG, {"tokens": jnp.asarray(tok)}, last_only=last_only,
                                head_cols=head_cols)
    t_logits, t_aux = t_forward(tp, TCFG, torch.as_tensor(tok)[None], last_only=last_only,
                                head_cols=head_cols)
    assert t_logits.shape[1:] == j_logits.shape
    np.testing.assert_allclose(t_logits[0].numpy(), np.asarray(j_logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_aux.lora_h[0].numpy(), np.asarray(j_aux.lora_h), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shared", [True, False])
def test_client_axis_layouts_match_one_model_at_a_time(shared):
    """Three clients in one call — backbone shared (broadcast) or stacked
    per client (batched matmuls) — equal three single-model forwards."""
    models = [bridge.to_torch(jax.tree.map(np.asarray, _jax_params(s)), "cpu") for s in (4, 5, 6)]
    if shared:
        models = [{**m, **t_split(models[0])[1]} for m in models]
    loras, frozens = zip(*(t_split(m) for m in models))
    frozen = frozens[0] if shared else _stack(frozens)
    tok = torch.as_tensor(_tokens(7, (3, 5, 12)))
    logits, aux = t_forward({**frozen, **_stack(loras)}, TCFG, tok, last_only=True)
    for c, m in enumerate(models):
        one, one_aux = t_forward(m, TCFG, tok[c:c + 1], last_only=True)
        torch.testing.assert_close(logits[c], one[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(aux.lora_h[c], one_aux.lora_h[0], rtol=0, atol=1e-5)


def _assert_scaled_close(t, j, tol=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=0, atol=tol * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("restrict_to_support", [False, True])
def test_lora_gradients_match_jax_grad(restrict_to_support):
    """Fine-tune and cached-teacher distill losses of two clients with
    per-client backbones: one backward of the summed losses gives each
    client the gradient jax.grad gives it alone."""
    jps = [_jax_params(s) for s in (8, 9)]
    tps = [bridge.to_torch(jax.tree.map(np.asarray, p), "cpu") for p in jps]
    t_lora, t_frozen = (_stack(list(d)) for d in zip(*(t_split(p) for p in tps)))
    tok = _tokens(10, (2, 6, 12))
    labels = np.random.default_rng(11).integers(0, NUM_CLASSES, size=(2, 6)).astype(np.int32)
    pub = _tokens(12, (5, 12))
    rng = np.random.default_rng(13)
    teacher = rng.normal(size=(5, TCFG.vocab_size)).astype(np.float32)
    teacher[:, ::3] = 0.0  # off the transmitted support
    teacher_h = rng.normal(size=(5, TCFG.lora.rank)).astype(np.float32)

    j_ft = jsteps._finetune_loss_fn(JCFG, NUM_CLASSES)
    j_kd = jsteps._distill_loss_cached_fn(JCFG, 2.0, 0.03)
    j_cache = jsteps._teacher_cache_fn(2.0, restrict_to_support, True)(jnp.asarray(teacher), jnp.asarray(teacher_h))
    t_ft = tsteps._finetune_loss_fn(TCFG, NUM_CLASSES)
    t_kd = tsteps._distill_loss_cached_fn(TCFG, 2.0, 0.03)
    t_cache = tsteps._teacher_cache_fn(2.0, restrict_to_support, True)(torch.as_tensor(teacher),
                                                           torch.as_tensor(teacher_h))

    t_ft_loss, t_ft_g = tsteps._grads(t_ft, t_lora, t_frozen, torch.as_tensor(tok),
                                      torch.as_tensor(labels))
    t_kd_loss, t_kd_g = tsteps._grads(t_kd, t_lora, t_frozen,
                                      torch.as_tensor(pub).expand(2, 5, 12), *t_cache)
    j_ft_grad = jax.jit(jax.value_and_grad(j_ft, has_aux=True))
    j_kd_grad = jax.jit(jax.value_and_grad(j_kd, has_aux=True))
    for c, jp in enumerate(jps):
        j_lora, j_frozen = j_split(jp)
        batch = {"tokens": jnp.asarray(tok[c]), "labels": jnp.asarray(labels[c])}
        (j_loss, _), j_g = j_ft_grad(j_lora, j_frozen, batch)
        (k_loss, _), k_g = j_kd_grad(j_lora, j_frozen, jnp.asarray(pub), *j_cache)
        np.testing.assert_allclose(float(t_ft_loss[c]), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(float(t_kd_loss[c]), float(k_loss), rtol=1e-5)
        for grads_t, grads_j in ((t_ft_g, j_g), (t_kd_g, k_g)):
            flat_j = bridge.flatten(jax.tree.map(np.asarray, grads_j))
            assert set(flat_j) == set(grads_t)
            for k, g in flat_j.items():
                _assert_scaled_close(grads_t[k][c].numpy(), g)


def test_adamw_clips_each_client_over_its_own_leaves():
    """Two clients whose gradient norms differ by 1000x: the port's stacked
    update equals the reference's update of each client alone."""
    rng = np.random.default_rng(14)
    shapes = {"a/lora/A": (3, 4), "a/lora/B": (4, 2)}
    params = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(2)]
    grads = [{k: (sc * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for sc in (0.01, 10.0)]
    t_p = {k: torch.as_tensor(np.stack([p[k] for p in params])) for k in shapes}
    t_g = {k: torch.as_tensor(np.stack([g[k] for g in grads])) for k in shapes}
    t_opt = t_adamw_init(t_p)
    j_opts = [j_adamw_init(p) for p in params]
    j_ps = [dict(p) for p in params]
    for step in range(3):
        t_p, t_opt = t_adamw_update(t_g, t_opt, t_p, lr=1e-2, weight_decay=1e-3)
        for c in range(2):
            j_ps[c], j_opts[c] = j_adamw_update(grads[c], j_opts[c], j_ps[c], lr=1e-2,
                                                 weight_decay=1e-3)
    for c in range(2):
        for k in shapes:
            _assert_scaled_close(t_p[k][c].numpy(), j_ps[c][k])
            _assert_scaled_close(t_opt.v[k][c].numpy(), j_opts[c].v[k])
        assert int(t_opt.count[c]) == int(j_opts[c].count) == 3


@pytest.mark.parametrize("masked", [False, True])
def test_distill_kl_matches_reference(masked):
    """Eq. 9 with the teacher cached: teacher log-probs and the T²-scaled
    mean KL, optionally restricted to the teacher's support."""
    from repro.core import distill as j_distill
    from repro_torch.core import distill as t_distill

    rng = np.random.default_rng(15)
    teacher = rng.normal(size=(2, 3, 40)).astype(np.float32)
    teacher[..., ::4] = 0.0
    student = rng.normal(size=(2, 3, 40)).astype(np.float32)
    mask = (teacher != 0) if masked else None
    j_lp = j_distill.teacher_log_probs(jnp.asarray(teacher), 2.0, mask=None if mask is None else jnp.asarray(mask))
    t_lp = t_distill.teacher_log_probs(torch.as_tensor(teacher), 2.0,
                                       mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=1e-6, atol=1e-6)
    j_kl = j_distill.kl_divergence_from_log_probs(
        j_lp, jnp.asarray(student), 2.0, mask=None if mask is None else jnp.asarray(mask))
    t_kl = t_distill.kl_divergence_from_log_probs(
        t_lp, torch.as_tensor(student), 2.0, mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(t_kl), float(j_kl), rtol=1e-5)
