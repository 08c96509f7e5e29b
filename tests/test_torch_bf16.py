"""bf16 in the port against the JAX reference, on the CPU: the kernels'
plain versions, the model and AdamW (the bf16 federation is in
``tests/test_torch_bf16_round.py``).

The same numpy-seeded inputs go through both packages, rounded to bf16 once
on the JAX side and carried to the port exactly.

* The kernels' plain versions on bf16 inputs against the Pallas kernels in
  interpret mode (the ``ops`` wrappers take the plain versions for CPU
  tensors; ``chip_smoke.py`` holds the CUDA kernels to them on the card).
  Both sides upcast first and compute in fp32.  The top-k masks and the
  wire scatter are exact: the bisection's steps and the client-ordered
  fp32 sums are the same operations, and the sums' one rounding to bf16
  (the reference wrapper's cast) is the same.  The dense aggregation and
  the attention sum in another order than the Pallas kernels before their
  one rounding to bf16, so they are held at their fp32 tolerance plus one
  bf16 ulp of the output (two fp32 values that close can round to
  neighbouring bf16 values).  The KL returns fp32 from exact fp32 inputs:
  its fp32 tolerance holds as it is.
* A GPT-2-family model with ``compute_dtype="bfloat16"``: forward, prefill
  and decode.  Each op rounds to bf16, but not at the same places in the
  two frameworks (XLA may keep fused elementwise chains in fp32, PyTorch
  rounds after each op), so logits and projections are held within four
  bf16 ulps of their largest magnitude (2^-6 relative; the measured gap is
  about two).
* The round body's losses with ``compute_dtype="bfloat16"`` (the
  parameters cast inside each loss, as the reference's ``_cast_params``
  does): LoRA gradients come back fp32, each rounded to bf16 on its way
  back through the cast.  On the fp32 model only the casts round and the
  model computes the same fp32 function on both sides: within 1e-4 of the
  gradients' largest magnitude plus one bf16 ulp of the gradient (two fp32
  gradients that close can round to neighbouring bf16 values).  On the
  bf16 model, within 2^-4 of the largest magnitude (bf16 rounding in
  other places, as above, through the backward pass).
* AdamW with bf16 moments and with an fp32 master: the update math is the
  same fp32 arithmetic on both sides, so bf16 results agree within one
  bf16 ulp and the fp32 master within 1e-6 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.fed import steps as jsteps  # noqa: E402
from repro.kernels.distill_kl import distill_kl_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.sparse_agg import scatter_wire_sums_pallas, sparse_agg_pallas  # noqa: E402
from repro.kernels.topk_select import topk_mask_dynamic_pallas, topk_mask_pallas  # noqa: E402
from repro.lora import split_lora as j_split  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.serve import make_prefill_step as j_prefill_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.fed import steps as tsteps  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.lora import split_lora as t_split  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init as t_init  # noqa: E402
from repro_torch.models import init_cache as t_init_cache  # noqa: E402
from repro_torch.optim import adamw_init as t_adamw_init  # noqa: E402
from repro_torch.optim import adamw_update as t_adamw_update  # noqa: E402
from repro_torch.serve import make_prefill_step  # noqa: E402

MODEL_TOL = 2.0**-6  # four bf16 ulps of the largest magnitude
GRAD_TOL = 2.0**-4

# the tiny client config of tests/test_engine.py, and the same computing in bf16
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
J_CLIENT = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA))
T_CLIENT = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA))
J_CLIENT_BF = J_CLIENT.with_overrides(compute_dtype="bfloat16")
T_CLIENT_BF = T_CLIENT.with_overrides(compute_dtype="bfloat16")
NUM_CLASSES = 77


def _bf16(x):
    """numpy fp32 -> (a JAX bf16 array, a torch bf16 tensor) of the same values."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _ulp(*xs) -> np.ndarray:
    """One bf16 ulp of the larger magnitude, elementwise (8 significant bits:
    2^(e - 7) for a value in [2^e, 2^(e+1)))."""
    m = np.maximum(*[np.abs(x) for x in xs]) if len(xs) > 1 else np.abs(xs[0])
    return np.where(m > 0, 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-38))) - 7), 0.0)


def _within(t, j, tol):
    t, j = _f32(t), _f32(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(np.abs(j).max(), 1e-30))


# -- the kernels' plain versions on bf16 inputs ---------------------------------


@pytest.mark.parametrize("rows,vocab", [(1, 64), (3, 1000), (8, 4096)])
def test_topk_plain_versions_on_bf16_match_the_pallas_kernels_exactly(rows, vocab):
    rng = np.random.default_rng(rows * vocab)
    x = rng.normal(size=(rows, vocab)).astype(np.float32)
    x[-1] = np.round(x[-1] * 4) / 4  # a few distinct values: large tie groups
    jx, tx = _bf16(x)
    ks = rng.integers(0, vocab + 3, size=rows).astype(np.int32)
    ks[-1] = vocab // 3  # inside a tie group of the last row
    j_dyn = topk_mask_dynamic_pallas(jx, jnp.asarray(ks), interpret=True)
    ops.reset_launches()
    t_dyn = ops.topk_mask_dynamic(tx, torch.as_tensor(ks))
    assert t_dyn.dtype == torch.bfloat16 and j_dyn.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(t_dyn), _f32(j_dyn))
    for k in (1, 7, min(257, vocab)):
        j_st = topk_mask_pallas(jx, k, interpret=True)
        for t_st in (ops.topk_mask(tx, k),
                     ref.topk_mask_ref(tx, torch.full((rows,), k, dtype=torch.int32), guard=False)):
            np.testing.assert_array_equal(_f32(t_st), _f32(j_st))
    assert sum(ops.LAUNCHES.values()) == 0
    kept = int((t_dyn[-1] != 0).sum())
    assert kept > ks[-1] if vocab >= 1000 else kept >= ks[-1]  # the tie at the k-th value is kept


def test_scatter_wire_sums_on_bf16_match_the_pallas_kernel_exactly():
    n, rows, k, vocab = 3, 5, 8, 64
    rng = np.random.default_rng(21)
    _, vals = _bf16(rng.normal(size=(n, rows, k)).astype(np.float32))
    idx = np.stack([np.stack([rng.permutation(vocab)[:k] for _ in range(rows)]) for _ in range(n)])
    mask = np.broadcast_to(np.arange(k) < np.array([k, 5, 0])[:, None, None], (n, rows, k))
    idx = np.where(mask, idx, 0).astype(np.int32)
    m = torch.as_tensor(mask.copy()).to(torch.bfloat16)
    v = vals * m  # as aggregate_wire forms the channels, in the wire's dtype
    for a, b in ((torch.abs(v) * v, torch.abs(v)), (v, m)):  # adaptive; zeropad / mean_nonzero
        j_num, j_den = scatter_wire_sums_pallas(*(jnp.asarray(_f32(x)).astype(jnp.bfloat16)
                                                  for x in (a, b)), jnp.asarray(idx), vocab,
                                                interpret=True)
        num, den = ops.scatter_wire_sums(a, b, torch.as_tensor(idx), vocab)
        assert num.dtype == den.dtype == torch.bfloat16
        # the reference wrapper casts the fp32 sums to the wire's dtype
        for got, want in ((num, j_num), (den, j_den)):
            np.testing.assert_array_equal(_f32(got), _f32(want.astype(jnp.bfloat16)))


@pytest.mark.parametrize("n,rows,vocab", [(2, 1, 64), (5, 3, 300)])
def test_sparse_aggregate_on_bf16_matches_the_pallas_kernel(n, rows, vocab):
    rng = np.random.default_rng(n * rows)
    x = rng.normal(size=(n, rows, vocab)).astype(np.float32)
    x[rng.uniform(size=x.shape) >= 0.15] = 0.0
    jx, tx = _bf16(x)
    want = sparse_agg_pallas(jx, interpret=True).astype(jnp.bfloat16)  # the wrapper's cast
    got = ops.sparse_aggregate(tx)
    assert got.dtype == torch.bfloat16
    w, g = _f32(want), _f32(got)
    assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w).max() + _ulp(g, w))


@pytest.mark.parametrize("rows,vocab", [(6, 128), (6, 2048 + 17)])
def test_distill_kl_on_bf16_matches_the_pallas_kernel(rows, vocab):
    rng = np.random.default_rng(rows + vocab)
    t = (4 * rng.normal(size=(rows, vocab))).astype(np.float32)
    s = (4 * rng.normal(size=(rows, vocab))).astype(np.float32)
    s[0] = t[0]
    t[1, ::3] = s[1, ::3] = -1e30
    (jt, tt), (js, ts) = _bf16(t), _bf16(s)
    for temp in (1.0, 2.0):
        want = np.asarray(distill_kl_pallas(jt, js, temp, interpret=True))
        got = ops.distill_kl_rows(tt, ts, temp)
        assert got.dtype == torch.float32
        lse = lambda x: np.logaddexp.reduce(_f32(x).astype(np.float64) / temp, axis=-1)  # noqa: E731
        scale = 1.0 + np.abs(lse(tt)) + np.abs(lse(ts))
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.abs(want) + 2e-6 * scale)
        assert float(got[0]) == 0.0


@pytest.mark.parametrize("shape", [(1, 128, 64), (2, 256, 64), (1, 128, 128), (2, 256, 128)])
def test_flash_attention_on_bf16_matches_the_pallas_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng.normal(size=shape).astype(np.float32))
                                    for _ in range(3))
    want = flash_attention_pallas(jq, jk, jv, interpret=True)
    assert want.dtype == jnp.bfloat16
    for got in (ops.flash_attention(tq, tk, tv), ref.flash_attention_ref(tq, tk, tv)):
        assert got.dtype == torch.bfloat16
        g, w = _f32(got), _f32(want)
        assert np.all(np.abs(g - w) <= 1e-5 * np.abs(_f32(tv)).max() + _ulp(g, w))


# -- the model in bf16 -------------------------------------------------------------


def _jax_params(cfg, seed):
    """The reference init with random (non-zero) LoRA B factors."""
    rng = np.random.default_rng(seed)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(live_b, j_init(jax.random.PRNGKey(seed), cfg))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("last_only", [False, True])
def test_bf16_forward_matches_reference(last_only):
    jp = _jax_params(J_CLIENT_BF, 2)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(3, (4, 12))
    j_logits, j_aux = j_forward(jp, J_CLIENT_BF, {"tokens": jnp.asarray(tok)}, last_only=last_only)
    t_logits, t_aux = t_forward(tp, T_CLIENT_BF, torch.as_tensor(tok)[None], last_only=last_only)
    assert t_logits.dtype == torch.bfloat16 and j_logits.dtype == jnp.bfloat16
    _within(t_logits[0], j_logits, MODEL_TOL)
    _within(t_aux.lora_h[0], j_aux.lora_h, MODEL_TOL)


def test_bf16_prefill_and_decode_match_reference():
    """A prefill, then six tokens through a decode cache of four slots (the
    ring wraps): logits at every step, the cache in the compute dtype."""
    jp = _jax_params(J_CLIENT_BF, 4)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _tokens(5, (3, 12))
    j_pre = j_prefill_step(J_CLIENT_BF)(jp, {"tokens": jnp.asarray(prompts)})
    t_pre = make_prefill_step(T_CLIENT_BF)(tp, {"tokens": torch.as_tensor(prompts).long()})
    _within(t_pre, j_pre, MODEL_TOL)
    j_cache, t_cache = j_init_cache(J_CLIENT_BF, 3, 4), t_init_cache(T_CLIENT_BF, 3, 4, device="cpu")
    assert t_cache["layers"]["pos0"].k.dtype == torch.bfloat16
    assert j_cache["layers"]["pos0"].k.dtype == jnp.bfloat16
    toks = _tokens(6, (3, 6))
    for i in range(toks.shape[1]):
        j_logits, j_cache = j_decode(jp, J_CLIENT_BF, j_cache, jnp.asarray(toks[:, i]))
        t_logits, t_cache = t_decode(tp, T_CLIENT_BF, t_cache, torch.as_tensor(toks[:, i]).long())
        assert t_logits.dtype == torch.bfloat16
        _within(t_logits, j_logits, MODEL_TOL)
    _within(t_cache["layers"]["pos0"].k, j_cache["layers"]["pos0"].k, MODEL_TOL)
    _within(t_cache["layers"]["pos0"].v, j_cache["layers"]["pos0"].v, MODEL_TOL)


def test_bf16_param_dtype_init_and_bridge():
    """``param_dtype="bfloat16"``: the port draws in fp32 and stores bf16;
    a bf16 reference init crosses the bridge exactly and runs the same
    forward."""
    both = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    t32, tbf = t_init(T_CLIENT, 0, "cpu"), t_init(T_CLIENT.with_overrides(**both), 0, "cpu")
    assert all(v.dtype == torch.bfloat16 for v in tbf.values())
    assert all(torch.equal(tbf[k], v.to(torch.bfloat16)) for k, v in t32.items())
    jcfg, tcfg = J_CLIENT.with_overrides(**both), T_CLIENT.with_overrides(**both)
    jp = _jax_params(jcfg, 7)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    for k, v in bridge.flatten(jax.tree.map(np.asarray, jp)).items():
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(tp[k]), v.astype(np.float32))
    tok = _tokens(8, (2, 12))
    j_logits, _ = j_forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, last_only=True)
    t_logits, _ = t_forward(tp, tcfg, torch.as_tensor(tok)[None], last_only=True)
    _within(t_logits[0], j_logits, MODEL_TOL)


@pytest.mark.parametrize("bf16_model", [False, True], ids=["fp32_model", "bf16_model"])
def test_bf16_round_body_gradients_match_jax_grad(bf16_model):
    """The fine-tune and cached-teacher distill losses of the round body
    (``compute_dtype="bfloat16"``): the parameters are cast inside the
    loss, and the LoRA gradients come back fp32."""
    jcfg, tcfg = (J_CLIENT_BF, T_CLIENT_BF) if bf16_model else (J_CLIENT, T_CLIENT)
    jps = [_jax_params(jcfg, s) for s in (8, 9)]
    tps = [bridge.to_torch(jax.tree.map(np.asarray, p), "cpu") for p in jps]
    t_lora, t_frozen = ({k: torch.stack([d[k] for d in ds]) for k in ds[0]}
                        for ds in zip(*(t_split(p) for p in tps)))
    tok = _tokens(10, (2, 6, 12))
    labels = np.random.default_rng(11).integers(0, NUM_CLASSES, size=(2, 6)).astype(np.int32)
    pub = _tokens(12, (5, 12))
    rng = np.random.default_rng(13)
    # the teacher in the model's compute dtype, as the round hands it on
    (j_teacher, t_teacher), (j_th, t_th) = (_bf16(rng.normal(size=s).astype(np.float32))
                                            for s in ((5, 256), (5, 4)))
    if not bf16_model:
        j_teacher, t_teacher, j_th, t_th = (x.astype(jnp.float32) if isinstance(x, jax.Array)
                                            else x.float() for x in (j_teacher, t_teacher, j_th, t_th))
    cd = "bfloat16"
    j_ft = jax.jit(jax.value_and_grad(jsteps._finetune_loss_fn(jcfg, NUM_CLASSES, compute_dtype=cd),
                                      has_aux=True))
    j_kd = jax.jit(jax.value_and_grad(jsteps._distill_loss_cached_fn(jcfg, 2.0, 0.03, compute_dtype=cd),
                                      has_aux=True))
    j_cache = jsteps._teacher_cache_fn(2.0, False, True)(j_teacher, j_th)
    t_ft = tsteps._finetune_loss_fn(tcfg, NUM_CLASSES, compute_dtype=cd)
    t_kd = tsteps._distill_loss_cached_fn(tcfg, 2.0, 0.03, compute_dtype=cd)
    t_cache = tsteps._teacher_cache_fn(2.0, False, True)(t_teacher, t_th)
    assert (t_cache[0].dtype == torch.bfloat16) == (j_cache[0].dtype == jnp.bfloat16) == bf16_model
    _, t_ft_g = tsteps._grads(t_ft, t_lora, t_frozen, torch.as_tensor(tok), torch.as_tensor(labels))
    _, t_kd_g = tsteps._grads(t_kd, t_lora, t_frozen, torch.as_tensor(pub).expand(2, 5, 12), *t_cache)
    for c, jp in enumerate(jps):
        j_lora, j_frozen = j_split(jp)
        (_, _), j_g = j_ft(j_lora, j_frozen, {"tokens": jnp.asarray(tok[c]),
                                             "labels": jnp.asarray(labels[c])})
        (_, _), k_g = j_kd(j_lora, j_frozen, jnp.asarray(pub), *j_cache)
        for grads_t, grads_j in ((t_ft_g, j_g), (t_kd_g, k_g)):
            for k, g in bridge.flatten(jax.tree.map(np.asarray, grads_j)).items():
                assert grads_t[k].dtype == torch.float32 and g.dtype == np.float32, k
                if bf16_model:
                    _within(grads_t[k][c], g, GRAD_TOL)
                else:
                    t = _f32(grads_t[k][c])
                    assert np.all(np.abs(t - g) <= 1e-4 * np.abs(g).max() + _ulp(t, g)), k


# -- AdamW with bf16 state and an fp32 master -----------------------------------------


def test_adamw_bf16_state_matches_reference():
    """bf16 params and bf16 moments, three steps of bf16 gradients (the
    claims of ``tests/test_optim.py::test_adamw_bf16_state_roundtrip``):
    dtypes kept, the count advanced, and each value within one bf16 ulp of
    the reference's."""
    rng = np.random.default_rng(30)
    (jw, tw), (jb, tb) = (_bf16(rng.normal(size=s).astype(np.float32)) for s in ((6, 4), (4,)))
    j_p, t_p = {"w": jw, "b": jb}, {"w": tw[None], "b": tb[None]}
    j_o, t_o = j_adamw_init(j_p, state_dtype="bfloat16"), t_adamw_init(t_p, state_dtype="bfloat16")
    assert t_o.m["w"].dtype == t_o.v["b"].dtype == torch.bfloat16 and t_o.master is None
    for step in range(3):
        g = {k: _bf16((0.3 * rng.normal(size=v.shape[1:])).astype(np.float32)) for k, v in t_p.items()}
        j_p, j_o = j_adamw_update({k: x[0] for k, x in g.items()}, j_o, j_p, lr=1e-2, weight_decay=1e-3)
        t_p, t_o = t_adamw_update({k: x[1][None] for k, x in g.items()}, t_o, t_p, lr=1e-2,
                                  weight_decay=1e-3)
    for k in t_p:
        assert t_p[k].dtype == t_o.m[k].dtype == t_o.v[k].dtype == torch.bfloat16
        for t, j in ((t_p[k][0], j_p[k]), (t_o.m[k][0], j_o.m[k]), (t_o.v[k][0], j_o.v[k])):
            g, w = _f32(t), _f32(j)
            assert np.all(np.abs(g - w) <= _ulp(g, w)), k
    assert int(t_o.count[0]) == int(j_o.count) == 3


def test_adamw_master_matches_reference():
    """bf16 live params with an fp32 master (the claims of
    ``tests/test_optim.py::test_adamw_master_tracks_fp32_reference``): the
    master tracks the reference's master and the all-fp32 trajectory, the
    live params are exactly its cast, and without a master the update is
    the classic one."""
    rng = np.random.default_rng(31)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    jw, tw = _bf16(w0)
    j_p, t_p = {"w": jw}, {"w": tw[None]}
    j_o, t_o = j_adamw_init(j_p, master_dtype="float32"), t_adamw_init(t_p, master_dtype="float32")
    assert t_o.master["w"].dtype == torch.float32 and t_o.m["w"].dtype == torch.float32
    p32, o32 = {"w": torch.as_tensor(w0)[None]}, None
    o32 = t_adamw_init(p32)
    for _ in range(20):
        g = (1e-3 * rng.normal(size=(64,))).astype(np.float32)
        jg, tg = _bf16(g)
        j_p, j_o = j_adamw_update({"w": jg}, j_o, j_p, lr=1e-3)
        t_p, t_o = t_adamw_update({"w": tg[None]}, t_o, t_p, lr=1e-3)
        p32, o32 = t_adamw_update({"w": torch.as_tensor(g)[None]}, o32, p32, lr=1e-3)
    assert t_p["w"].dtype == torch.bfloat16 and t_o.master["w"].dtype == torch.float32
    np.testing.assert_allclose(t_o.master["w"][0].numpy(), np.asarray(j_o.master["w"]),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(t_p["w"], t_o.master["w"].to(torch.bfloat16))  # never stale
    assert float((t_o.master["w"] - p32["w"]).abs().max()) < 0.02
    # masterless: the state has no master, and fp32 params take the classic step
    o = t_adamw_init({"w": torch.tensor([[1.0, -2.0, 0.5]])})
    new_p, new_o = t_adamw_update({"w": torch.tensor([[0.1, 0.2, -0.3]])}, o,
                                  {"w": torch.tensor([[1.0, -2.0, 0.5]])}, lr=1e-2)
    assert o.master is None and new_o.master is None
    np.testing.assert_allclose(new_p["w"][0].numpy(), [0.99, -2.01, 0.51], rtol=1e-6)
