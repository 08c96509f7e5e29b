"""fp16 in the port against the JAX reference, on the CPU: the kernels'
plain versions, the model of every family, AdamW and the int8 wire (the
fp16 federation is in ``tests/test_torch_fp16_round.py``).

The same numpy-seeded inputs go through both packages, rounded to fp16 once
on the JAX side and carried to the port exactly.

* The kernels' plain versions on fp16 inputs against the Pallas kernels in
  interpret mode (the ``ops`` wrappers take the plain versions for CPU
  tensors; ``chip_smoke.py`` holds the CUDA kernels to them on the card).
  Both sides upcast first (every fp16 value, subnormals included, is exact
  in fp32) and compute in fp32.  The top-k masks, the wire scatter and the
  dense aggregation are exact: the bisection's steps, the client-ordered
  fp32 sums and the aggregation's per-client multiply-adds are the same
  operations, and the one rounding to fp16 (the reference wrapper's cast)
  is the same, inf past 65 504 included.  The attention sums in another
  order than the Pallas kernel before its one rounding, so it is held at
  its fp32 tolerance plus one fp16 ulp of the output.  The KL returns fp32
  from exact fp32 inputs: its fp32 tolerance holds as it is (on a ragged
  vocabulary against the reference's plain version: its Pallas wrapper
  pads fp16 rows with -inf, and returns NaN there).
* A GPT-2-family model with ``compute_dtype="float16"``: forward, prefill
  and decode.  Each op rounds to fp16, but not at the same places in the
  two frameworks (XLA may keep fused elementwise chains in fp32, PyTorch
  rounds after each op), so logits and projections are held within four
  fp16 ulps of their largest magnitude (2^-8 relative).  Every family's
  smoke config in fp16 is in ``tests/test_torch_fp16_families.py``.
* The round body's losses with ``compute_dtype="float16"`` (the parameters
  cast inside each loss): LoRA gradients come back fp32, each rounded to
  fp16 on its way back through the cast.  On the fp32 model only the casts
  round: within 1e-4 of the gradients' largest magnitude plus one fp16 ulp
  of the gradient.  On the fp16 model, within 2^-6 of the largest
  magnitude (fp16 rounding in other places, as above, through the backward
  pass).
* AdamW with fp16 moments and with an fp32 master over fp16 live params:
  the update math is the same fp32 arithmetic on both sides, so fp16
  results agree within one fp16 ulp and the fp32 master within 1e-6
  relative.
* The int8 wire cut from fp16 logits (``sparsify_wire(..., quantize=True)``:
  fp16 values, an fp32 scale a row) is the reference's exactly, and so is
  the fp16 wire's aggregate, NaN included where no client sent a column
  (``num / (den + 1e-12)`` in fp16, whose 1e-12 is 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.core import aggregation as j_agg  # noqa: E402
from repro.core import topk as j_topk  # noqa: E402
from repro.fed import steps as jsteps  # noqa: E402
from repro.kernels.distill_kl import VOCAB_BLK, distill_kl_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ref import distill_kl_ref as j_kl_ref  # noqa: E402
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
from repro_torch.core import aggregation as t_agg  # noqa: E402
from repro_torch.core import topk as t_topk  # noqa: E402
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

MODEL_TOL = 2.0**-8  # four fp16 ulps of the largest magnitude
GRAD_TOL = 2.0**-6
HALF = dict(compute_dtype="float16")

# the tiny client config of tests/test_engine.py, and the same computing in fp16
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
J_CLIENT = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA))
T_CLIENT = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA))
J_CLIENT_H = J_CLIENT.with_overrides(**HALF)
T_CLIENT_H = T_CLIENT.with_overrides(**HALF)
NUM_CLASSES = 77


def _f16(x):
    """numpy fp32 -> (a JAX fp16 array, a torch fp16 tensor) of the same values."""
    j = jnp.asarray(x).astype(jnp.float16)
    return j, torch.as_tensor(np.array(j))


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _ulp(*xs) -> np.ndarray:
    """One fp16 ulp of the larger magnitude, elementwise (11 significant
    bits: 2^(e - 10) for a value in [2^e, 2^(e+1)), 2^-24 below 2^-14)."""
    m = np.maximum(*[np.abs(x) for x in xs]) if len(xs) > 1 else np.abs(xs[0])
    return np.where(m > 0, 2.0 ** (np.floor(np.log2(np.maximum(m, 2.0**-14))) - 10), 0.0)


def _within(t, j, tol):
    t, j = _f32(t), _f32(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(np.abs(j).max(), 1e-30))


# -- the kernels' plain versions on fp16 inputs ---------------------------------


def _edge_rows(x: np.ndarray, rng) -> None:
    """fp16's range edges in the last three rows (in place): subnormals with
    +-0 beside them, values near +-65 504, and a row past it (+-inf)."""
    vocab = x.shape[1]
    x[-3] = rng.integers(0, 1024, size=vocab) * 2.0**-24
    x[-3, :5], x[-3, 5:9] = 0.0, -0.0
    x[-2] = (65504.0 - 32.0 * rng.integers(0, 64, size=vocab)) * np.where(rng.uniform(size=vocab) < 0.5,
                                                                         -1.0, 1.0)
    x[-1] = 4e4 * rng.normal(size=vocab)


@pytest.mark.parametrize("rows,vocab", [(4, 64), (5, 1000), (8, 4096)])
def test_topk_plain_versions_on_fp16_match_the_pallas_kernels_exactly(rows, vocab):
    rng = np.random.default_rng(rows * vocab + 1)
    x = rng.normal(size=(rows, vocab)).astype(np.float32)
    x[0] = np.round(x[0] * 4) / 4  # a few distinct values: large tie groups
    _edge_rows(x, rng)
    jx, tx = _f16(x)
    ks = rng.integers(0, vocab + 3, size=rows).astype(np.int32)
    ks[0] = vocab // 3  # inside a tie group of the first row
    j_dyn = topk_mask_dynamic_pallas(jx, jnp.asarray(ks), interpret=True)
    ops.reset_launches()
    t_dyn = ops.topk_mask_dynamic(tx, torch.as_tensor(ks))
    assert t_dyn.dtype == torch.float16 and j_dyn.dtype == jnp.float16
    np.testing.assert_array_equal(_f32(t_dyn), _f32(j_dyn))
    for k in (0, 1, 7, min(257, vocab)):
        j_st = topk_mask_pallas(jx, k, interpret=True)
        for t_st in (ops.topk_mask(tx, k),
                     ref.topk_mask_ref(tx, torch.full((rows,), k, dtype=torch.int32), guard=False)):
            np.testing.assert_array_equal(_f32(t_st), _f32(j_st))
    assert sum(ops.LAUNCHES.values()) == 0
    kept = int((t_dyn[0] != 0).sum())
    assert kept > ks[0] if vocab >= 1000 else kept >= ks[0]  # the tie at the k-th value is kept


def test_scatter_wire_sums_on_fp16_match_the_pallas_kernel_exactly():
    """Including sums past 65 504, which the wrapper's cast takes to inf on
    both sides."""
    n, rows, k, vocab = 3, 5, 8, 64
    rng = np.random.default_rng(22)
    x = rng.normal(size=(n, rows, k)).astype(np.float32)
    x[:, 0] = 3e4 + x[:, 0]  # row 0: three clients of ~3e4 at one index sum past 65 504
    _, vals = _f16(x)
    idx = np.stack([np.stack([rng.permutation(vocab)[:k] for _ in range(rows)]) for _ in range(n)])
    idx[:, 0] = np.arange(k)
    mask = np.broadcast_to(np.arange(k) < np.array([k, 5, 8])[:, None, None], (n, rows, k))
    idx = np.where(mask, idx, 0).astype(np.int32)
    m = torch.as_tensor(mask.copy()).to(torch.float16)
    v = vals * m  # as aggregate_wire forms the channels, in the wire's dtype
    for a, b in ((v, torch.abs(v)), (v, m)):
        j_num, j_den = scatter_wire_sums_pallas(*(jnp.asarray(_f32(x)).astype(jnp.float16)
                                                  for x in (a, b)), jnp.asarray(idx), vocab,
                                                interpret=True)
        num, den = ops.scatter_wire_sums(a, b, torch.as_tensor(idx), vocab)
        assert num.dtype == den.dtype == torch.float16
        for got, want in ((num, j_num), (den, j_den)):
            np.testing.assert_array_equal(_f32(got), _f32(want.astype(jnp.float16)))
    num, _ = ops.scatter_wire_sums(v, torch.abs(v), torch.as_tensor(idx), vocab)
    assert bool(torch.isinf(num[0, :5]).all())  # 3 x ~3e4 at each of row 0's first 5 indices


@pytest.mark.parametrize("n,rows,vocab", [(2, 1, 64), (5, 3, 300)])
def test_sparse_aggregate_on_fp16_matches_the_pallas_kernel_exactly(n, rows, vocab):
    rng = np.random.default_rng(n * rows + 1)
    x = rng.normal(size=(n, rows, vocab)).astype(np.float32)
    x[rng.uniform(size=x.shape) >= 0.15] = 0.0
    x[0, 0, :3] = [2.0**-24, 3e-6, 6e4]  # a subnormal, a small normal and a value near the top
    jx, tx = _f16(x)
    want = sparse_agg_pallas(jx, interpret=True).astype(jnp.float16)  # the wrapper's cast
    got = ops.sparse_aggregate(tx)
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("rows,vocab", [(6, 128), (6, 4096), (6, 2048 + 17)])
def test_distill_kl_on_fp16_matches_the_pallas_kernel(rows, vocab):
    """Against the Pallas kernel where its vocabulary tiles cover the row;
    at V 2065 against the reference's plain version: the Pallas wrapper pads
    a ragged row with -1e30 in the input's dtype, -inf in fp16, and every
    padded row's KL comes out NaN there (0 * (-inf - -inf) in its U; a
    reference caveat, ROADMAP.md Queue 3), where the plain log-sum-exp, the
    port and its kernel give the KL."""
    rng = np.random.default_rng(rows + vocab + 1)
    t = (4 * rng.normal(size=(rows, vocab))).astype(np.float32)
    s = (4 * rng.normal(size=(rows, vocab))).astype(np.float32)
    s[0] = t[0]
    t[1, ::3] = s[1, ::3] = -6e4  # fp16's -1e30 is -inf, and its KL NaN
    t[2] = np.clip(t[2] * 5e3, -6e4, 6e4)  # logits of up to +-6e4, inside fp16's range
    (jt, tt), (js, ts) = _f16(t), _f16(s)
    ragged = vocab % VOCAB_BLK and vocab > VOCAB_BLK
    for temp in (1.0, 2.0):
        want = np.asarray(j_kl_ref(jt, js, temp) if ragged
                          else distill_kl_pallas(jt, js, temp, interpret=True))
        got = ops.distill_kl_rows(tt, ts, temp)
        assert got.dtype == torch.float32
        lse = lambda x: np.logaddexp.reduce(_f32(x).astype(np.float64) / temp, axis=-1)  # noqa: E731
        scale = 1.0 + np.abs(lse(tt)) + np.abs(lse(ts))
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.abs(want) + 2e-6 * scale)
        assert float(got[0]) == 0.0
    if ragged:  # the caveat, as it stands
        assert np.isnan(np.asarray(distill_kl_pallas(jt, js, 2.0, interpret=True))).all()


@pytest.mark.parametrize("shape", [(1, 128, 64), (2, 256, 64), (1, 128, 128), (2, 256, 128)])
def test_flash_attention_on_fp16_matches_the_pallas_kernel(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    (jq, tq), (jk, tk), (jv, tv) = (_f16(rng.normal(size=shape).astype(np.float32))
                                    for _ in range(3))
    want = flash_attention_pallas(jq, jk, jv, interpret=True)
    assert want.dtype == jnp.float16
    for got in (ops.flash_attention(tq, tk, tv), ref.flash_attention_ref(tq, tk, tv)):
        assert got.dtype == torch.float16
        g, w = _f32(got), _f32(want)
        assert np.all(np.abs(g - w) <= 1e-5 * np.abs(_f32(tv)).max() + _ulp(g, w))


def test_int8_wire_from_fp16_logits_is_the_references():
    """``sparsify_wire(..., quantize=True)`` on fp16 logits: the same
    indices, masks, int8 values and fp32 scales as the reference's."""
    rng = np.random.default_rng(40)
    jx, tx = _f16(rng.normal(size=(4, 6, 300)).astype(np.float32) * 3.0)
    ks = np.array([64, 17, 0, 64], dtype=np.int32)
    j_w = j_topk.sparsify_wire(jx, jnp.asarray(ks), 64, quantize=True)
    t_w = t_topk.sparsify_wire(tx, torch.as_tensor(ks), 64, quantize=True)
    assert t_w.values.dtype == torch.int8 and t_w.scale.dtype == torch.float32
    for name in ("values", "scale", "indices", "mask"):
        np.testing.assert_array_equal(np.asarray(getattr(t_w, name)), np.asarray(getattr(j_w, name)))


@pytest.mark.parametrize("mode", ["adaptive", "mean_nonzero", "zeropad"])
def test_fp16_wire_aggregate_is_the_references_nan_included(mode):
    """``aggregate_wire`` on an fp16 wire, kernel route and plain: the
    reference's values bitwise.  Where no client sent a column, adaptive
    and mean_nonzero divide 0 by ``0 + 1e-12``, and 1e-12 is 0 in fp16: NaN
    in both packages (ROADMAP.md Queue 3); zeropad divides by the
    transmitter count and stays finite."""
    rng = np.random.default_rng(41)
    jx, tx = _f16(rng.normal(size=(3, 4, 300)).astype(np.float32) * 3.0)
    ks = np.array([40, 10, 0], dtype=np.int32)
    j_w = j_topk.sparsify_wire(jx, jnp.asarray(ks), 64)
    t_w = t_topk.sparsify_wire(tx, torch.as_tensor(ks), 64)
    want = _f32(j_agg.aggregate_wire(j_w, mode, use_kernel=True))
    for use_kernel in (False, True):
        got = t_agg.aggregate_wire(t_w, mode, use_kernel=use_kernel)
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(_f32(got), want)
    empty = ~t_topk.wire_support(t_w).any(dim=0).numpy()
    assert np.array_equal(np.isnan(want), empty if mode != "zeropad" else np.zeros_like(empty))


# -- the model in fp16 -------------------------------------------------------------


def _jax_params(cfg, seed):
    """The reference init with random (non-zero) LoRA B factors."""
    rng = np.random.default_rng(seed)

    def live_b(path, x):
        if getattr(path[-1], "key", None) == "B":
            return jnp.asarray(0.05 * rng.normal(size=x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(live_b, j_init(jax.random.PRNGKey(seed), cfg))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("last_only", [False, True])
def test_fp16_forward_matches_reference(last_only):
    jp = _jax_params(J_CLIENT_H, 2)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tok = _tokens(3, (4, 12))
    j_logits, j_aux = j_forward(jp, J_CLIENT_H, {"tokens": jnp.asarray(tok)}, last_only=last_only)
    t_logits, t_aux = t_forward(tp, T_CLIENT_H, torch.as_tensor(tok)[None], last_only=last_only)
    assert t_logits.dtype == torch.float16 and j_logits.dtype == jnp.float16
    _within(t_logits[0], j_logits, MODEL_TOL)
    _within(t_aux.lora_h[0], j_aux.lora_h, MODEL_TOL)


def test_fp16_prefill_and_decode_match_reference():
    """A prefill, then six tokens through a decode cache of four slots (the
    ring wraps): logits at every step, the cache in the compute dtype."""
    jp = _jax_params(J_CLIENT_H, 4)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _tokens(5, (3, 12))
    j_pre = j_prefill_step(J_CLIENT_H)(jp, {"tokens": jnp.asarray(prompts)})
    t_pre = make_prefill_step(T_CLIENT_H)(tp, {"tokens": torch.as_tensor(prompts).long()})
    _within(t_pre, j_pre, MODEL_TOL)
    j_cache, t_cache = j_init_cache(J_CLIENT_H, 3, 4), t_init_cache(T_CLIENT_H, 3, 4, device="cpu")
    assert t_cache["layers"]["pos0"].k.dtype == torch.float16
    assert j_cache["layers"]["pos0"].k.dtype == jnp.float16
    toks = _tokens(6, (3, 6))
    for i in range(toks.shape[1]):
        j_logits, j_cache = j_decode(jp, J_CLIENT_H, j_cache, jnp.asarray(toks[:, i]))
        t_logits, t_cache = t_decode(tp, T_CLIENT_H, t_cache, torch.as_tensor(toks[:, i]).long())
        assert t_logits.dtype == torch.float16
        _within(t_logits, j_logits, MODEL_TOL)
    _within(t_cache["layers"]["pos0"].k, j_cache["layers"]["pos0"].k, MODEL_TOL)
    _within(t_cache["layers"]["pos0"].v, j_cache["layers"]["pos0"].v, MODEL_TOL)


def test_fp16_param_dtype_init_and_bridge():
    """``param_dtype="float16"``: the port draws in fp32 and stores fp16;
    an fp16 reference init crosses the bridge exactly (both ways) and runs
    the same forward."""
    both = dict(param_dtype="float16", compute_dtype="float16")
    t32, th = t_init(T_CLIENT, 0, "cpu"), t_init(T_CLIENT.with_overrides(**both), 0, "cpu")
    assert all(v.dtype == torch.float16 for v in th.values())
    assert all(torch.equal(th[k], v.to(torch.float16)) for k, v in t32.items())
    jcfg, tcfg = J_CLIENT.with_overrides(**both), T_CLIENT.with_overrides(**both)
    jp = _jax_params(jcfg, 7)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    for k, v in bridge.flatten(jax.tree.map(np.asarray, jp)).items():
        assert tp[k].dtype == torch.float16 and v.dtype == np.float16
        np.testing.assert_array_equal(tp[k].numpy(), v)
    back = bridge.flatten(bridge.to_numpy_tree(tp))
    assert all(back[k].dtype == np.float16 and np.array_equal(back[k], tp[k].numpy()) for k in tp)
    tok = _tokens(8, (2, 12))
    j_logits, _ = j_forward(jp, jcfg, {"tokens": jnp.asarray(tok)}, last_only=True)
    t_logits, _ = t_forward(tp, tcfg, torch.as_tensor(tok)[None], last_only=True)
    _within(t_logits[0], j_logits, MODEL_TOL)


@pytest.mark.parametrize("half_model", [False, True], ids=["fp32_model", "fp16_model"])
def test_fp16_round_body_gradients_match_jax_grad(half_model):
    """The fine-tune and cached-teacher distill losses of the round body
    (``compute_dtype="float16"``): the parameters are cast inside the
    loss, and the LoRA gradients come back fp32."""
    jcfg, tcfg = (J_CLIENT_H, T_CLIENT_H) if half_model else (J_CLIENT, T_CLIENT)
    jps = [_jax_params(jcfg, s) for s in (8, 9)]
    tps = [bridge.to_torch(jax.tree.map(np.asarray, p), "cpu") for p in jps]
    t_lora, t_frozen = ({k: torch.stack([d[k] for d in ds]) for k in ds[0]}
                        for ds in zip(*(t_split(p) for p in tps)))
    tok = _tokens(10, (2, 6, 12))
    labels = np.random.default_rng(11).integers(0, NUM_CLASSES, size=(2, 6)).astype(np.int32)
    pub = _tokens(12, (5, 12))
    rng = np.random.default_rng(13)
    # the teacher in the model's compute dtype, as the round hands it on
    (j_teacher, t_teacher), (j_th, t_th) = (_f16(rng.normal(size=s).astype(np.float32))
                                            for s in ((5, 256), (5, 4)))
    if not half_model:
        j_teacher, t_teacher, j_th, t_th = (x.astype(jnp.float32) if isinstance(x, jax.Array)
                                            else x.float() for x in (j_teacher, t_teacher, j_th, t_th))
    cd = "float16"
    j_ft = jax.jit(jax.value_and_grad(jsteps._finetune_loss_fn(jcfg, NUM_CLASSES, compute_dtype=cd),
                                      has_aux=True))
    j_kd = jax.jit(jax.value_and_grad(jsteps._distill_loss_cached_fn(jcfg, 2.0, 0.03, compute_dtype=cd),
                                      has_aux=True))
    j_cache = jsteps._teacher_cache_fn(2.0, False, True)(j_teacher, j_th)
    t_ft = tsteps._finetune_loss_fn(tcfg, NUM_CLASSES, compute_dtype=cd)
    t_kd = tsteps._distill_loss_cached_fn(tcfg, 2.0, 0.03, compute_dtype=cd)
    t_cache = tsteps._teacher_cache_fn(2.0, False, True)(t_teacher, t_th)
    assert (t_cache[0].dtype == torch.float16) == (j_cache[0].dtype == jnp.float16) == half_model
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
                if half_model:
                    _within(grads_t[k][c], g, GRAD_TOL)
                else:
                    t = _f32(grads_t[k][c])
                    assert np.all(np.abs(t - g) <= 1e-4 * np.abs(g).max() + _ulp(t, g)), k


# -- AdamW with fp16 state and an fp32 master -----------------------------------------


def test_adamw_fp16_state_matches_reference():
    """fp16 params and fp16 moments, three steps of fp16 gradients: dtypes
    kept, the count advanced, and each value within one fp16 ulp of the
    reference's."""
    rng = np.random.default_rng(32)
    (jw, tw), (jb, tb) = (_f16(rng.normal(size=s).astype(np.float32)) for s in ((6, 4), (4,)))
    j_p, t_p = {"w": jw, "b": jb}, {"w": tw[None], "b": tb[None]}
    j_o, t_o = j_adamw_init(j_p, state_dtype="float16"), t_adamw_init(t_p, state_dtype="float16")
    assert t_o.m["w"].dtype == t_o.v["b"].dtype == torch.float16 and t_o.master is None
    for step in range(3):
        g = {k: _f16((0.3 * rng.normal(size=v.shape[1:])).astype(np.float32)) for k, v in t_p.items()}
        j_p, j_o = j_adamw_update({k: x[0] for k, x in g.items()}, j_o, j_p, lr=1e-2, weight_decay=1e-3)
        t_p, t_o = t_adamw_update({k: x[1][None] for k, x in g.items()}, t_o, t_p, lr=1e-2,
                                  weight_decay=1e-3)
    for k in t_p:
        assert t_p[k].dtype == t_o.m[k].dtype == t_o.v[k].dtype == torch.float16
        for t, j in ((t_p[k][0], j_p[k]), (t_o.m[k][0], j_o.m[k]), (t_o.v[k][0], j_o.v[k])):
            g, w = _f32(t), _f32(j)
            assert np.all(np.abs(g - w) <= _ulp(g, w)), k
    assert int(t_o.count[0]) == int(j_o.count) == 3


def test_adamw_fp32_master_over_fp16_params_matches_reference():
    """fp16 live params with an fp32 master: the master tracks the
    reference's master and the all-fp32 trajectory, and the live params
    are exactly its cast."""
    rng = np.random.default_rng(33)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    jw, tw = _f16(w0)
    j_p, t_p = {"w": jw}, {"w": tw[None]}
    j_o, t_o = j_adamw_init(j_p, master_dtype="float32"), t_adamw_init(t_p, master_dtype="float32")
    assert t_o.master["w"].dtype == torch.float32 and t_o.m["w"].dtype == torch.float32
    p32 = {"w": torch.as_tensor(w0)[None]}
    o32 = t_adamw_init(p32)
    for _ in range(20):
        g = (1e-3 * rng.normal(size=(64,))).astype(np.float32)
        jg, tg = _f16(g)
        j_p, j_o = j_adamw_update({"w": jg}, j_o, j_p, lr=1e-3)
        t_p, t_o = t_adamw_update({"w": tg[None]}, t_o, t_p, lr=1e-3)
        p32, o32 = t_adamw_update({"w": torch.as_tensor(g)[None]}, o32, p32, lr=1e-3)
    assert t_p["w"].dtype == torch.float16 and t_o.master["w"].dtype == torch.float32
    np.testing.assert_allclose(t_o.master["w"][0].numpy(), np.asarray(j_o.master["w"]),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(t_p["w"], t_o.master["w"].to(torch.float16))  # never stale
    assert float((t_o.master["w"] - p32["w"]).abs().max()) < 0.02
