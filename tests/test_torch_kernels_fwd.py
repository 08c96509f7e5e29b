"""The port's forward-only kernels — the fused distillation KL (kernel 6) and
causal flash attention (kernel 7) — against the JAX reference, on the CPU.

Here the ``ops`` wrappers run their plain PyTorch versions (the tensors lie
on the CPU); ``chip_smoke.py`` holds the CUDA kernels against those plain
versions on the card.  Inputs are made with numpy from a seed and handed
to the Pallas kernels in interpret mode and to the reference's plain
versions.

Tolerances.  The KL kernels sum online, tile by tile; the plain versions
take a log-sum-exp and then the weighted sum: the result is a difference
of terms of the size of the log-partitions ``|lse_t|, |lse_s|``, each
carried in fp32, so a row is held within ``rtol 1e-5`` of its value plus
``2e-6 · (1 + |lse_t| + |lse_s|)`` (a few ulps of the largest term).  The
plain versions of both packages compute the same formula and agree within
``1e-6`` of that scale.  Attention outputs are convex combinations of v
rows: held within ``1e-5 · max|v|`` (fp32 sums of at most S terms in
another order).  Causality is bitwise: changing k and v at or after a
position leaves every earlier output unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import distill as jdistill  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.distill_kl import distill_kl_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.core import distill as tdistill  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TEMPS = (1.0, 2.0, 4.0)


def _logits(seed, rows=6, vocab=300, scale=3.0):
    """Teacher and student rows with the edge cases in them: row 0 has the
    teacher equal to the student, row 1 logits of ±3e4 (the online rescale),
    row 2 entries at -1e30 on both sides (masked vocabulary), row 3 -1e30
    on the teacher only."""
    rng = np.random.default_rng(seed)
    t = (scale * rng.normal(size=(rows, vocab))).astype(np.float32)
    s = (scale * rng.normal(size=(rows, vocab))).astype(np.float32)
    s[0] = t[0]
    t[1] = rng.uniform(-3e4, 3e4, size=vocab)
    s[1] = t[1] + rng.normal(size=vocab).astype(np.float32)
    t[2, ::3] = s[2, ::3] = -1e30
    t[3, 1::4] = -1e30
    return t, s


def _lse_scale(t, s, temp):
    lse = lambda x: np.logaddexp.reduce(x.astype(np.float64) / temp, axis=-1)  # noqa: E731
    return 1.0 + np.abs(lse(t)) + np.abs(lse(s))


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("vocab", [300, 2048 + 17])
def test_distill_kl_matches_reference(temp, vocab):
    t, s = _logits(int(temp) + vocab, vocab=vocab)
    j_kern = np.asarray(distill_kl_pallas(jnp.asarray(t), jnp.asarray(s), temp, interpret=True))
    j_ref = np.asarray(jref.distill_kl_ref(jnp.asarray(t), jnp.asarray(s), temp))
    got = ref.distill_kl_ref(torch.as_tensor(t), torch.as_tensor(s), temp).numpy()
    scale = _lse_scale(t, s, temp)
    assert np.all(np.abs(got - j_ref) <= 1e-6 * scale)
    assert np.all(np.abs(got - j_kern) <= 1e-5 * np.abs(j_kern) + 2e-6 * scale)
    assert got[0] == 0.0 and j_kern[0] == 0.0  # teacher == student
    assert np.all(got >= -2e-6 * scale) and np.isfinite(got).all()


@pytest.mark.parametrize("temp", TEMPS)
def test_distill_kl_wrapper_is_the_mean_times_t2(temp):
    t, s = _logits(7, rows=8)
    want = np.asarray(jref.distill_kl_ref(jnp.asarray(t), jnp.asarray(s), temp)).mean() * temp**2
    ops.reset_launches()
    tt, ts = torch.as_tensor(t), torch.as_tensor(s)
    for got in (ops.distill_kl(tt, ts, temp),
                ops.distill_kl(tt.reshape(2, 4, -1), ts.reshape(2, 4, -1), temp)):
        assert got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("use_h", [False, True])
def test_distill_loss_with_kernel_matches_reference(use_h):
    """``logits_distill_loss`` / ``total_distill_loss(use_kernel=True)``
    against the JAX calls (its Pallas kernel in interpret mode), and the
    port's kernel route against its own plain route."""
    rng = np.random.default_rng(11)
    g, c = (rng.normal(size=(16, 256)).astype(np.float32) * 2 for _ in range(2))
    gh, ch = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    jh = (jnp.asarray(gh), jnp.asarray(ch)) if use_h else (None, None)
    th = (torch.as_tensor(gh), torch.as_tensor(ch)) if use_h else (None, None)
    j_loss, j_parts = jdistill.total_distill_loss(jnp.asarray(g), jnp.asarray(c), *jh,
                                                  temperature=2.0, lam=0.03, use_kernel=True)
    t_loss, t_parts = tdistill.total_distill_loss(torch.as_tensor(g), torch.as_tensor(c), *th,
                                                  temperature=2.0, lam=0.03, use_kernel=True)
    plain, _ = tdistill.total_distill_loss(torch.as_tensor(g), torch.as_tensor(c), *th,
                                           temperature=2.0, lam=0.03)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(t_parts["lora"]), float(j_parts["lora"]), rtol=1e-5)
    np.testing.assert_allclose(float(t_loss), float(plain), rtol=1e-6)
    single = tdistill.logits_distill_loss(torch.as_tensor(g), torch.as_tensor(c), 2.0,
                                          use_kernel=True)
    j_single = jdistill.logits_distill_loss(jnp.asarray(g), jnp.asarray(c), 2.0, use_kernel=True)
    np.testing.assert_allclose(float(single), float(j_single), rtol=1e-5)
    # restrict_to_support keeps the masked jnp route, as the reference does
    g[:, ::2] = 0.0
    masked = tdistill.logits_distill_loss(torch.as_tensor(g), torch.as_tensor(c), 2.0,
                                          restrict_to_support=True, use_kernel=True)
    j_masked = jdistill.logits_distill_loss(jnp.asarray(g), jnp.asarray(c), 2.0,
                                            restrict_to_support=True, use_kernel=True)
    np.testing.assert_allclose(float(masked), float(j_masked), rtol=1e-5)


def test_forward_only_kernels_refuse_inputs_that_require_grad():
    t, s = (torch.as_tensor(x) for x in _logits(3))
    student = s.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tdistill.logits_distill_loss(t, student, 2.0, use_kernel=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tdistill.total_distill_loss(t, student, use_kernel=True)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.distill_kl(t.clone().requires_grad_(True), s)
    # the plain route carries the gradient; under no_grad the kernel route runs
    loss = tdistill.logits_distill_loss(t, student, 2.0)
    loss.backward()
    assert student.grad is not None and bool(torch.isfinite(student.grad).all())
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tdistill.logits_distill_loss(t, student, 2.0, use_kernel=True)),
            float(loss), rtol=1e-6)
    q = torch.randn(2, 128, 32)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q.clone().requires_grad_(True), q, q)


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.normal(size=shape)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("shape", [(2, 128, 64), (1, 256, 32), (3, 64, 64), (1, 128, 128), (2, 256, 128)])
def test_flash_attention_matches_reference(shape):
    q, k, v = _qkv(sum(shape), shape)
    j_kern = np.asarray(flash_attention_pallas(*map(jnp.asarray, (q, k, v)), interpret=True))
    j_ref = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v))))
    ops.reset_launches()
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    tol = 1e-5 * np.abs(v).max()
    for got in (ref.flash_attention_ref(tq, tk, tv), ops.flash_attention(tq, tk, tv)):
        for want in (j_kern, j_ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert sum(ops.LAUNCHES.values()) == 0


def test_flash_attention_folds_heads():
    """A ``(B, H, S, D)`` input is the ``(B·H, S, D)`` one, head by head."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(5, (2, 3, 128, 32)))
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(*(x.reshape(6, 128, 32) for x in (q, k, v)))
    assert got.shape == q.shape and torch.equal(got.reshape(6, 128, 32), want)


def test_flash_attention_is_causal():
    """Changing k and v from position 200 on leaves outputs 0..199 unchanged,
    bit for bit."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(0, (1, 256, 64)))
    base = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 99.0
    v2[:, 200:] = -99.0
    pert = ops.flash_attention(q, k2, v2)
    assert torch.equal(base[:, :200], pert[:, :200])
    assert not torch.equal(base[:, 200:], pert[:, 200:])


def test_flash_attention_head_dims_on_the_card():
    """The CUDA route takes every head dim: 64 and 128 reach kernels of
    their own (launch counters ``flash_attention`` and ``.d128`` after the
    dtype's tag), every other D >= 1 (96, 32, 256, which the CUDA route
    refused before it had a kernel for them) the any-D kernel (``.dany``),
    each counter in ``LAUNCHES`` for every dtype; the CPU route takes any D
    (tests/test_torch_attention_head_dims.py holds it to the reference at
    many)."""
    for d, instance in ((64, ""), (128, ".d128"), (96, ".dany"), (32, ".dany"), (256, ".dany")):
        assert ops.flash_instance(d) == instance
        for tag in ("", ".bf16", ".f16"):
            assert "flash_attention" + tag + instance in ops.LAUNCHES
    q = torch.randn(2, 128, 96)
    assert ops.flash_attention(q, q, q).shape == q.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_aligned16_copies_a_misaligned_view(dtype):
    """The wrapper's choice before a CUDA launch: a contiguous view one
    element into a buffer (2 bytes for bf16 and fp16, 4 for fp32; the
    ``buf[1:].view(B*H, S, D)`` the reference takes) comes back as an aligned
    copy of equal values; an aligned tensor comes back as it is."""
    n = 2 * 128 * 64
    buf = torch.as_tensor(np.random.default_rng(3).normal(size=n + 8).astype(np.float32)).to(dtype)
    view = buf[1:1 + n].view(2, 128, 64)
    assert view.is_contiguous() and view.data_ptr() % 16 == torch.finfo(dtype).bits // 8
    got = ops.aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert got.is_contiguous() and got.dtype == dtype and torch.equal(got, view)
    aligned = buf[:n].view(2, 128, 64)
    assert aligned.data_ptr() % 16 == 0 and ops.aligned16(aligned) is aligned


def test_flash_attention_rejects_bad_inputs():
    q = torch.randn(2, 192, 32)
    with pytest.raises(ValueError, match="tile"):
        ops.flash_attention(q, q, q)  # 192 is not a multiple of 128
    q = torch.randn(2, 128, 32)
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, q[:1].contiguous(), q)
    # fp16 runs (the plain versions on the CPU); float64 has no kernel
    for low in (torch.float16,):
        assert ops.flash_attention(q.to(low), q.to(low), q.to(low)).dtype == low
        assert float(ops.distill_kl(q.to(low), q.to(low))) == 0.0
    for bad_dtype in (torch.float64,):
        with pytest.raises(TypeError, match="dtype"):
            ops.flash_attention(q.to(bad_dtype), q.to(bad_dtype), q.to(bad_dtype))
        with pytest.raises(TypeError, match="dtype"):
            ops.distill_kl(q.to(bad_dtype), q.to(bad_dtype))
    with pytest.raises(TypeError, match="mix"):  # one dtype for the float inputs of a call
        ops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
