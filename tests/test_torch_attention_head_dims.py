"""Causal attention (kernel 7) at head dims other than 64 and 128, against
the JAX reference, on the CPU.

The reference's Pallas kernel (``flash_attention_pallas``) spans the full
head dim D in its blocks, so it takes any D; so does the port, whose CUDA
route sends D 64 and 128 to kernels of their own and every other D to
``flash_attention_anyd_kernel`` (``ops.flash_instance`` names the launch
counter).  Here the tensors lie on the CPU, so ``ops.flash_attention`` runs
the plain version; ``chip_smoke.py`` holds the kernel to it on the card, and
``test_torch_anyd_designs.py`` models the kernel's arithmetic and layout.

Inputs are made with numpy from a seed: the Pallas kernel in interpret mode
and the reference's plain version against the port's plain version and
wrapper, at D in {1, 16, 33, 80, 96, 200, 256, 320} (one past the kernel's
widest padded width, 256) and S in {64, 96, 128, 256} (96 and 64: under
one 128-row tile, which the tiling takes), in fp32 at every pair and in bf16
and fp16 at every pair too, the two 16-bit types taking the pairs in turn.
Tolerances: an output is a convex combination of at most S rows of v,
summed in fp32 in another order: within ``1e-5 · max|v|``; a 16-bit output
is that fp32 result rounded once, in both packages, so within that plus
one ulp of its dtype.  D 0 raises the reference's ``ZeroDivisionError``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

HEAD_DIMS = (1, 16, 33, 80, 96, 200, 256, 320)
SEQS = (64, 96, 128, 256)
PAIRS = list(itertools.product(HEAD_DIMS, SEQS))
# each (D, S) in bf16 or fp16, the two in turn
LOW_CASES = [(d, s, ("bfloat16", "float16")[i % 2]) for i, (d, s) in enumerate(PAIRS)]
# significant bits of each 16-bit type (its ulp at magnitude a: 2^(floor(log2 a) - bits + 1))
BITS = {"bfloat16": 8, "float16": 11}


def _qkv(d: int, s: int, batch: int = 2):
    rng = np.random.default_rng(1000 * d + s)
    return tuple(rng.normal(size=(batch, s, d)).astype(np.float32) for _ in range(3))


def _ulp(x: np.ndarray, bits: int) -> np.ndarray:
    a = np.abs(x).astype(np.float64)
    return np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 2.0**-24))) - (bits - 1)), 0.0)


def _against_reference(q, k, v, dtype: str, tol: float, bits: int | None) -> None:
    """The Pallas kernel (interpret mode) and the reference's plain version
    against the port's plain version and wrapper, elementwise within ``tol``
    (plus one ulp of the larger magnitude in a 16-bit dtype), with no kernel
    launched on the CPU."""
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    wants = [np.asarray(flash_attention_pallas(jq, jk, jv, interpret=True).astype(jnp.float32)),
             np.asarray(jref.flash_attention_ref(jq, jk, jv).astype(jnp.float32))]
    tq, tk, tv = (torch.as_tensor(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
                  for x in (jq, jk, jv))
    ops.reset_launches()
    gots = [ref.flash_attention_ref(tq, tk, tv), ops.flash_attention(tq, tk, tv)]
    assert sum(ops.LAUNCHES.values()) == 0
    for got in gots:
        assert got.dtype == tq.dtype and got.shape == tq.shape
        g = got.float().numpy()
        for want in wants:
            lim = tol + (0.0 if bits is None else np.maximum(_ulp(g, bits), _ulp(want, bits)))
            assert bool((np.abs(g - want) <= lim).all()), float(np.abs(g - want).max())


@pytest.mark.parametrize("d,s", PAIRS)
def test_fp32_matches_reference(d, s):
    q, k, v = _qkv(d, s)
    _against_reference(q, k, v, "float32", 1e-5 * float(np.abs(v).max()), None)


@pytest.mark.parametrize("d,s,dtype", LOW_CASES)
def test_16bit_matches_reference(d, s, dtype):
    q, k, v = _qkv(d, s)
    vmax = float(np.abs(np.asarray(jnp.asarray(v).astype(dtype).astype(jnp.float32))).max())
    _against_reference(q, k, v, dtype, 1e-5 * vmax, BITS[dtype])


def test_heads_folded_at_an_odd_head_dim():
    """(B, H, S, D) through both packages' public wrappers is the fused
    (B·H, S, D) call head by head, at D 33 (the reference's ``ops`` folds in
    interpret mode on the CPU)."""
    q, k, v = (x.reshape(2, 1, 96, 33).repeat(2, axis=1) for x in _qkv(33, 96))
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v))))
    got = ops.flash_attention(*map(torch.as_tensor, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(v).max()))
    fused = ops.flash_attention(*(torch.as_tensor(x.reshape(4, 96, 33)) for x in (q, k, v)))
    assert torch.equal(got.reshape(4, 96, 33), fused)


@pytest.mark.parametrize("d", [80, 320])
def test_causal_at_other_head_dims(d):
    """k and v changed from position 70 on leave the outputs of rows 0..69
    unchanged, bit for bit."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(d, 128))
    base = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 70:], v2[:, 70:] = 99.0, -99.0
    pert = ops.flash_attention(q, k2, v2)
    assert torch.equal(base[:, :70], pert[:, :70]) and not torch.equal(base[:, 70:], pert[:, 70:])


@pytest.mark.parametrize("shape", [(2, 64, 0), (1, 2, 128, 0)])
def test_head_dim_zero_raises_as_the_reference(shape):
    """D 0: the reference's ``d**-0.5`` raises ``ZeroDivisionError`` in its
    Pallas kernel and its public wrapper; the port's plain version and
    wrapper raise the same."""
    x = np.zeros(shape, np.float32)
    fused = (int(np.prod(shape[:-2])),) + shape[-2:]
    with pytest.raises(ZeroDivisionError):
        jops.flash_attention(*(jnp.asarray(x),) * 3)
    with pytest.raises(ZeroDivisionError):
        flash_attention_pallas(*(jnp.asarray(x.reshape(fused)),) * 3, interpret=True)
    t = torch.as_tensor(x)
    with pytest.raises(ZeroDivisionError):
        ref.flash_attention_ref(*(t.reshape(fused),) * 3)
    with pytest.raises(ZeroDivisionError):
        ops.flash_attention(t, t, t)


# the head dims the CUDA route refused before it had a kernel for them
# (96, 32, 256), case for case, then D's of each kind beside 64 and 128
@pytest.mark.parametrize("d,instance", [(96, ".dany"), (32, ".dany"), (256, ".dany"), (64, ""),
                                        (128, ".d128"), (1, ".dany"), (33, ".dany"), (80, ".dany"),
                                        (200, ".dany"), (320, ".dany"), (4096, ".dany")])
def test_flash_instance_names_the_kernel(d, instance):
    """The launch counter a CUDA call at head dim ``d`` adds one to, after
    the dtype's tag: each is in ``LAUNCHES`` for fp32, bf16 and fp16."""
    assert ops.flash_instance(d) == instance
    for tag in ("", ".bf16", ".f16"):
        assert "flash_attention" + tag + instance in ops.LAUNCHES


@pytest.mark.parametrize("d", [0, -1])
def test_flash_instance_refuses_no_head_dim(d):
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_instance(d)
