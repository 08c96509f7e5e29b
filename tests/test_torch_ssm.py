"""The port's Mamba2 / SSD mixer (``repro_torch/models/ssm.py``) against the
JAX reference, on the CPU.

* ``segsum`` and the chunked SSD scan on the reference's own grid (chunk
  1, 2, 4, 8 by sequence 8, 16, with and without an initial state), held
  to the reference's ``_ssd_chunked`` and to a naive one-step-at-a-time
  recurrence, at the reference's rtol 1e-4 / atol 1e-5; its long-chunk
  strong-decay case stays finite.
* ``ssm_apply`` over a full sequence and over 8 one-token decode steps
  (the reference's weights carried across by ``bridge.to_torch``), at
  rtol 1e-4 / atol 1e-5.  ``F.softplus`` is linear above 20 where
  ``jax.nn.softplus`` is ``logaddexp(x, 0)``: the two differ by less than
  3e-9 there, far inside the bound.
* The backward through ``exp`` of the ``-inf``-masked ``segsum`` gives
  finite gradients (pretraining is full-parameter AdamW through the SSD).
* The port's init has the reference's keys and shapes for the SSM and the
  hybrid smoke configs (drawn), and for their full configs (the reference
  through ``jax.eval_shape``, the port's draws replaced by ``meta``
  tensors, so neither allocates).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.models.ssm import _segsum as j_segsum  # noqa: E402
from repro.models.ssm import _ssd_chunked as j_ssd  # noqa: E402
from repro.models.ssm import init_ssm_cache as j_init_ssm_cache  # noqa: E402
from repro.models.ssm import ssm_apply as j_ssm_apply  # noqa: E402
from repro.models.ssm import ssm_init as j_ssm_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def naive_ssd(x, a, b_mat, c_mat, init_state=None):
    """The recurrence one step at a time: ``state_t = exp(a_t) · state_{t-1}
    + x_t ⊗ B_t``, ``y_t = state_t · C_t``."""
    bsz, s, h, p = x.shape
    state = x.new_zeros((bsz, h, p, b_mat.shape[-1])) if init_state is None else init_state
    ys = []
    for t in range(s):
        state = state * torch.exp(a[:, t])[..., None, None] + x[:, t, :, :, None] * b_mat[
            :, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t]))
    return torch.stack(ys, dim=1), state


def _ssd_inputs(seed, bsz, seq, h, p, n, decay=0.5):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (f(bsz, seq, h, p), (-np.abs(f(bsz, seq, h)) * decay).astype(np.float32),
            f(bsz, seq, n), f(bsz, seq, n), f(bsz, h, p, n))


def test_segsum_matches_reference():
    a = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    got, want = t_ssm.segsum(_t(a)), j_segsum(jnp.asarray(a))
    assert torch.equal(torch.isneginf(got), torch.as_tensor(np.isneginf(np.asarray(want))))
    fin = ~np.isneginf(np.asarray(want))
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(want)[fin], rtol=0, atol=1e-6)
    s = t_ssm.segsum(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert float(s[2, 0]) == 5.0 and float(s[3, 1]) == 7.0 and float(s[1, 1]) == 0.0
    assert bool(torch.isneginf(s[0, 1:]).all())


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "init-state"])
@pytest.mark.parametrize("seq", [8, 16])
@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_ssd_chunked_matches_reference_and_recurrence(chunk, seq, init):
    x, a, b, c, s0 = _ssd_inputs(chunk * seq + init, 2, seq, 3, 4, 5)
    s0 = s0 if init else None
    got_y, got_s = t_ssm.ssd_chunked(_t(x), _t(a), _t(b), _t(c), chunk,
                                     None if s0 is None else _t(s0))
    want_y, want_s = j_ssd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), chunk,
                           None if s0 is None else jnp.asarray(s0))
    _close(got_y, want_y)
    _close(got_s, want_s)
    rec_y, rec_s = naive_ssd(_t(x), _t(a), _t(b), _t(c), None if s0 is None else _t(s0))
    _close(got_y, rec_y)
    _close(got_s, rec_s)


def test_ssd_long_chunk_strong_decay_stays_finite():
    """The reference's case: a decay of -5 a step over 64-step chunks of 16
    underflows to exact zeros, never inf or NaN."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 64, 2, 4)).astype(np.float32)
    a = np.full((1, 64, 2), -5.0, np.float32)
    b, c = (rng.normal(size=(1, 64, 8)).astype(np.float32) for _ in range(2))
    y, s = t_ssm.ssd_chunked(_t(x), _t(a), _t(b), _t(c), 16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    want_y, want_s = j_ssd(*(jnp.asarray(v) for v in (x, a, b, c)), 16)
    _close(y, want_y)
    _close(s, want_s)


# -- the block --------------------------------------------------------------------------------

_BLOCK = dict(d_model=32, ssm=dict(state_dim=8, head_dim=8, expand=2, chunk_size=4))


def _block_cfgs(**over):
    from repro.configs.base import SSMConfig as JSSM

    spec = dict(_BLOCK, **over)
    ssm = spec.pop("ssm")
    return (j_smoke("mamba2-130m").with_overrides(ssm=JSSM(**ssm), **spec),
            get_smoke_config("mamba2-130m").with_overrides(ssm=TSSM(**ssm), **spec))


@pytest.fixture(scope="module")
def block():
    jc, tc = _block_cfgs(use_bias=True)
    params = j_ssm_init(jax.random.PRNGKey(3), jc)
    # live biases and a spread of dt, so every term is exercised
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda v: v + jnp.asarray(0.05 * rng.normal(size=v.shape), v.dtype),
                          params)
    lp = {f"ssm/{k}": v for k, v in bridge.to_torch(jax.tree.map(np.asarray, params),
                                                    "cpu").items()}
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    return jc, tc, params, lp, x


def test_ssm_apply_full_sequence_matches_reference(block):
    jc, tc, params, lp, x = block
    want, _ = j_ssm_apply(params, jnp.asarray(x), jc)
    got = t_ssm.ssm_apply(lp, _t(x)[None], tc)
    _close(got[0], want)
    # two clients with their own weights: each is its own single-client call
    lp2 = {k: torch.stack([v, v * 0.5]) for k, v in lp.items()}
    both = t_ssm.ssm_apply(lp2, _t(np.stack([x, x])), tc)
    _close(both[0], got[0], rtol=0, atol=1e-6)
    half = t_ssm.ssm_apply({k: v * 0.5 for k, v in lp.items()}, _t(x)[None], tc)
    _close(both[1], half[0], rtol=0, atol=1e-6)


def test_ssm_apply_decode_matches_reference(block):
    jc, tc, params, lp, x = block
    j_cache = j_init_ssm_cache(jc, 2)
    t_cache = t_ssm.init_ssm_cache(tc, 2, "cpu")
    full = t_ssm.ssm_apply(lp, _t(x)[None], tc)
    j_step = jax.jit(lambda p, c, xt: j_ssm_apply(p, xt, jc, cache=c))
    for t in range(8):
        want, j_cache = j_step(params, j_cache, jnp.asarray(x[:, t:t + 1]))
        got = t_ssm.ssm_apply(lp, _t(x[:, t:t + 1])[None], tc, cache=t_cache)
        _close(got[0], want)
        _close(t_cache.state, j_cache.state)
        _close(t_cache.conv_x, j_cache.conv_x)
        _close(t_cache.conv_bc, j_cache.conv_bc)
        _close(got[0, :, 0], full[0, :, t], rtol=0, atol=1e-4)  # the dual forms agree
    assert t_cache.state.dtype == torch.float32


def test_the_ssd_backward_is_finite(block):
    """Gradients through ``exp(segsum)`` (``-inf`` above the diagonal) of
    every leaf are finite, under strong decay too."""
    _, tc, _, lp, x = block
    for shift in (0.0, 3.0):  # a_log + 3: A up to 16·e³, every step's decay near zero
        leaves = {k: (v + shift if k == "ssm/a_log" else v).clone().requires_grad_(True)
                  for k, v in lp.items()}
        out = t_ssm.ssm_apply(leaves, _t(x)[None], tc)
        grads = torch.autograd.grad(out.square().sum(), list(leaves.values()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        assert any(float(g.abs().max()) > 0 for g in grads)


# -- the init ---------------------------------------------------------------------------------

_ARCHS = ["mamba2-130m", "jamba-1.5-large-398b"]


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in bridge.flatten(tree).items()}


@pytest.mark.parametrize("arch", _ARCHS)
def test_init_has_the_references_layout_smoke(arch):
    jc = j_smoke(arch).with_overrides(lora=JLoRA(**_LORA))
    tc = get_smoke_config(arch).with_overrides(lora=TLoRA(**_LORA))
    want = _shapes(jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jc)))
    got = t_model.init(tc, 0, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    # the adapters alone are the same leaves, drawn the same
    only = t_model.init(tc, 0, "cpu", adapters_only=True)
    assert set(only) == {k for k in want if "lora" in k}
    assert all(torch.equal(only[k], got[k]) for k in only)
    # the SSM draws: dt in [dt_min, dt_max] after the softplus, A in [1, 16]
    ssm = tc.ssm
    dt = torch.nn.functional.softplus(got["stack/pos0/ssm/dt_bias"])
    assert float(dt.min()) >= ssm.dt_min * 0.999 and float(dt.max()) <= ssm.dt_max * 1.001
    a = torch.exp(got["stack/pos0/ssm/a_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert abs(float(got["stack/pos0/ssm/conv_x_w"].std()) - 0.1) < 0.02


@pytest.mark.parametrize("lora", [False, True], ids=["no-lora", "lora"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_init_has_the_references_layout_full(arch, lora):
    jc, tc = j_config(arch), get_config(arch)
    if lora:
        jc, tc = jc.with_overrides(lora=JLoRA(**_LORA)), tc.with_overrides(lora=TLoRA(**_LORA))
    want = _shapes(jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jc)))
    got = t_model.param_shapes(tc)
    assert {k: tuple(v.shape) for k, v in got.items()} == want
