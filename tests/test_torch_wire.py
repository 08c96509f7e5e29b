"""The port's uplink (the sparse wire and the dense top-k stack), its
aggregation and the host-side budget and byte accounting against the JAX
reference, on the CPU.

Integer results must be identical: wire indices and masks, int8 values,
top-k supports, adaptive k and ledger bytes; a top-k keeps the input's
values, so those are identical too.  Aggregated and int8-coded floats:
rtol 1e-6 (plus 1e-6 of the largest magnitude for the dense aggregation,
whose client sums may run in another order and cancel).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as j_agg  # noqa: E402
from repro.core import channel as j_chan  # noqa: E402
from repro.core import distill as j_distill  # noqa: E402
from repro.core import protocol as j_proto  # noqa: E402
from repro.core import topk as j_topk  # noqa: E402
from repro.configs.gpt2_paper import GPT2_SMALL as J_GPT2_SMALL  # noqa: E402
from repro.fed.client import make_upload_payload as j_payload  # noqa: E402
from repro.fed.engines.base import cohort_budgets as j_budgets  # noqa: E402
from repro.fed.engines.base import fake_quant_dense as j_fake_quant  # noqa: E402
from repro.fed.engines.base import k_cap_bucket as j_k_cap  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_SMALL as T_GPT2_SMALL  # noqa: E402
from repro_torch.core import aggregation as t_agg  # noqa: E402
from repro_torch.core import channel as t_chan  # noqa: E402
from repro_torch.core import distill as t_distill  # noqa: E402
from repro_torch.core import protocol as t_proto  # noqa: E402
from repro_torch.core import topk as t_topk  # noqa: E402
from repro_torch.fed.client import make_upload_payload as t_payload  # noqa: E402
from repro_torch.fed.engines.base import cohort_budgets as t_budgets  # noqa: E402
from repro_torch.fed.engines.base import fake_quant_dense as t_fake_quant  # noqa: E402
from repro_torch.fed.engines.base import k_cap_bucket as t_k_cap  # noqa: E402

MODES = ("adaptive", "zeropad", "mean_nonzero")


def _logits(seed, ties: bool, shape=(3, 4, 64)):
    rng = np.random.default_rng(seed)
    if ties:  # a handful of distinct values: every top-k cut falls inside a tie
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("k_cap", [16, 64])
@pytest.mark.parametrize("quantize", [False, True])
def test_sparsify_wire_identical(ties, k_cap, quantize):
    x = _logits(0, ties)
    ks = np.array([0, 5, 16], np.int32)
    jw = j_topk.sparsify_wire(jnp.asarray(x), jnp.asarray(ks), k_cap, quantize=quantize)
    tw = t_topk.sparsify_wire(torch.as_tensor(x), [int(k) for k in ks], k_cap, quantize=quantize)
    assert type(tw).__name__ == type(jw).__name__ and tw.vocab == jw.vocab
    np.testing.assert_array_equal(tw.indices.numpy(), np.asarray(jw.indices))
    np.testing.assert_array_equal(tw.mask.numpy(), np.asarray(jw.mask))
    np.testing.assert_array_equal(tw.values.numpy(), np.asarray(jw.values))
    assert tw.values.dtype == (torch.int8 if quantize else torch.float32)
    if quantize:
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))


def test_quantize_wire_rounds_half_to_even():
    # 0.5 and 2.5 quantization steps must round to 0 and 2, as jnp.round does
    vals = np.array([[[127.0, 0.5, 2.5, -1.5]]], np.float32)
    mask = np.ones_like(vals, bool)
    idx = np.arange(4, dtype=np.int32)[None, None]
    jq = j_topk.quantize_wire(j_topk.SparseWire(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(mask), 8))
    tq = t_topk.quantize_wire(t_topk.SparseWire(torch.as_tensor(vals), torch.as_tensor(idx),
                                                torch.as_tensor(mask), 8))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert tq.values.numpy().ravel().tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_aggregate_wire_matches_reference(quantize, mode):
    x = _logits(1, ties=False)
    ks = np.array([7, 0, 12], np.int32)
    jw = j_topk.sparsify_wire(jnp.asarray(x), jnp.asarray(ks), 16, quantize=quantize)
    tw = t_topk.sparsify_wire(torch.as_tensor(x), [int(k) for k in ks], 16, quantize=quantize)
    j_out = np.asarray(j_agg.aggregate_wire(jw, mode))
    for use_kernel in (False, True):
        for n_tx in (None, 2):
            t_out = t_agg.aggregate_wire(tw, mode, num_transmitters=n_tx, use_kernel=use_kernel)
            np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ties", [True, False])
def test_topk_mask_batch_and_densify_identical(ties):
    x = _logits(2, ties)
    ks = [0, 5, 64]
    j_out = np.asarray(j_topk.topk_mask_batch(jnp.asarray(x), ks))
    t_out = t_topk.topk_mask_batch(torch.as_tensor(x), ks)
    np.testing.assert_array_equal(t_out.numpy() != 0, j_out != 0)
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    for i, k in enumerate(ks):  # one client at a time through topk_sparsify + densify
        if k == 0:  # the reference's densify cannot fold an empty payload
            continue
        j_sp = j_topk.topk_sparsify(jnp.asarray(x[i]), k)
        t_sp = t_topk.topk_sparsify(torch.as_tensor(x[i]), k)
        np.testing.assert_array_equal(t_sp.indices.numpy(), np.asarray(j_sp.indices))
        np.testing.assert_array_equal(t_topk.densify(t_sp).numpy(), np.asarray(j_topk.densify(j_sp)))
        np.testing.assert_array_equal(t_topk.topk_mask_dense(torch.as_tensor(x[i]), k).numpy(),
                                      j_out[i])
    with pytest.raises(ValueError, match="budgets"):
        t_topk.topk_mask_batch(torch.as_tensor(x), [1, 2])


def test_fake_quant_dense_matches_reference():
    x = np.array(j_topk.topk_mask_batch(jnp.asarray(_logits(3, ties=False)), [0, 7, 30]))
    x[1, 0, :4] = [0.5, 2.5, -1.5, 127.0]  # half-way steps round to even
    j_out = np.asarray(j_fake_quant(jnp.asarray(x)))
    t_out = t_fake_quant(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t_out != 0, j_out != 0)
    assert (t_out[0] == 0).all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_dense_aggregate_matches_reference(mode, with_mask, use_kernel):
    x = _logits(4, ties=False)
    stack = np.array(j_topk.topk_mask_batch(jnp.asarray(x), [9, 1, 64]))
    stack[0, 0, 3] = 0.0  # a transmitted true zero the mask sees and the sentinel does not
    mask = (stack != 0) | (np.arange(64) == 3)[None, None, :] & (np.arange(3) == 0)[:, None, None]
    j_mask = jnp.asarray(mask) if with_mask else None
    t_mask = torch.as_tensor(mask) if with_mask else None
    j_out = np.asarray(j_agg.aggregate(jnp.asarray(stack), mode, mask=j_mask, use_kernel=use_kernel))
    t_out = t_agg.aggregate(torch.as_tensor(stack), mode, mask=t_mask, use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=1e-6 * np.abs(j_out).max())
    with pytest.raises(ValueError, match="unknown aggregation mode"):
        t_agg.aggregate(torch.as_tensor(stack), "median")


@pytest.mark.parametrize("restrict_to_support", [False, True])
@pytest.mark.parametrize("with_h", [False, True])
def test_total_distill_loss_matches_reference(restrict_to_support, with_h):
    """Eq. 10 on a top-k-sparse teacher (so the support restriction bites):
    the loss and both parts at rtol 1e-5."""
    rng = np.random.default_rng(6)
    teacher = np.array(j_topk.topk_mask_batch(jnp.asarray(_logits(5, ties=False)), [9, 30, 64]))
    student = rng.normal(size=teacher.shape).astype(np.float32)
    g_h, c_h = (rng.normal(size=(3, 4, 8)).astype(np.float32) for _ in range(2))
    kw = dict(temperature=2.0, lam=0.03, restrict_to_support=restrict_to_support)
    j_loss, j_parts = j_distill.total_distill_loss(
        jnp.asarray(teacher), jnp.asarray(student),
        jnp.asarray(g_h) if with_h else None, jnp.asarray(c_h) if with_h else None, **kw)
    t_loss, t_parts = t_distill.total_distill_loss(
        torch.as_tensor(teacher), torch.as_tensor(student),
        torch.as_tensor(g_h) if with_h else None, torch.as_tensor(c_h) if with_h else None, **kw)
    for t, j in ((t_loss, j_loss), (t_parts["logits"], j_parts["logits"]),
                 (t_parts["lora"], j_parts["lora"])):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5, atol=1e-7)
    # use_kernel=True: the fused KL kernel's route (its plain version on the CPU)
    # against the reference's (its Pallas kernel in interpret mode)
    j_kern = j_distill.logits_distill_loss(jnp.asarray(teacher), jnp.asarray(student), 2.0,
                                           use_kernel=True)
    t_kern = t_distill.logits_distill_loss(torch.as_tensor(teacher), torch.as_tensor(student),
                                           2.0, use_kernel=True)
    np.testing.assert_allclose(float(t_kern), float(j_kern), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 42, 7])
@pytest.mark.parametrize("quantize", [False, True])
def test_budgets_and_ledger_bytes_identical(seed, quantize):
    """Channel realisations, adaptive k, k_cap, payload and broadcast bytes
    and the ledger over a few rounds: identical integers (and floats)."""
    kw = dict(bandwidth_hz=2e5, mean_snr_db=2.0, min_k=0, dropout_prob=0.3)
    j_sim = j_chan.ChannelSimulator(12, j_chan.ChannelConfig(**kw), seed=seed)
    t_sim = t_chan.ChannelSimulator(12, t_chan.ChannelConfig(**kw), seed=seed)
    j_led, t_led = j_proto.CommLedger(), t_proto.CommLedger()
    rng = np.random.default_rng(seed)
    for rnd in range(4):
        sel = [int(i) for i in rng.choice(12, size=5, replace=False)]
        j_states, t_states = j_sim.states_batched(rnd, sel), t_sim.states_batched(rnd, sel)
        np.testing.assert_array_equal(t_states.snr_db, j_states.snr_db)
        for send_h in (False, True):
            args = (64, True, len(sel), send_h)
            opts = dict(value_bits=16, k_min=0, quantize_wire=quantize)
            j_ks = j_budgets(j_states, J_GPT2_SMALL, *args, **opts)
            t_ks = t_budgets(t_states, T_GPT2_SMALL, *args, **opts)
            assert t_ks == j_ks
            assert t_k_cap(t_ks, 50257) == j_k_cap(j_ks, 50257)
        j_bytes = [j_payload(J_GPT2_SMALL, c, 64, k, send_h=True, value_bits=16, snr_db=0.0,
                             quantize=quantize)[0].bytes for c, k in zip(sel, j_ks) if k > 0]
        t_bytes = [t_payload(T_GPT2_SMALL, c, 64, k, send_h=True, value_bits=16, snr_db=0.0,
                             quantize=quantize)[0].bytes for c, k in zip(sel, t_ks) if k > 0]
        assert t_bytes == j_bytes
        down = j_proto.downlink_bits(64, 50257, 8)
        assert t_proto.downlink_bits(64, 50257, 8) == down
        j_led.record(j_proto.RoundStats(rnd, uplink_bytes=sum(j_bytes), downlink_bytes=down / 8))
        t_led.record(t_proto.RoundStats(rnd, uplink_bytes=sum(t_bytes), downlink_bytes=down / 8))
    assert (t_led.total_mb, t_led.uplink_mb) == (j_led.total_mb, j_led.uplink_mb)


# -- the sparse path's memory contract (max_intermediate_elems) ---------------------------------

# the reference's shapes (tests/test_engine.py): N clients, rows, vocab, k_cap
N_MC, ROWS_MC, V_MC, K_MC = 10, 64, 8192, 256


def _contract_wire(quantize: bool, device: str = "cpu"):
    """A random wire at the contract's shapes, both packages' forms:
    ``(port wire, reference aggregation's positional arguments)``."""
    rng = np.random.default_rng(7)
    shape = (N_MC, ROWS_MC, K_MC)
    idx = rng.integers(0, V_MC, size=shape).astype(np.int32)
    mask = rng.random(shape) < 0.9
    if quantize:
        q = rng.integers(-127, 128, size=shape).astype(np.int8)
        scale = rng.random((N_MC, ROWS_MC)).astype(np.float32)
        wire = t_topk.QuantizedWire(values=torch.as_tensor(q, device=device),
                                    scale=torch.as_tensor(scale, device=device),
                                    indices=torch.as_tensor(idx, device=device),
                                    mask=torch.as_tensor(mask, device=device), vocab=V_MC)
        return wire, (jnp.asarray(q), jnp.asarray(scale), jnp.asarray(idx), jnp.asarray(mask))
    v = rng.normal(size=shape).astype(np.float32)
    wire = t_topk.SparseWire(values=torch.as_tensor(v, device=device),
                             indices=torch.as_tensor(idx, device=device),
                             mask=torch.as_tensor(mask, device=device), vocab=V_MC)
    return wire, (jnp.asarray(v), jnp.asarray(idx), jnp.asarray(mask))


def _j_contract_count(quantize: bool, use_kernel: bool, args) -> int:
    """The reference's count, as its tests take it: the jaxpr of
    ``aggregate_wire`` on the wire's arrays."""
    import jax

    def agg(*arrays):
        if quantize:
            q, scale, idx, mask = arrays
            wire = j_topk.QuantizedWire(values=q, scale=scale, indices=idx, mask=mask, vocab=V_MC)
        else:
            v, idx, mask = arrays
            wire = j_topk.SparseWire(values=v, indices=idx, mask=mask, vocab=V_MC)
        return j_agg.aggregate_wire(wire, "adaptive", num_transmitters=N_MC,
                                    use_kernel=use_kernel)

    return j_agg.max_intermediate_elems(jax.make_jaxpr(agg)(*args))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_wire_aggregation_never_densifies_the_stack(quantize, use_kernel):
    """The twins of the reference's ``test_e2e_aggregation_path_never_
    densifies_stack`` and ``test_e2e_dequant_fused_aggregation_never_
    densifies_stack``: aggregating a float or int8 wire of 10 clients never
    holds anything larger than the ``(rows, V)`` sums, far below the
    ``(N, rows, V)`` dense stack, and the port's worst count is the
    reference's jaxpr count.  On the CPU the kernel route is the kernels'
    plain versions; ``chip_smoke.py`` holds the kernels themselves to it."""
    wire, j_args = _contract_wire(quantize)
    worst = t_agg.max_intermediate_elems(
        t_agg.aggregate_wire, wire, "adaptive", num_transmitters=N_MC, use_kernel=use_kernel)
    assert worst <= ROWS_MC * V_MC < N_MC * ROWS_MC * V_MC
    assert worst == _j_contract_count(quantize, use_kernel, j_args)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_max_intermediate_elems_runs_on_meta_tensors(quantize):
    """The same count on ``meta`` tensors, where nothing is allocated."""
    wire, _ = _contract_wire(quantize)
    meta, _ = _contract_wire(quantize, device="meta")
    count = functools.partial(t_agg.max_intermediate_elems, t_agg.aggregate_wire,
                              mode="adaptive", num_transmitters=N_MC)
    assert count(meta) == count(wire) == ROWS_MC * V_MC


def test_max_intermediate_elems_counts_a_broadcast_stack():
    """A function that broadcasts one client's ``(rows, V)`` logits to the
    ``(N, rows, V)`` stack reports the stack's size, though the broadcast is
    a view; the dense aggregation of a stack reports the stack it builds."""
    x = torch.ones(ROWS_MC, V_MC)
    assert t_agg.max_intermediate_elems(
        lambda t: t[None].expand(N_MC, ROWS_MC, V_MC).sum(0), x) == N_MC * ROWS_MC * V_MC
    assert t_agg.max_intermediate_elems(lambda t: t * 2, x) == ROWS_MC * V_MC
    stack = torch.ones(3, 4, 16)
    assert t_agg.max_intermediate_elems(t_agg.aggregate, stack) == 3 * 4 * 16
