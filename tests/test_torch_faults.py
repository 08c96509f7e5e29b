"""The port's fault injection against the JAX reference, on the CPU.

* ``FaultSimulator`` (``repro_torch.core.faults``): the resolutions of
  ``resolve_round``, the operands of ``scan_fault_inputs`` and the
  resolutions read from them, for all five presets: identical.
* The server's gate: ``validate_wire``, ``quarantine_wire`` and
  ``corrupt_wire`` on the float and the int8 wire, ``validate_dense``, and
  ``Server.aggregate_sparse_wire(validate=True)``: the reference's
  ``ok``/reasons and quarantined fields exactly; the aggregate equal to the
  port's aggregate of the wire without the corrupted row, and within 1e-6
  of the largest magnitude of the reference's (fp32 sums in another order).
* A faulted federation (``faults="lossy"`` on a Gilbert-Elliott channel,
  a seed at which clients crash, uploads are quarantined and one is
  delivered after a HARQ retry) on ``sequential``, ``batched``, ``fused``
  and ``fused_e2e`` round by round and on ``fused_e2e`` as a
  ``scan_rounds`` block: per-client k, attempted k, uplink and downlink
  bytes, transmitters, quarantines, crashes, retransmitted bytes and
  fault counts identical to the reference's; accuracies within one eval
  sample (the bridged JAX init on both sides, as
  ``tests/test_torch_round.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.faults as j_faults  # noqa: E402
import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core.topk import sparsify_wire as j_sparsify_wire  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed.server import Server as JServer  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.core.faults as t_faults  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.aggregation import aggregate_wire  # noqa: E402
from repro_torch.core.topk import sparsify_wire as t_sparsify_wire  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.server import Server as TServer  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
PRESETS = ("none", "corruption", "crashes", "bursty", "lossy")
EVAL_SIZE = 64


# -- the simulator -------------------------------------------------------------


@pytest.mark.parametrize("preset", PRESETS)
def test_fault_resolutions_match_reference(preset):
    """Every round's verdicts for a cohort (k = 0 stragglers, budgets that
    afford one to three copies), the block operands from round 0 and from
    round 2, and the verdicts read from those operands."""
    j_sim = j_faults.FaultSimulator(8, j_faults.FAULTS[preset], seed=3)
    t_sim = t_faults.FaultSimulator(8, t_faults.FAULTS[preset], seed=3)
    rng = np.random.default_rng(0)
    for rnd in range(6):
        sel = [int(c) for c in rng.choice(8, size=5, replace=False)]
        ks = [int(k) for k in rng.integers(0, 3, size=5) * 40]
        bits = [40.0 * k for k in ks]
        budgets = [float(b) * float(rng.uniform(1.0, 3.5)) for b in bits]
        j = j_sim.resolve_round(rnd, sel, ks, bits, budgets)
        t = t_sim.resolve_round(rnd, sel, ks, bits, budgets)
        assert (t.delivered, t.attempts, t.reasons) == (j.delivered, j.attempts, j.reasons)
    for start in (0, 2):
        j_in = j_faults.FaultSimulator(8, j_faults.FAULTS[preset], seed=3).scan_fault_inputs(
            4, start_round=start)
        t_in = t_faults.FaultSimulator(8, t_faults.FAULTS[preset], seed=3).scan_fault_inputs(
            4, start_round=start)
        assert set(t_in) == set(j_in)
        for key in j_in:
            assert np.asarray(t_in[key]).dtype == np.asarray(j_in[key]).dtype, key
            np.testing.assert_array_equal(t_in[key], j_in[key], err_msg=key)
        for r in range(4):
            args = ([0, 3, 5], [7, 0, 31], [70.0, 0.0, 310.0], [500.0, 500.0, 500.0])
            t_res = t_sim.resolve_from_inputs(t_in, r, *args)
            j_res = j_sim.resolve_from_inputs(j_in, r, *args)
            assert (t_res.delivered, t_res.attempts, t_res.reasons) == (
                j_res.delivered, j_res.attempts, j_res.reasons)


def test_presets_and_config_validation_match_reference():
    for name in PRESETS:
        assert dataclasses.asdict(t_faults.get_faults(name)) == dataclasses.asdict(
            j_faults.get_faults(name))
        assert t_faults.FAULTS[name].enabled == j_faults.FAULTS[name].enabled
    with pytest.raises(ValueError, match="unknown fault preset"):
        t_faults.get_faults("no_such_preset")
    for bad in (dict(corrupt_prob=1.5), dict(max_retries=-1), dict(burst_enter=-0.1)):
        with pytest.raises(ValueError):
            t_faults.FaultConfig(**bad)


# -- the server's gate ---------------------------------------------------------


def _wires(quantize: bool, n=3, samples=4, vocab=64, k_cap=8, ks=None):
    """The same wire in both packages, from one numpy draw."""
    logits = np.random.default_rng(0).normal(size=(n, samples, vocab)).astype(np.float32)
    ks = np.asarray(ks if ks is not None else [k_cap] * n, np.int32)
    j = j_sparsify_wire(jnp.asarray(logits), jnp.asarray(ks), k_cap, quantize=quantize)
    t = t_sparsify_wire(torch.as_tensor(logits), torch.as_tensor(ks), k_cap, quantize=quantize)
    return j, t


def _fields_equal(t_wire, j_wire):
    for name in j_wire._fields:
        if name == "vocab":
            assert t_wire.vocab == j_wire.vocab
            continue
        np.testing.assert_array_equal(getattr(t_wire, name).numpy(), np.asarray(getattr(j_wire, name)),
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["honest", "nan", "index", "negative_index", "over_budget"])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_wire_gate_matches_reference(quantize, mode):
    """``validate_wire``'s verdicts, the corrupted and the quarantined
    wires field by field; a k = 0 row is vacuously valid."""
    j, t = _wires(quantize, ks=[8, 0, 8])
    budget = None
    if mode == "over_budget":  # the last row claims one bit more than its budget
        d = t_faults.bits_per_entry(16, 64)
        budget = [8 * 4 * d, 0.0, 8 * 4 * d - 1.0]
    elif mode != "honest":
        j, t = j_faults.corrupt_wire(j, [2], mode=mode), t_faults.corrupt_wire(t, [2], mode=mode)
        _fields_equal(t, j)
    j_ok, j_reasons = j_faults.validate_wire(j, budget_bits=budget)
    t_ok, t_reasons = t_faults.validate_wire(t, budget_bits=budget)
    np.testing.assert_array_equal(t_ok, j_ok)
    assert t_reasons == j_reasons
    assert list(t_ok) == [True, True, mode == "honest"]
    _fields_equal(t_faults.quarantine_wire(t, t_ok), j_faults.quarantine_wire(j, j_ok))


def test_validate_dense_matches_reference():
    stack = np.zeros((3, 4, 8), np.float32)
    stack[1, 2, 3] = np.nan
    h = np.zeros((3, 4, 2), np.float32)
    h[2, 0, 0] = np.inf
    for args in ((stack,), (np.zeros_like(stack), h), (stack, h)):
        j_ok, j_reasons = j_faults.validate_dense(*args)
        t_ok, t_reasons = t_faults.validate_dense(*(torch.as_tensor(a) for a in args))
        np.testing.assert_array_equal(t_ok, j_ok)
        assert t_reasons == j_reasons


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_aggregate_sparse_wire_quarantines_the_corrupted_row(quantize):
    """``validate=True``: the aggregate is the aggregate of the wire without
    the corrupted row (bitwise), its h row leaves the mean, and it agrees
    with the reference's; without the gate the NaN reaches the aggregate."""
    vocab = T_SERVER.vocab_size
    j, t = _wires(quantize, n=3, samples=4, vocab=vocab, k_cap=8)
    j_bad, t_bad = j_faults.corrupt_wire(j, [1], mode="nan"), t_faults.corrupt_wire(t, [1], mode="nan")
    h = np.random.default_rng(1).normal(size=(3, 4, 4)).astype(np.float32)
    t_srv = TServer(T_SERVER, seed=0, distill_steps=1, device="cpu")
    j_srv = JServer(J_SERVER, seed=0, distill_steps=1)
    k_g, h_g = t_srv.aggregate_sparse_wire(t_bad, torch.as_tensor(h), validate=True)
    keep = torch.tensor([0, 2])
    fields = {f: getattr(t, f)[keep] for f in t._fields if f != "vocab"}
    assert torch.equal(k_g, aggregate_wire(type(t)(vocab=t.vocab, **fields), "adaptive"))
    assert torch.equal(h_g, torch.as_tensor(h)[keep].mean(dim=0))
    j_kg, j_hg = j_srv.aggregate_sparse_wire(j_bad, jnp.asarray(h), validate=True)
    j_kg = np.asarray(j_kg)
    np.testing.assert_allclose(k_g.numpy(), j_kg, rtol=0, atol=1e-6 * np.abs(j_kg).max())
    np.testing.assert_allclose(h_g.numpy(), np.asarray(j_hg), rtol=0, atol=1e-6)
    assert not torch.isfinite(t_srv.aggregate_sparse_wire(t_bad)[0]).all()


# -- a faulted federation ----------------------------------------------------------

CHAN = dict(bandwidth_hz=2e5, mean_snr_db=14.0)  # budgets that afford a HARQ retry
RUN_CASES = {f"{e}-loop": (e, False) for e in ("sequential", "batched", "fused", "fused_e2e")}
RUN_CASES["fused_e2e-block"] = ("fused_e2e", True)


def _fed(engine, scan, package):
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    return fed(method="adald", engine=engine, scan_rounds=scan, num_clients=6, clients_per_round=4,
               rounds=3, public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=1,
               distill_steps=1, server_distill_steps=1, seed=4, pretrain_steps=0,
               scenario="gilbert_elliott", faults="lossy", channel=chan(**CHAN))


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(scope="module")
def runs():
    """{case: (reference run, port run)}, and the port's resolutions."""
    out, resolutions = {}, []
    resolve = t_faults.FaultSimulator.resolve_round
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_model, "init", _bridged_init)
        mp.setattr(t_faults.FaultSimulator, "resolve_round",
                   lambda self, *a: resolutions.append(resolve(self, *a)) or resolutions[-1])
        for case, (engine, scan) in RUN_CASES.items():
            j_run = j_rounds.run_federated(
                J_CLIENT, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(engine, scan, "jax"))
            t_run = t_rounds.run_federated(
                T_CLIENT, T_SERVER, t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(engine, scan, "torch"), device="cpu")
            out[case] = (j_run, t_run)
    finally:
        mp.undo()
    return out, resolutions


def test_the_faulted_run_crashes_quarantines_and_retries(runs):
    """The fixture's seed exercises every fault path: a crash, a
    quarantine after the retries, and a delivery after a retry."""
    out, resolutions = runs
    verdicts = [(d, a, r) for res in resolutions
                for d, a, r in zip(res.delivered, res.attempts, res.reasons)]
    assert any(r == "crash" for _, _, r in verdicts)
    assert any(r == "corrupt" for _, _, r in verdicts)
    assert any(d and a > 1 for d, a, _ in verdicts)
    t_run = out["fused_e2e-loop"][1]
    assert sum(t_run.num_crashed) > 0 and sum(t_run.num_quarantined) > 0
    assert any(a > 0 and k == 0 for ks, aks in zip(t_run.per_client_k, t_run.attempted_k)
               for k, a in zip(ks, aks))


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_faulted_run_integers_match_reference(runs, case):
    j_run, t_run = runs[0][case]
    assert t_run.per_client_k == j_run.per_client_k
    assert t_run.attempted_k == j_run.attempted_k
    assert t_run.num_quarantined == j_run.num_quarantined
    assert t_run.num_crashed == j_run.num_crashed
    assert t_run.retrans_bytes == j_run.retrans_bytes
    assert len(t_run.ledger.rounds) == len(j_run.ledger.rounds) == 3
    for t, j in zip(t_run.ledger.rounds, j_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
        assert (t.num_quarantined, t.num_crashed, t.fault_counts, t.retrans_bytes) == (
            j.num_quarantined, j.num_crashed, j.fault_counts, j.retrans_bytes)
    assert t_run.summary().keys() == j_run.summary().keys()


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_faulted_run_accuracies_match_reference(runs, case):
    j_run, t_run = runs[0][case]
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.distill_loss, j_run.distill_loss, rtol=1e-4, equal_nan=True)


def test_faults_need_an_adaptive_k_method():
    fed = dataclasses.replace(_fed("batched", False, "torch"), method="all_logits")
    with pytest.raises(ValueError, match="adaptive-k method"):
        t_rounds.run_federated(T_CLIENT, T_SERVER,
                               t_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                               device="cpu")
