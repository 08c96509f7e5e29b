"""The port's whole federated round against the JAX reference, on the CPU.

``run_federated`` in both packages on the tiny configs of
``tests/test_engine.py`` (constrained channel, 2 rounds), with
``use_kernels=True`` on both sides:

* ``engine="fused_e2e"`` with the float wire, the int8 wire, and a dropout
  channel whose round 0 loses every client (the cold server and the
  all-dropped round are data masks in the reference, plain branches in the
  port);
* the dense uplink: ``engine="fused"`` with the same three channels and
  ``engine="batched"`` with the float uplink (its Server aggregates through
  the dense kernel's plain version).

The port's model init is replaced by the bridged JAX init for the same
(config, seed).  Integers (per-client k, uplink/downlink bytes,
transmitters) must be identical; accuracies agree within one eval sample;
the server-distill loss and the final broadcast logits within rtol 1e-4
(the logits relative to their largest magnitude), the final server LoRA
leaves within 1e-4 in relative L2 norm (Adam's normalised step turns a
last-bit gradient difference on a near-zero-gradient element into a step
difference of order lr, so single elements drift further).  On
the dense uplink the reference reports no server-distill loss: NaN on both
sides.  An engine-level test holds ``FusedEngine.run_round``'s dense uplink
against the reference's ``FusedEngine(use_kernels=True)`` at 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core.channel import BatchedChannelState as JStates  # noqa: E402
from repro.core.channel import ChannelState as JState  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed.client import Client as JClient  # noqa: E402
from repro.fed.engines import BroadcastState as JBcast  # noqa: E402
from repro.fed.engines import FusedEngine as JFused  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.channel import BatchedChannelState as TStates  # noqa: E402
from repro_torch.core.channel import ChannelState as TState  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.client import Client as TClient  # noqa: E402
from repro_torch.fed.engines import BroadcastState as TBcast  # noqa: E402
from repro_torch.fed.engines import FusedEngine as TFused  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

# tests/test_engine.py's configs, in both packages
_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
EVAL_SIZE = 64

CASES = {
    "float_wire": dict(fed=dict(rounds=2), chan=_CHAN),
    "int8_wire": dict(fed=dict(rounds=2, quantize_wire=True), chan=_CHAN),
    # round 0: cold server AND every selected client dropped
    "all_dropped_round": dict(fed=dict(rounds=3), chan=dict(_CHAN, min_k=0, dropout_prob=0.6)),
}
# the dense uplink: the same channels through the fused engine, and the
# batched engine on the float uplink
DENSE_CASES = {
    **{f"fused_{case}": dict(spec, fed=dict(spec["fed"], engine="fused"))
       for case, spec in CASES.items()},
    "batched_float_wire": dict(CASES["float_wire"], fed=dict(rounds=2, engine="batched")),
}
# the paper's other methods (aggregation, projection, adaptive k) on one case
METHOD_CASES = {f"batched_{method}": dict(CASES["float_wire"], fed=dict(rounds=2, engine="batched",
                                                                        method=method))
                for method in ("adaptive", "zeropad", "all_logits")}
ALL_CASES = {**CASES, **DENSE_CASES, **METHOD_CASES}


def _fed_kwargs(case):
    return dict(dict(
        method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2,
        public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=2, distill_steps=1,
        server_distill_steps=2, seed=0, pretrain_steps=0,
    ), **ALL_CASES[case]["fed"])


def _capture(module, name, into):
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        into.append(make(*args, **kwargs))
        return into[-1]

    return wrapped


def _bridged_init(cfg, seed, device="cuda", **_):
    cfg_map = {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}
    tree = j_init(jax.random.PRNGKey(seed), cfg_map[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


def _run_cases(cases):
    """{case: (reference run, its engine, port run, its engine, reference
    server, port server)}, computed once per case."""
    out, j_eng, t_eng, j_srv, t_srv = {}, [], [], [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_model, "init", _bridged_init)
        mp.setattr(j_rounds, "make_engine", _capture(j_rounds, "make_engine", j_eng))
        mp.setattr(t_rounds, "make_engine", _capture(t_rounds, "make_engine", t_eng))
        mp.setattr(j_rounds, "Server", _capture(j_rounds, "Server", j_srv))
        mp.setattr(t_rounds, "Server", _capture(t_rounds, "Server", t_srv))
        for case in cases:
            spec = ALL_CASES[case]
            ops.reset_launches()
            j_run = j_rounds.run_federated(
                J_CLIENT, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                JFed(channel=JChannel(**spec["chan"]), **_fed_kwargs(case)),
            )
            t_run = t_rounds.run_federated(
                T_CLIENT, T_SERVER, t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                TFed(channel=TChannel(**spec["chan"]), use_kernels=True, **_fed_kwargs(case)),
                device="cpu",
            )
            assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
            out[case] = (j_run, j_eng[-1], t_run, t_eng[-1], j_srv[-1], t_srv[-1])
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs():
    return _run_cases(CASES)


@pytest.fixture(scope="module")
def dense_runs():
    return _run_cases(DENSE_CASES)


@pytest.fixture(scope="module")
def method_runs():
    return _run_cases(METHOD_CASES)


def _integers_identical(j_run, t_run, case):
    assert t_run.per_client_k == j_run.per_client_k
    assert len(t_run.ledger.rounds) == len(j_run.ledger.rounds) == ALL_CASES[case]["fed"]["rounds"]
    for t, j in zip(t_run.ledger.rounds, j_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
    if case.endswith("all_dropped_round"):
        assert t_run.per_client_k[0] == [0, 0] and any(k > 0 for k in t_run.per_client_k[1])


def _accuracies_match(j_run, t_run):
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=one_sample)


def _close(t, j, rtol=1e-4):
    """``t`` within ``rtol`` of ``j``'s largest magnitude, elementwise."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_round_integers_identical(runs, case):
    j_run, _, t_run, _, _, _ = runs[case]
    _integers_identical(j_run, t_run, case)


@pytest.mark.parametrize("case", list(CASES))
def test_round_floats_match(runs, case):
    j_run, j_eng, t_run, t_eng, _, _ = runs[case]
    _accuracies_match(j_run, t_run)
    # NaN where no client transmitted (the server never distilled)
    np.testing.assert_allclose(t_run.distill_loss, j_run.distill_loss, rtol=1e-4, equal_nan=True)
    assert np.isnan(t_run.distill_loss[0]) == (sum(t_run.per_client_k[0]) == 0)
    j_b = np.asarray(j_eng._b_logits)
    t_b = t_eng._b_logits.numpy()
    np.testing.assert_allclose(t_b, j_b, rtol=0, atol=1e-4 * np.abs(j_b).max())


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_round_integers_identical(dense_runs, case):
    j_run, _, t_run, t_eng, _, _ = dense_runs[case]
    _integers_identical(j_run, t_run, case)
    assert t_eng.name == ALL_CASES[case]["fed"]["engine"]


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_round_floats_match(dense_runs, case):
    j_run, _, t_run, _, j_srv, t_srv = dense_runs[case]
    _accuracies_match(j_run, t_run)
    # the reference reports no server-distill loss off the e2e path
    assert np.isnan(t_run.distill_loss).all() and np.isnan(j_run.distill_loss).all()
    j_params = bridge.flatten(jax.tree.map(np.asarray, j_srv.params))
    lora_keys = [k for k in t_srv.params if "lora" in k]
    assert lora_keys and set(t_srv.params) == set(j_params)
    for k in lora_keys:
        t, j = t_srv.params[k].numpy(), j_params[k]
        assert np.linalg.norm(t - j) <= 1e-4 * np.linalg.norm(j), k
    # the broadcast both final servers send on one public batch
    tokens = np.random.default_rng(3).integers(0, 256, size=(16, 12)).astype(np.int32)
    j_b = j_srv.broadcast(jnp.asarray(tokens))
    t_b = t_srv.broadcast(torch.as_tensor(tokens))
    _close(t_b[0].numpy(), j_b[0])
    _close(t_b[1].numpy(), j_b[1])
    assert t_b[2] == j_b[2]


@pytest.mark.parametrize("case", list(METHOD_CASES))
def test_method_round_matches_reference(method_runs, case):
    """``adaptive`` (no projection), ``zeropad`` (the mean) and
    ``all_logits`` (k = V for everyone): the reference's k, bytes and
    transmitters, its accuracies within one eval sample."""
    j_run, _, t_run, _, _, _ = method_runs[case]
    _integers_identical(j_run, t_run, case)
    _accuracies_match(j_run, t_run)
    assert np.isnan(t_run.distill_loss).all() and np.isnan(j_run.distill_loss).all()
    if case.endswith("all_logits"):
        assert all(k == 256 for ks in t_run.per_client_k for k in ks)


def _batched_run(**option):
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    fed = dict(_fed_kwargs("batched_float_wire"), channel=TChannel(**_CHAN), use_kernels=True)
    return t_rounds.run_federated(T_CLIENT, T_SERVER, ds, TFed(**fed, **option), device="cpu")


@pytest.fixture(scope="module")
def plain_batched_run():
    return _batched_run()


@pytest.mark.parametrize("option", [dict(compute_dtype="bfloat16"), dict(shard_clients=True)],
                         ids=["compute_dtype", "shard_clients"])
def test_batched_engine_drops_the_options_it_does_not_take(plain_batched_run, option):
    """As the reference's ``make_engine`` does, the batched engine drops
    ``compute_dtype`` (it is the fp32 per-phase reference) and
    ``shard_clients``: the run is the plain batched run, bit for bit."""
    plain, other = plain_batched_run, _batched_run(**option)
    assert other.per_client_k == plain.per_client_k
    for o, p in zip(other.ledger.rounds, plain.ledger.rounds):
        assert (o.uplink_bytes, o.downlink_bytes, o.num_transmitters) == (
            p.uplink_bytes, p.downlink_bytes, p.num_transmitters)
    assert (other.server_acc, other.client_acc) == (plain.server_acc, plain.client_acc)


def test_sequential_engine_drops_shard_clients():
    """As the reference's ``make_engine`` does, the sequential engine drops
    ``shard_clients`` (the batched engine's case is above): both packages
    build their plain sequential engine, and the port's run is the plain
    sequential run, bit for bit."""
    j_ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    j_clients = [JClient(i, J_CLIENT, j_ds.subset(np.arange(i * 60, (i + 1) * 60)),
                         num_classes=j_ds.num_classes, seed=i) for i in range(2)]
    j_eng = j_rounds.make_engine("sequential", j_clients, J_CLIENT, shard_clients=True,
                                 num_classes=j_ds.num_classes)
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    fed = dict(_fed_kwargs("batched_float_wire"), channel=TChannel(**_CHAN), engine="sequential",
               rounds=1)
    built = []
    mp = pytest.MonkeyPatch()
    mp.setattr(t_rounds, "make_engine", _capture(t_rounds, "make_engine", built))
    try:
        runs = [t_rounds.run_federated(T_CLIENT, T_SERVER, ds, TFed(**fed, shard_clients=shard),
                                       device="cpu") for shard in (False, True)]
    finally:
        mp.undo()
    assert type(j_eng).__name__ == type(built[1]).__name__ == "SequentialEngine"
    assert not hasattr(built[1], "shard_clients")
    plain, other = runs
    assert other.per_client_k == plain.per_client_k
    assert (other.server_acc, other.client_acc) == (plain.server_acc, plain.client_acc)
    for o, p in zip(other.ledger.rounds, plain.ledger.rounds):
        assert (o.uplink_bytes, o.downlink_bytes) == (p.uplink_bytes, p.downlink_bytes)


def _fused_engines(seed=0, n=3):
    """``tests/test_engine.py``'s ``_mini_cohort`` in both packages: clients
    with 60 private samples each on the tiny client config, the port's
    clients carrying the reference clients' parameters."""
    j_ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=seed)
    t_ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=seed)
    j_clients, t_clients = [], []
    for i in range(n):
        rows = np.arange(i * 60, (i + 1) * 60)
        j_clients.append(JClient(i, J_CLIENT, j_ds.subset(rows), num_classes=j_ds.num_classes,
                                 seed=i, local_steps=1, distill_steps=1))
        t_clients.append(TClient(i, T_CLIENT, t_ds.subset(rows), seed=i, device="cpu"))
        t_clients[-1].params = bridge.to_torch(jax.tree.map(np.asarray, j_clients[-1].params), "cpu")
    kw = dict(num_classes=j_ds.num_classes, local_steps=1, distill_steps=1, k_min=0,
              use_kernels=True)
    return j_ds, JFused(j_clients, J_CLIENT, **kw), TFused(t_clients, T_CLIENT, **kw)


def test_fused_engine_dense_uplink_matches_reference():
    """Two rounds of ``FusedEngine.run_round`` — cold, then against a
    broadcast — with a k = 0 straggler: identical k and transmitters, the
    same top-k support, values and projections within 1e-5 of their
    largest magnitude."""
    ds, j_eng, t_eng = _fused_engines()
    snrs = [10.0, -float("inf"), 0.0]
    j_states = JStates.from_states([JState(1e6, s, 0.5, 1.0) for s in snrs])
    t_states = TStates.from_states([TState(1e6, s, 0.5, 1.0) for s in snrs])
    pub = ds.tokens[:16]
    rng = np.random.default_rng(5)
    g_logits = rng.normal(size=(16, 256)).astype(np.float32)
    g_h = rng.normal(size=(16, 4)).astype(np.float32)
    bcasts = [(None, None), (
        JBcast(tokens=jnp.asarray(pub), logits=jnp.asarray(g_logits), h=jnp.asarray(g_h), bits=0),
        TBcast(tokens=torch.as_tensor(pub), logits=torch.as_tensor(g_logits),
               h=torch.as_tensor(g_h), bits=0),
    )]
    ops.reset_launches()
    for j_b, t_b in bcasts:
        jp = j_eng.run_round([0, 1, 2], jnp.asarray(pub), j_b, j_states, adaptive_k=True, send_h=True)
        tp = t_eng.run_round([0, 1, 2], torch.as_tensor(pub), t_b, t_states, adaptive_k=True,
                             send_h=True)
        assert tp.ks == jp.ks and tp.ks[1] == 0 and min(tp.ks[0], tp.ks[2]) > 0
        assert [p.client_id for p in tp.payloads] == [p.client_id for p in jp.payloads] == [0, 2]
        j_dense = np.asarray(jp.dense)
        np.testing.assert_array_equal(tp.dense.numpy() != 0, j_dense != 0)
        _close(tp.dense.numpy(), j_dense, rtol=1e-5)
        _close(tp.h.numpy(), np.asarray(jp.h), rtol=1e-5)
    assert sum(ops.LAUNCHES.values()) == 0
    for cid in range(3):  # the advanced fleet rows (L2 bound: see the module docstring)
        j_lora = bridge.flatten(jax.tree.map(np.asarray, j_eng.client_params(cid)))
        for k, v in t_eng.client_params(cid).items():
            if "lora" in k:
                assert np.linalg.norm(v.numpy() - j_lora[k]) <= 1e-5 * np.linalg.norm(j_lora[k]), k


_QUEUE = "ROADMAP.md port queue: "


# a Llama-style family beside T_CLIENT: a mixed fleet
_MIXED = [T_CLIENT, T_CLIENT.with_overrides(name="t-llama", positional="rope", norm="rmsnorm",
                                            activation="swiglu", num_kv_heads=1)]


@pytest.mark.parametrize("change,exc,match,clients", [
    # the id is kept from the bf16 refusal that this case held before bf16 ran;
    # fp16 runs now (tests/test_torch_fp16_round.py), a float64 round body does not
    pytest.param(dict(compute_dtype="float64"), ValueError, "compute_dtype='float64'", T_CLIENT,
                 id="bf16-compute"),
    # the reference's own refusal, kept by the port's sequential engine
    pytest.param(dict(engine="sequential", fleet_store="host"), NotImplementedError,
                 "fleet_store='host' is not supported by the sequential reference engine",
                 T_CLIENT, id="sequential-host-fleet-store"),
    # a mixed fleet's block runs (tests/test_torch_hetero_block*.py); one with
    # a family in a dtype the port does not take is refused before any work
    pytest.param(dict(scan_rounds=True), ValueError, "compute_dtype='float64'",
                 [_MIXED[0], _MIXED[1].with_overrides(compute_dtype="float64")],
                 id="mixed-fleet-scan-rounds"),
    # a VLM runs in a mixed fleet's block too; a VLM family in float64 is refused
    pytest.param(dict(scan_rounds=True), ValueError, "param_dtype='float64'",
                 [T_CLIENT, T_CLIENT.with_overrides(family="vlm", frontend="vision",
                                                    param_dtype="float64")],
                 id="vlm-family"),
])
def test_what_the_port_does_not_carry_raises(change, exc, match, clients):
    fed = TFed(**{**_fed_kwargs("float_wire"), **change})
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    with pytest.raises(exc, match=match):
        t_rounds.run_federated(clients, T_SERVER, ds, fed, device="cpu")
