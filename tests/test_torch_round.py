"""The port's whole federated round against the JAX reference, on the CPU.

``run_federated(engine="fused_e2e")`` in both packages on the tiny configs
of ``tests/test_engine.py`` (constrained channel, 2 rounds), with the float
wire, the int8 wire, and a dropout channel whose round 0 loses every
client (the cold server and the all-dropped round are data masks in the
reference, plain branches in the port).  The port's model init is replaced
by the bridged JAX init for the same (config, seed).

Integers (per-client k, uplink/downlink bytes, transmitters) must be
identical; accuracies agree within one eval sample; the server-distill
loss and the final broadcast logits within rtol 1e-4 (the logits relative
to their largest magnitude).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
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


def _fed_kwargs(case):
    return dict(
        method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2,
        public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=2, distill_steps=1,
        server_distill_steps=2, seed=0, pretrain_steps=0, **CASES[case]["fed"],
    )


def _capture(module, name, into):
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        into.append(make(*args, **kwargs))
        return into[-1]

    return wrapped


@pytest.fixture(scope="module")
def runs():
    """{case: (reference run, its engine, port run, its engine)}, computed
    once per case."""
    cfg_map = {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}

    def bridged_init(cfg, seed, device="cuda"):
        tree = j_init(jax.random.PRNGKey(seed), cfg_map[cfg])
        return bridge.to_torch(jax.tree.map(np.asarray, tree), device)

    out, j_eng, t_eng = {}, [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_model, "init", bridged_init)
        mp.setattr(j_rounds, "make_engine", _capture(j_rounds, "make_engine", j_eng))
        mp.setattr(t_rounds, "FusedE2EEngine", _capture(t_rounds, "FusedE2EEngine", t_eng))
        for case, spec in CASES.items():
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
            out[case] = (j_run, j_eng[-1], t_run, t_eng[-1])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_round_integers_identical(runs, case):
    j_run, _, t_run, _ = runs[case]
    assert t_run.per_client_k == j_run.per_client_k
    assert len(t_run.ledger.rounds) == len(j_run.ledger.rounds) == CASES[case]["fed"]["rounds"]
    for t, j in zip(t_run.ledger.rounds, j_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
    if case == "all_dropped_round":
        assert t_run.per_client_k[0] == [0, 0] and any(k > 0 for k in t_run.per_client_k[1])


@pytest.mark.parametrize("case", list(CASES))
def test_round_floats_match(runs, case):
    j_run, j_eng, t_run, t_eng = runs[case]
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=one_sample)
    # NaN where no client transmitted (the server never distilled)
    np.testing.assert_allclose(t_run.distill_loss, j_run.distill_loss, rtol=1e-4, equal_nan=True)
    assert np.isnan(t_run.distill_loss[0]) == (sum(t_run.per_client_k[0]) == 0)
    j_b = np.asarray(j_eng._b_logits)
    t_b = t_eng._b_logits.numpy()
    np.testing.assert_allclose(t_b, j_b, rtol=0, atol=1e-4 * np.abs(j_b).max())


@pytest.mark.parametrize("change,item", [
    (dict(engine="batched"), "sequential and batched engines"),
    (dict(engine="fused"), "fused engine"),
    (dict(pretrain_steps=80), "pretraining"),
    (dict(compute_dtype="bfloat16"), "bf16"),
    (dict(scenario="gauss_markov"), "scenarios and faults"),
    (dict(faults="crashes"), "scenarios and faults"),
    (dict(fleet_store="host"), "host fleet store"),
    (dict(scan_rounds=True), "run_rounds"),
    (dict(shard_clients=True), "scale-out"),
])
def test_what_the_port_does_not_carry_raises(change, item):
    fed = TFed(**{**_fed_kwargs("float_wire"), **change})
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md port queue: .*{item}"):
        t_rounds.run_federated(T_CLIENT, T_SERVER, ds, fed, device="cpu")
