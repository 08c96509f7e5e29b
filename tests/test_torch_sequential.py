"""The port's sequential engine against the JAX reference, on the CPU.

``run_federated(engine="sequential")`` in both packages on the tiny configs
of ``tests/test_engine.py`` (AdaLD; the constrained channel for 2 rounds,
and a dropout channel whose round 0 loses every client for 3), with
``use_kernels=True`` on both sides, the port's model init replaced by the
bridged JAX init for the same (config, seed), at the tolerances of
``tests/test_torch_round.py``: integers (per-client k, uplink and downlink
bytes, transmitters) identical; accuracies within one eval sample; the
final server LoRA leaves within 1e-4 in relative L2 norm; its broadcast
within 1e-4 of the largest logit.  Off the e2e path the server-distill
loss is NaN on both sides, by the reference's definition.

The port's sequential engine is also held against the port's batched
engine on the same seed: identical k, bytes and transmitters, the final
server within the same bounds (one client at a time runs the same
arithmetic on a client axis of 1, so the two differ only in the order of
fp32 sums).
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
from repro_torch.fed.engines import SequentialEngine, make_engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
EVAL_SIZE = 64
FED = dict(method="adald", num_clients=4, clients_per_round=2, public_size=64,
           public_batch=16, eval_size=EVAL_SIZE, local_steps=2, distill_steps=1,
           server_distill_steps=2, seed=0, pretrain_steps=0, use_kernels=True)
CHANNELS = {  # name: (channel, rounds)
    "float": (_CHAN, 2),
    # round 0: cold server AND every selected client dropped (k = 0 stragglers)
    "dropout": (dict(_CHAN, min_k=0, dropout_prob=0.6), 3),
}
# (package/engine, channel) of each run; the batched run only on the float channel
RUNS = [("reference", "float"), ("sequential", "float"), ("batched", "float"),
        ("reference", "dropout"), ("sequential", "dropout")]
# the probe batch both final servers answer
PROBE = np.random.default_rng(3).integers(0, 256, size=(16, 12)).astype(np.int32)


def _bridged_init(cfg, seed, device="cuda", **_):
    cfg_map = {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}
    tree = j_init(jax.random.PRNGKey(seed), cfg_map[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


def _capture(module, name, into):
    make = getattr(module, name)

    def wrapped(*args, **kwargs):
        into.append(make(*args, **kwargs))
        return into[-1]

    return wrapped


@pytest.fixture(scope="module")
def runs():
    """{(name, channel): (run, engine, server)} for the reference's
    sequential runs and the port's sequential and batched runs, each
    computed once."""
    out, eng, srv = {}, [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_model, "init", _bridged_init)
        for mod in (j_rounds, t_rounds):
            mp.setattr(mod, "make_engine", _capture(mod, "make_engine", eng))
            mp.setattr(mod, "Server", _capture(mod, "Server", srv))
        for name, chan in RUNS:
            channel, rounds = CHANNELS[chan]
            if name == "reference":
                run = j_rounds.run_federated(
                    J_CLIENT, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                    JFed(engine="sequential", rounds=rounds, channel=JChannel(**channel), **FED),
                )
            else:
                ops.reset_launches()
                run = t_rounds.run_federated(
                    T_CLIENT, T_SERVER, t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                    TFed(engine=name, rounds=rounds, channel=TChannel(**channel), **FED),
                    device="cpu",
                )
                assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
            out[name, chan] = (run, eng[-1], srv[-1])
    finally:
        mp.undo()
    return out


def _is_port(srv) -> bool:
    return type(srv).__module__.startswith("repro_torch.")


def _server_lora(srv) -> dict:
    if _is_port(srv):
        return {k: v.numpy() for k, v in srv.params.items() if "lora" in k}
    params = bridge.flatten(jax.tree.map(np.asarray, srv.params))
    return {k: v for k, v in params.items() if "lora" in k}


def _broadcast(srv) -> np.ndarray:
    if _is_port(srv):
        return srv.broadcast(torch.as_tensor(PROBE))[0].numpy()
    return np.asarray(srv.broadcast(jnp.asarray(PROBE))[0])


PAIRS = [("reference", "float"), ("batched", "float"), ("reference", "dropout")]


@pytest.mark.parametrize("other,chan", PAIRS)
def test_sequential_integers_identical(runs, other, chan):
    seq, eng, _ = runs["sequential", chan]
    ref_run = runs[other, chan][0]
    assert isinstance(eng, SequentialEngine)
    assert seq.per_client_k == ref_run.per_client_k
    assert len(seq.ledger.rounds) == len(ref_run.ledger.rounds) == CHANNELS[chan][1]
    for t, j in zip(seq.ledger.rounds, ref_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
    if chan == "float":
        assert len({k for ks in seq.per_client_k for k in ks}) > 1  # the channel constrains k
    else:  # stragglers transmit nothing: round 0 has no transmitter at all
        assert seq.per_client_k[0] == [0, 0] and seq.ledger.rounds[0].num_transmitters == 0
        assert any(k > 0 for k in seq.per_client_k[1])


@pytest.mark.parametrize("other,chan", PAIRS)
def test_sequential_floats_match(runs, other, chan):
    seq, _, t_srv = runs["sequential", chan]
    ref_run, _, o_srv = runs[other, chan]
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(seq.server_acc, ref_run.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(seq.client_acc, ref_run.client_acc, rtol=0, atol=one_sample)
    assert np.isnan(seq.distill_loss).all() and np.isnan(ref_run.distill_loss).all()
    t_lora, o_lora = _server_lora(t_srv), _server_lora(o_srv)
    assert t_lora and set(t_lora) == set(o_lora)
    for k, t in t_lora.items():
        assert np.linalg.norm(t - o_lora[k]) <= 1e-4 * np.linalg.norm(o_lora[k]), k
    t_b, o_b = _broadcast(t_srv), _broadcast(o_srv)
    np.testing.assert_allclose(t_b, o_b, rtol=0, atol=1e-4 * np.abs(o_b).max())


@pytest.mark.parametrize("chan", list(CHANNELS))
def test_sequential_clients_match_reference(runs, chan):
    """Every client's advanced LoRA against the reference client's (the
    clients keep their own state on the sequential engine)."""
    _, t_eng, _ = runs["sequential", chan]
    _, j_eng, _ = runs["reference", chan]
    for cid in range(FED["num_clients"]):
        j_lora = bridge.flatten(jax.tree.map(np.asarray, j_eng.client_params(cid)))
        for k, v in t_eng.client_params(cid).items():
            if "lora" in k:
                assert np.linalg.norm(v.numpy() - j_lora[k]) <= 1e-4 * np.linalg.norm(j_lora[k]), k


@pytest.mark.parametrize("option,match", [
    pytest.param(dict(quantize_wire=True), "quantize_wire is not supported by the sequential",
                 id="quantize_wire"),
    pytest.param(dict(compute_dtype="bfloat16"), "compute_dtype is not supported by the sequential",
                 id="bf16-compute"),
    pytest.param(dict(fleet_store="host"), "fleet_store='host' is not supported by the sequential",
                 id="host-fleet-store"),
])
def test_make_engine_sequential_keeps_the_reference_refusals(option, match):
    with pytest.raises(NotImplementedError, match=match):
        make_engine("sequential", [], T_CLIENT, **option)
