"""The port's channel scenarios against the JAX reference, on the CPU.

* ``ChannelSimulator.scan_channel_inputs`` for every preset, from round 0
  and from round 2: ``np.array_equal`` to the reference's, dtypes included.
* The block's channel step (``repro_torch.fed.steps.make_channel_step_fn``,
  fp32 tensor math) iterated over the rounds: within 1e-3 dB of the
  reference's ``make_channel_step_fn`` (fp32 ``jnp``; ``ndtr``, ``log1p``
  and ``log10`` round differently in the two libraries) and within the
  reference's stated 1e-2 dB of the host's f64 chain; outage flags
  identical to both.
* The golden trajectory ``tests/data/scenario_golden.json`` (the
  reference's engine-level tiny scenario, no JAX needed: k and bytes are
  host math on the channel): the port's ``fused_e2e`` round by round and
  as a block, ``ks``, ``payload_bytes`` and ``outage`` exactly and
  ``snr_db`` within 5e-3 dB of the record's three decimals.
* One preset (``gilbert_elliott``) run live in both packages through
  ``run_federated`` with ``scan_rounds`` and round by round: integers
  identical, the block's SNR taps within 1e-3 dB of the reference's block
  and outage flags identical, accuracies within one eval sample (the
  bridged JAX init on both sides, as ``tests/test_torch_round.py``).
"""

import dataclasses
import json
import math
import os

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
from repro.core.channel import ChannelConfig as JChannel  # noqa: E402
from repro.core.channel import ChannelSimulator as JSim  # noqa: E402
from repro.core.scenario import get_scenario as j_get_scenario  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed.steps import make_channel_step_fn as j_channel_step  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import SCENARIOS  # noqa: E402
from repro_torch.core.channel import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.channel import ChannelSimulator as TSim  # noqa: E402
from repro_torch.core.scenario import get_scenario as t_get_scenario  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.client import Client as TClient  # noqa: E402
from repro_torch.fed.engines import FusedE2EEngine  # noqa: E402
from repro_torch.fed.server import Server as TServer  # noqa: E402
from repro_torch.fed.steps import make_channel_step_fn as t_channel_step  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
PRESETS = tuple(SCENARIOS)  # iid, gauss_markov, jakes, gilbert_elliott, mobility
# a channel with stragglers, so the outage chain has work to do
CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0, min_k=0, dropout_prob=0.25)
EVAL_SIZE = 64


def _sims(preset, n=6, seed=0):
    j_cfg = dataclasses.replace(JChannel(**CHAN), scenario=j_get_scenario(preset))
    t_cfg = dataclasses.replace(TChannel(**CHAN), scenario=t_get_scenario(preset))
    return JSim(n, j_cfg, seed=seed), TSim(n, t_cfg, seed=seed)


@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("preset", PRESETS)
def test_scan_channel_inputs_equal_reference(preset, start):
    j_sim, t_sim = _sims(preset)
    j_in = j_sim.scan_channel_inputs(5, start_round=start)
    t_in = t_sim.scan_channel_inputs(5, start_round=start)
    assert set(t_in) == set(j_in)
    for key in j_in:
        assert np.asarray(t_in[key]).dtype == np.asarray(j_in[key]).dtype, key
        assert np.array_equal(t_in[key], j_in[key]), key


@pytest.mark.parametrize("preset", PRESETS)
def test_channel_step_replays_the_reference(preset):
    """Six rounds of the fleet's chain from round 0, each round's SNR and
    outage against the reference's step and against the host's states."""
    j_sim, t_sim = _sims(preset)
    ops = t_sim.scan_channel_inputs(6)
    names = ("w", "u", "base_snr_db")
    scalars = ("rho", "p_gb", "p_bg", "fade_scale")
    j_step, t_step = j_channel_step(), t_channel_step()
    jz, jb = jnp.asarray(ops["z0"]), jnp.asarray(ops["bad0"])
    tz, tb = torch.as_tensor(ops["z0"]), torch.as_tensor(ops["bad0"])
    for r in range(6):
        jz, jb, j_snr = j_step(jz, jb, *(jnp.asarray(ops[k][r]) for k in names),
                               *(jnp.asarray(ops[k]) for k in scalars))
        tz, tb, t_snr = t_step(tz, tb, *(torch.as_tensor(ops[k][r]) for k in names),
                               *(torch.as_tensor(ops[k]) for k in scalars))
        assert t_snr.dtype == torch.float32 and tb.dtype == torch.bool
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        host = np.array([s.snr_db for s in j_sim.states(r, list(range(6)))])
        np.testing.assert_array_equal(tb.numpy(), host == -np.inf)
        live = ~tb.numpy()
        t_snr = t_snr.numpy()
        assert np.all(np.isneginf(t_snr[~live]))
        np.testing.assert_allclose(t_snr[live], np.asarray(j_snr)[live], rtol=0, atol=1e-3)
        np.testing.assert_allclose(t_snr[live], host[live], rtol=0, atol=1e-2)


# -- the golden trajectory -------------------------------------------------------

_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data", "scenario_golden.json")
_GOLDEN_SELS = [[0, 1], [2, 3], [1, 2]]


def _golden_engine(ds):
    """The reference's golden setup (``tests/test_scenario.py``,
    ``tests/test_engine.py::_shared_cohort``) in the port: four clients on
    one backbone, 60 samples each, one local and one distill step."""
    backbone = t_model.init(T_CLIENT, 7, "cpu")
    clients = [TClient(i, T_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)),
                       num_classes=ds.num_classes, seed=i, local_steps=1, distill_steps=1,
                       device="cpu", initial_params=backbone)
               for i in range(4)]
    server = TServer(T_SERVER, aggregation="adaptive", distill_steps=2, device="cpu")
    return FusedE2EEngine(clients, T_CLIENT, server=server, num_classes=ds.num_classes,
                          local_steps=1, distill_steps=1, server_distill_steps=2, k_min=0)


@pytest.fixture(scope="module")
def golden_runs():
    """{preset: (host simulator, per-round ks, per-round payload bytes, the
    block's trajectory)}."""
    out = {}
    for preset in ("gauss_markov", "jakes"):
        ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
        cfg = dataclasses.replace(TChannel(bandwidth_hz=2e5, mean_snr_db=2.0, min_k=0,
                                           dropout_prob=0.25), scenario=t_get_scenario(preset))
        sim = TSim(4, cfg, seed=0)
        pubs = [torch.as_tensor(ds.tokens[16 * r:16 * (r + 1)]) for r in range(3)]
        states = [sim.states_batched(r, _GOLDEN_SELS[r]) for r in range(3)]
        loop, bcast, ks, pbytes = _golden_engine(ds), None, [], []
        for r in range(3):
            ph = loop.run_round(_GOLDEN_SELS[r], pubs[r], bcast, states[r], adaptive_k=True,
                                send_h=True)
            bcast = loop.broadcast_state(pubs[r])
            ks.append(ph.ks)
            pbytes.append([p.bytes for p in ph.payloads])
        traj = _golden_engine(ds).run_rounds(_GOLDEN_SELS, pubs, states, adaptive_k=True,
                                              send_h=True, channel_scan=sim.scan_channel_inputs(3))
        out[preset] = (sim, ks, pbytes, traj)
    return out


@pytest.mark.parametrize("path", ["per_round", "block"])
@pytest.mark.parametrize("preset", ["gauss_markov", "jakes"])
def test_golden_trajectory(golden_runs, preset, path):
    with open(_GOLDEN_PATH) as f:
        golden = json.load(f)[preset]
    sim, ks, pbytes, traj = golden_runs[preset]
    if path == "block":
        ks, pbytes = traj.ks, [[p.bytes for p in pl] for pl in traj.payloads]
    assert ks == golden["ks"]
    assert pbytes == golden["payload_bytes"]
    for r in range(3):
        for i, st in enumerate(sim.states(r, _GOLDEN_SELS[r])):
            snr = traj.snr_db[r][i] if path == "block" else st.snr_db
            out = traj.outage[r][i] if path == "block" else st.snr_db == -math.inf
            assert out == golden["outage"][r][i]
            g = golden["snr_db"][r][i]
            if g is None:
                assert not math.isfinite(snr)
            else:
                assert snr == pytest.approx(g, abs=5e-3)


# -- a live scenario federation in both packages -----------------------------------

RUN_CASES = {"block": True, "per_round": False}


def _fed(scan, package):
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    return fed(method="adald", engine="fused_e2e", scan_rounds=scan, num_clients=6,
               clients_per_round=4, rounds=3, public_size=64, public_batch=16, eval_size=EVAL_SIZE,
               local_steps=1, distill_steps=1, server_distill_steps=1, seed=0, pretrain_steps=0,
               scenario="gilbert_elliott", channel=chan(bandwidth_hz=2e5, mean_snr_db=2.0))


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(scope="module")
def live_runs():
    """{case: (reference run, port run)}: the reference's own block, and its
    per-round run."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_model, "init", _bridged_init)
        for case, scan in RUN_CASES.items():
            out[case] = (
                j_rounds.run_federated(J_CLIENT, J_SERVER,
                                       j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                                       _fed(scan, "jax")),
                t_rounds.run_federated(T_CLIENT, T_SERVER,
                                       t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                                       _fed(scan, "torch"), device="cpu"))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_scenario_run_matches_reference(live_runs, case):
    j_run, t_run = live_runs[case]
    assert t_run.per_client_k == j_run.per_client_k
    assert any(k == 0 for ks in t_run.per_client_k for k in ks)  # the chain drops clients
    for t, j in zip(t_run.ledger.rounds, j_run.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes) == (j.uplink_bytes, j.downlink_bytes)
        assert (t.num_selected, t.num_transmitters) == (j.num_selected, j.num_transmitters)
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(t_run.server_acc, j_run.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.client_acc, j_run.client_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(t_run.distill_loss, j_run.distill_loss, rtol=1e-4, equal_nan=True)
    if case == "per_round":  # the taps come from the block only, as in the reference
        assert t_run.snr_db is None and j_run.snr_db is None
        return
    assert t_run.outage == j_run.outage
    t_snr, j_snr = np.array(t_run.snr_db), np.array(j_run.snr_db)
    np.testing.assert_array_equal(np.isneginf(t_snr), np.isneginf(j_snr))
    live = np.isfinite(j_snr)
    np.testing.assert_allclose(t_snr[live], j_snr[live], rtol=0, atol=1e-3)
    # the block's taps are the channel that priced its budgets: outage, k = 0
    for ks, out in zip(t_run.per_client_k, t_run.outage):
        assert all(k == 0 for k, o in zip(ks, out) if o)


def test_block_taps_equal_the_per_round_channel(live_runs):
    """The port's block and its per-round run: one channel, so one set of
    budgets; the block's outage flags are the host chain's."""
    t_block, t_loop = live_runs["block"][1], live_runs["per_round"][1]
    assert t_block.per_client_k == t_loop.per_client_k
    np.testing.assert_allclose(t_block.server_acc, t_loop.server_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_block.distill_loss, t_loop.distill_loss, rtol=1e-4)
