"""``run_federated(..., scan_rounds=True)`` on a mixed fleet in the port,
against the port's per-round run and the reference's scan, on the CPU.

The fleet is ``tests/test_torch_ssm_fleet.py``'s dense and SSM families (a
2-layer GPT-2 and mamba2's smoke, both at d 64 on vocabulary 256 with LoRA
rank 4 on q, v and the head) and its server, 4 clients, cohorts of 2, 3
rounds, the constrained channel of ``tests/test_hetero.py`` under the
``gauss_markov`` scenario, so the block evolves the channel on the device
and fills the SNR and outage taps.  Both packages start from the
reference's init, bridged.

* The block against the reference's scan: per-client k, uplink and
  downlink bytes and transmitters identical; outage flags identical and the
  SNR taps within 1e-3 dB (both are fp32 replicas of the host's chain, and
  ``ndtr``, ``log1p`` and ``log10`` round differently in the two
  libraries: ``tests/test_torch_scenario.py``); accuracies, the family
  tap's included, within one eval sample (1/64); the distill loss within
  rtol 1e-4.
* The block against the port's per-round run: integers identical,
  accuracies within 1e-6, the distill loss within rtol 1e-4 (the
  reference's contract for its scan, ``tests/test_hetero.py``).
* ``fleet_store="host"`` with ``scan_rounds``: the host store cannot hold
  a block, so the run falls back to the per-round loop and is the device
  store's per-round run exactly, with no family tap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed import run_federated as j_run  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed import run_federated as t_run  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))


def _families(smoke, rc, rs, lora_cls, ssm_cls):
    lora = lora_cls(**_LORA)
    dense = rc.with_overrides(name="h-dense", num_layers=2, d_model=64, num_heads=2,
                              num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=32, lora=lora)
    ssm = smoke("mamba2-130m").with_overrides(
        name="h-ssm", d_model=64, vocab_size=256, max_seq_len=32, lora=lora,
        ssm=ssm_cls(state_dim=16, head_dim=16, expand=2, chunk_size=4))
    server = rs.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192,
                               vocab_size=256, max_seq_len=32, lora=lora)
    return [dense, ssm], server


J_FAMS, J_SERVER = _families(j_smoke, J_RC, J_RS, JLoRA, JSSM)
T_FAMS, T_SERVER = _families(t_smoke, T_RC, T_RS, TLoRA, TSSM)
TO_JAX = dict(zip(T_FAMS + [T_SERVER], J_FAMS + [J_SERVER]))
EVAL, ROUNDS = 64, 3
ONE_SAMPLE = 1.0 / EVAL + 1e-9
RUNS = {  # the port's runs: name -> FedConfig changes
    "scan": dict(scan_rounds=True),
    "loop": dict(scan_rounds=False),
    "host": dict(scan_rounds=True, fleet_store="host"),
}


def _bridged_init(cfg, seed, device="cuda", **_):
    return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), TO_JAX[cfg])),
                           device)


def _fed(fed_cls, chan_cls, **kw):
    return fed_cls(**{**dict(
        method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2, rounds=ROUNDS,
        public_size=64, public_batch=16, eval_size=EVAL, local_steps=1, distill_steps=1,
        server_distill_steps=2, seed=0, pretrain_steps=0, scenario="gauss_markov",
        channel=chan_cls(bandwidth_hz=2e5, mean_snr_db=2.0)), **kw})


def _dataset(make):
    return make(vocab_size=256, seq_len=12, total=500, seed=0)


@pytest.fixture(scope="module")
def runs():
    out = {"reference": j_run(J_FAMS, J_SERVER, _dataset(j_dataset),
                              _fed(JFed, JChannel, scan_rounds=True))}
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    try:
        for name, change in RUNS.items():
            out[name] = t_run(T_FAMS, T_SERVER, _dataset(t_dataset),
                              _fed(TFed, TChannel, use_kernels=True, **change), device="cpu")
    finally:
        mp.undo()
    return out


def _integers(run):
    return (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                               for r in run.ledger.rounds])


def test_a_mixed_fleets_block_is_the_references(runs):
    ref, got = runs["reference"], runs["scan"]
    assert _integers(got) == _integers(ref)
    assert len({k for ks in got.per_client_k for k in ks}) > 2  # the budgets vary
    for key in ("server_acc", "client_acc", "family_client_acc"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key), rtol=0,
                                   atol=ONE_SAMPLE, err_msg=key)
    np.testing.assert_allclose(got.distill_loss, ref.distill_loss, rtol=1e-4)
    assert got.outage == ref.outage
    t_snr, j_snr = np.array(got.snr_db), np.array(ref.snr_db)
    np.testing.assert_array_equal(np.isneginf(t_snr), np.isneginf(j_snr))
    live = np.isfinite(j_snr)
    np.testing.assert_allclose(t_snr[live], j_snr[live], rtol=0, atol=1e-3)


def test_a_mixed_fleets_block_is_its_per_round_run(runs):
    scan, loop = runs["scan"], runs["loop"]
    assert _integers(scan) == _integers(loop)
    np.testing.assert_allclose(scan.server_acc, loop.server_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.client_acc, loop.client_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.distill_loss, loop.distill_loss, rtol=1e-4)
    assert len(scan.round_seconds) == ROUNDS
    # one accuracy a family a round, the round's first client's among them
    assert [len(row) for row in scan.family_client_acc] == [2] * ROUNDS
    assert all(c in row for c, row in zip(scan.client_acc, scan.family_client_acc))
    assert len(scan.snr_db) == ROUNDS and loop.snr_db is None and loop.family_client_acc is None


def test_a_host_store_block_falls_back_to_the_per_round_run(runs):
    host, loop = runs["host"], runs["loop"]
    assert _integers(host) == _integers(loop)
    for key in ("server_acc", "client_acc", "distill_loss", "mean_k"):
        assert getattr(host, key) == getattr(loop, key), key
    assert host.family_client_acc is None and host.snr_db is None
