"""The port's ``fed_train`` CLI against the reference's, on the CPU.

* For the same flags both CLIs build the same ``FedConfig`` (every field)
  and hand ``run_federated`` the same models and checkpoint arguments; each
  module's ``run_federated`` is stubbed to capture them.  The port's JSON
  record has the reference's keys, and the same ``fed`` entry.
* ``--families`` with a VLM and ``--scan-rounds`` (a mixed fleet's block)
  runs and records the block's family tap; ``--resume`` without
  ``--ckpt-dir`` is a usage error in both.
* End to end on the CPU (the CLI's models shrunk to the tests' tiny
  configs): a host-store run of 2 rounds with ``--ckpt-dir`` leaves the
  fleet in shards beside the step, a device-store run resumes it to 3
  rounds, and its record equals a fresh device-store run's, round by round
  (mean k, uplink and downlink MB, accuracies, distill loss): the resume is
  exact, as within one package it is everywhere else.
* ``--shard-clients`` started without ``torch.distributed.run`` (one rank)
  writes the record of the same run without it, exactly.
* The CLI's adapters (``REDUCED_LORA``: q, v, o and the head; no attention
  layer reads the o adapter, in either package) train as in the reference:
  its gradient is zero there, where the port's raised before.
* ``--families gpt2-paper,mamba2-130m`` in both CLIs on the CPU: the
  record's integers (per-client k, bytes, transmitters) identical.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import repro.launch.fed_train as j_cli  # noqa: E402
from repro.core.protocol import CommLedger as JLedger  # noqa: E402
from repro.fed.rounds import FedRun as JRun  # noqa: E402
import repro_torch.checkpoint.ckpt as t_ckpt  # noqa: E402
import repro_torch.launch.fed_train as t_cli  # noqa: E402
from repro_torch.core.protocol import CommLedger as TLedger  # noqa: E402
from repro_torch.fed.rounds import FedRun as TRun  # noqa: E402

ARGVS = {
    "defaults": [],
    "fleet": ["--fleet-size", "64", "--fleet-store", "host", "--per-round", "4",
              "--engine", "fused_e2e", "--use-kernels"],
    "scenario-faults": ["--scenario", "gilbert_elliott", "--faults", "lossy", "--rounds", "3",
                        "--clients", "7", "--iid", "--lam", "0.05"],
    "ckpt-resume": ["--ckpt-dir", "CKPT", "--resume", "--engine", "fused", "--seed", "3"],
    "quantize": ["--quantize-wire", "--method", "zeropad", "--public-batch", "32",
                 "--full-head"],
    "bf16": ["--compute-dtype", "bfloat16", "--engine", "fused_e2e", "--scan-rounds",
             "--method", "adaptive"],
}


def _capture(module, run_cls, ledger_cls, into: dict, mp):
    """Stub ``module.run_federated``: keep its arguments, return a
    one-round record."""

    def stub(client_cfg, server_cfg, dataset, fed, **kw):
        into.update(client=client_cfg, server=server_cfg, fed=fed, kw=kw,
                    data=(len(dataset), dataset.tokens.shape, int(dataset.tokens.sum())))
        return run_cls(ledger=ledger_cls(), server_acc=[0.5], client_acc=[0.25], mean_k=[3.0],
                       distill_loss=[float("nan")])

    mp.setattr(module, "run_federated", stub)


def _record(out_dir: str) -> dict:
    (name,) = os.listdir(out_dir)
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(ARGVS))
def test_both_clis_build_the_same_fedconfig(case, tmp_path, monkeypatch):
    j_got, t_got = {}, {}
    _capture(j_cli, JRun, JLedger, j_got, monkeypatch)
    _capture(t_cli, TRun, TLedger, t_got, monkeypatch)
    argv = [str(tmp_path / "ckpt") if a == "CKPT" else a for a in ARGVS[case]]
    assert j_cli.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert t_cli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    j_fed = json.loads(json.dumps(dataclasses.asdict(j_got["fed"]), sort_keys=True, default=str))
    t_fed = json.loads(json.dumps(dataclasses.asdict(t_got["fed"]), sort_keys=True, default=str))
    assert t_fed == j_fed
    assert t_got["data"] == j_got["data"]  # the same synthetic dataset
    for role in ("client", "server"):  # the reduced GPT-2 pair, field for field
        j_cfg, t_cfg = dataclasses.asdict(j_got[role]), dataclasses.asdict(t_got[role])
        assert t_cfg == j_cfg, role
    assert t_got["kw"] == dict(j_got["kw"], device="cpu")
    j_rec, t_rec = _record(str(tmp_path / "j")), _record(str(tmp_path / "t"))
    assert t_rec.keys() == j_rec.keys()
    assert t_rec["fed"] == j_rec["fed"]
    assert t_rec["distill_loss"] == j_rec["distill_loss"] == [None]


def test_the_device_defaults_to_the_card(monkeypatch, tmp_path):
    got = {}
    _capture(t_cli, TRun, TLedger, got, monkeypatch)
    t_cli.main(["--out", str(tmp_path)])
    assert got["kw"]["device"] == "cuda"


@pytest.mark.parametrize("flag,item", [
    (["--families", "gpt2-paper,internvl2-76b", "--engine", "fused_e2e", "--scan-rounds"],
     "other model families and mixed fleets"),
])
def test_what_the_cli_does_not_carry_raises(flag, item, tmp_path, monkeypatch):
    """What this case once refused, naming its port queue ``item``, the CLI
    now runs: ``--families gpt2-paper,internvl2-76b --engine fused_e2e
    --scan-rounds`` (a mixed fleet's block, a VLM in it) on the CPU, the
    families at the tests' widths, the run shortened; the record carries
    the block's family tap, one accuracy a family a round."""
    assert item == "other model families and mixed fleets"
    monkeypatch.setattr(t_cli, "REDUCED_CLIENT", t_cli.REDUCED_CLIENT.with_overrides(
        d_model=64, d_ff=128, **_TINY))
    monkeypatch.setattr(t_cli, "REDUCED_SERVER", t_cli.REDUCED_SERVER.with_overrides(
        d_model=96, d_ff=192, **_TINY))
    monkeypatch.setattr(t_cli, "get_smoke_config", lambda arch, f=t_cli.get_smoke_config: (
        f(arch) if arch == "gpt2-paper" else f(arch).with_overrides(
            d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, frontend_len=8)))
    fed_config = t_cli.fed_config
    monkeypatch.setattr(t_cli, "fed_config", lambda args: dataclasses.replace(
        fed_config(args), pretrain_steps=0, server_pretrain_steps=0, public_size=64,
        eval_size=64, local_steps=1, distill_steps=1, server_distill_steps=1))
    argv = flag + ["--rounds", "2", "--clients", "4", "--per-round", "2", "--public-batch", "16",
                   "--out", str(tmp_path), "--device", "cpu"]
    assert t_cli.main(argv) == 0
    rec = _record(str(tmp_path))
    assert rec["fed"]["scan_rounds"] is True and rec["families"] == "gpt2-paper,internvl2-76b"
    assert [len(row) for row in rec["family_client_acc"]] == [2, 2]
    assert all(c in row for c, row in zip(rec["client_acc"], rec["family_client_acc"]))
    assert all(x is not None and math.isfinite(x) for x in rec["distill_loss"])


def test_resume_without_a_checkpoint_dir_is_a_usage_error(tmp_path):
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit):
            cli.main(["--resume", "--out", str(tmp_path)])


# -- end to end on the CPU -------------------------------------------------------------------

# the CLI's own adapters (REDUCED_LORA: q, v, o and the head; no layer reads
# the o adapter, in either package) on the tests' tiny widths
_TINY = dict(num_layers=2, num_heads=2, num_kv_heads=2, vocab_size=256, max_seq_len=32)
COMMON = ["--engine", "fused_e2e", "--use-kernels", "--fleet-size", "6", "--per-round", "2",
          "--public-batch", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Host store for 2 rounds, a device store resuming it to 3, and a fresh
    device-store run of 3; the CLI's models at the tests' tiny widths and its
    pretraining cut to 2 steps each."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_cli, "REDUCED_CLIENT", t_cli.REDUCED_CLIENT.with_overrides(
        d_model=64, d_ff=128, **_TINY))
    mp.setattr(t_cli, "REDUCED_SERVER", t_cli.REDUCED_SERVER.with_overrides(
        d_model=96, d_ff=192, **_TINY))
    fed_config = t_cli.fed_config
    mp.setattr(t_cli, "fed_config", lambda args: dataclasses.replace(
        fed_config(args), pretrain_steps=2, server_pretrain_steps=2, public_size=128,
        eval_size=64, local_steps=1, distill_steps=1, server_distill_steps=2))
    root = tmp_path_factory.mktemp("cli")
    ckpt, out = str(root / "ckpt"), {}
    had_group = torch.distributed.is_initialized()
    try:
        for name, extra in (
            ("host", ["--fleet-store", "host", "--rounds", "2", "--ckpt-dir", ckpt]),
            ("resumed", ["--fleet-store", "device", "--rounds", "3", "--ckpt-dir", ckpt,
                         "--resume"]),
            ("fresh", ["--fleet-store", "device", "--rounds", "3"]),
            # started without torch.distributed.run: a group of one rank
            ("sharded", ["--fleet-store", "device", "--rounds", "3", "--shard-clients"]),
        ):
            assert t_cli.main(COMMON + extra + ["--out", str(root / name)]) == 0
            out[name] = _record(str(root / name))
    finally:
        mp.undo()
        if torch.distributed.is_initialized() and not had_group:
            torch.distributed.destroy_process_group()  # the sharded run's one-rank group
    out["ckpt"] = ckpt
    return out


def test_a_host_store_checkpoint_is_in_shards(cli_runs):
    ckpt = cli_runs["ckpt"]
    shard_dir = t_ckpt.fleet_shard_dir(ckpt, 2)
    assert sorted(os.listdir(shard_dir)) == ["fleet_00000000_00000006.npz", "fleet_frozen.npz"]
    assert t_ckpt.step_metadata(ckpt, 2)["fleet_sharded"] is True
    # the device store's step after the resume holds its fleet in the npz
    assert not t_ckpt.step_metadata(ckpt, 3).get("fleet_sharded")
    assert cli_runs["host"]["fed"]["fleet_store"] == "host"


def test_a_cross_store_resume_is_the_fresh_run(cli_runs):
    resumed, fresh = cli_runs["resumed"], cli_runs["fresh"]
    for key in ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round", "server_acc",
                "client_acc", "distill_loss"):
        assert resumed[key] == fresh[key], key
        assert len(fresh[key]) == 3
        assert resumed[key][:2] == cli_runs["host"][key], key
    assert all(x is not None and math.isfinite(x) for x in fresh["distill_loss"])
    assert resumed["summary"] == fresh["summary"]
    assert np.isfinite(fresh["summary"]["total_mb"]) and fresh["summary"]["rounds"] == 3.0


def test_shard_clients_on_one_rank_is_the_unsharded_run(cli_runs):
    """``--shard-clients`` at world size 1: the cohort is one rank's block
    and the gather a copy, so the record is the unsharded run's exactly."""
    sharded, fresh = cli_runs["sharded"], cli_runs["fresh"]
    assert sharded["fed"]["shard_clients"] is True and fresh["fed"]["shard_clients"] is False
    for key in ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round", "server_acc",
                "client_acc", "distill_loss"):
        assert sharded[key] == fresh[key], key


# -- the CLI's adapters against the reference ---------------------------------------------------


def test_the_clis_adapters_train_as_in_the_reference():
    """REDUCED_LORA puts an adapter on ``o``, which no attention layer reads
    in either package: JAX's gradient of it is zero, and so is the port's
    (it raised before).  Two rounds of ``fused_e2e`` with those adapters,
    pretraining included, on the tiny widths with the bridged JAX init:
    integers identical, accuracies within one eval sample, the distill loss
    within rtol 1e-4 (``test_torch_round.py``'s bounds)."""
    import jax

    import repro.fed.rounds as j_rounds
    from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC
    from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS
    from repro.data import make_banking77_like as j_dataset
    from repro.fed import FedConfig as JFed
    from repro.models import init as j_init
    import repro_torch.fed.rounds as t_rounds
    from repro_torch import bridge
    from repro_torch.data import make_banking77_like as t_dataset
    from repro_torch.fed import FedConfig as TFed
    from repro_torch.models import model as t_model

    assert "o" in t_cli.REDUCED_CLIENT.lora.targets
    sizes = {"client": dict(d_model=64, d_ff=128, **_TINY), "server": dict(d_model=96, d_ff=192, **_TINY)}
    j_cfg = {"client": J_RC.with_overrides(**sizes["client"]), "server": J_RS.with_overrides(**sizes["server"])}
    t_cfg = {"client": t_cli.REDUCED_CLIENT.with_overrides(**sizes["client"]),
             "server": t_cli.REDUCED_SERVER.with_overrides(**sizes["server"])}

    def bridged(cfg, seed, device="cuda", **_):
        role = "client" if cfg == t_cfg["client"] else "server"
        return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), j_cfg[role])),
                               device)

    kw = dict(method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2, rounds=2,
              public_size=64, public_batch=16, eval_size=64, local_steps=1, distill_steps=1,
              server_distill_steps=2, seed=0, pretrain_steps=2, server_pretrain_steps=2)
    want = j_rounds.run_federated(j_cfg["client"], j_cfg["server"],
                                  j_dataset(vocab_size=256, seq_len=12, total=500, seed=0), JFed(**kw))
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", bridged)
    try:
        got = t_rounds.run_federated(t_cfg["client"], t_cfg["server"],
                                     t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                                     TFed(**kw), device="cpu")
    finally:
        mp.undo()
    assert got.per_client_k == want.per_client_k
    for t, j in zip(got.ledger.rounds, want.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes, t.num_transmitters) == (
            j.uplink_bytes, j.downlink_bytes, j.num_transmitters)
    one_sample = 1.0 / 64 + 1e-9
    np.testing.assert_allclose(got.server_acc, want.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.client_acc, want.client_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.distill_loss, want.distill_loss, rtol=1e-4)


def test_fed_train_families_with_an_ssm_is_the_reference_clis(tmp_path):
    """``fed_train --families gpt2-paper,mamba2-130m`` (the reference CLI's
    own mixed-fleet example: a dense GPT-2 family beside an attention-free
    one, whose eq. 8 projection comes from its head adapter) in both CLIs on
    the CPU, the reduced experiment's vocabulary cut to the tests' 256 and
    the run shortened alike; the port starts from the reference's init,
    bridged.  The record's integers — per-client k, uplink and downlink
    bytes and transmitters a round — are the reference CLI's exactly."""
    import jax

    from repro.models import init as j_init
    from repro_torch import bridge
    from repro_torch.models import model as t_model

    argv = ["--families", "gpt2-paper,mamba2-130m", "--engine", "fused_e2e", "--use-kernels",
            "--rounds", "2", "--clients", "4", "--per-round", "2", "--public-batch", "16"]
    runs, j_cfgs = {}, []
    short = dict(pretrain_steps=1, server_pretrain_steps=1, public_size=64, eval_size=64,
                 local_steps=1, distill_steps=1, server_distill_steps=1)
    mp = pytest.MonkeyPatch()
    try:
        for name, cli in (("reference", j_cli), ("port", t_cli)):
            mp.setattr(cli, "REDUCED_CLIENT", cli.REDUCED_CLIENT.with_overrides(vocab_size=256))
            mp.setattr(cli, "REDUCED_SERVER", cli.REDUCED_SERVER.with_overrides(
                num_layers=2, d_model=96, d_ff=192, **{k: v for k, v in _TINY.items()
                                                       if k != "num_layers"}))
            if cli is t_cli:
                mp.setattr(cli, "fed_config", lambda args, f=cli.fed_config: dataclasses.replace(
                    f(args), **short))
            else:  # the reference builds its FedConfig inline
                mp.setattr(cli, "FedConfig", lambda f=cli.FedConfig, **kw: f(**{**kw, **short}))

            def keep(client_cfg, server_cfg, ds, fed, real=cli.run_federated, name=name, **kw):
                if name == "reference":
                    j_cfgs.extend(list(client_cfg) + [server_cfg])
                runs[name] = real(client_cfg, server_cfg, ds, fed, **kw)
                return runs[name]

            mp.setattr(cli, "run_federated", keep)
        assert j_cli.main(argv + ["--out", str(tmp_path / "j")]) == 0

        def bridged(cfg, seed, device="cuda", **_):
            (j_cfg,) = [c for c in j_cfgs if dataclasses.asdict(c) == dataclasses.asdict(cfg)]
            return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed),
                                                                   j_cfg)), device)

        mp.setattr(t_model, "init", bridged)
        assert t_cli.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    finally:
        mp.undo()
    assert [c.family for c in j_cfgs[:2]] == ["dense", "ssm"]
    want, got = runs["reference"], runs["port"]
    assert got.per_client_k == want.per_client_k and len(got.per_client_k) == 2
    assert [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters) for r in got.ledger.rounds] \
        == [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters) for r in want.ledger.rounds]
    j_rec, t_rec = _record(str(tmp_path / "j")), _record(str(tmp_path / "t"))
    assert t_rec["families"] == j_rec["families"] == "gpt2-paper,mamba2-130m"
    for key in ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round"):
        assert t_rec[key] == j_rec[key], key
