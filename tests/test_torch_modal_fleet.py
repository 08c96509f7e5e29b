"""A mixed fleet of GPT-2, a VLM and an audio encoder-decoder, through the
``fed_train`` CLI of both packages and the port's engines, on the CPU.

``fed_train --families gpt2-paper,internvl2-76b,seamless-m4t-large-v2``
(each smoke config re-based onto the reduced experiment's vocabulary and
LoRA — q, v, o and the head — by the CLI's own ``family_configs``): 6
clients cycling the three families, cohorts of 3, 2 rounds of
``fused_e2e``.  Both CLIs run with the reference's vocabulary cut to 256,
the families at d 64 (GQA 4/2, 8 stub patches or frames), a 2-layer
server, the run shortened alike (no pretraining: each client draws its own
backbone) and the constrained channel of ``tests/test_hetero.py``, so k
varies by client.  The port starts from the reference's init, bridged,
and its stub frontend is the reference's draw (``_torch_modal``).

* The port's CLI record: per-client k, uplink and downlink bytes and
  transmitters the reference CLI's exactly, accuracies within one eval
  sample (1/64), the server-distill loss within rtol 1e-4 (the bounds of
  ``tests/test_torch_hetero.py``).
* The port's ``sequential``, ``batched`` and ``fused`` engines and its
  int8 wire on ``fused_e2e`` and ``fused``, on the CLI's own configs: the
  float runs' integers the reference's, accuracies within one eval
  sample; the int8 runs' integers equal to each other.
* The VLM and audio buckets are what the engines cut the fleet into, and
  each audio client's encoder adapters are trained leaves of the fleet.
* The port resumes the reference CLI's round-1 checkpoint (its audio
  clients' encoder adapters and AdamW state included) to the reference's
  round-2 record.
* ``scan_rounds`` on a mixed fleet holding a VLM in float64 still raises.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_frontend  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.launch.fed_train as j_cli  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
import repro_torch.launch.fed_train as t_cli  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.fed.engines import HeteroFusedE2EEngine  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

FAMILIES = "gpt2-paper,internvl2-76b,seamless-m4t-large-v2"
ARGV = ["--families", FAMILIES, "--engine", "fused_e2e", "--use-kernels", "--rounds", "2",
        "--clients", "6", "--per-round", "3", "--public-batch", "16"]
EVAL = 64
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
_SHORT = dict(pretrain_steps=0, server_pretrain_steps=0, public_size=64, eval_size=EVAL,
              local_steps=1, distill_steps=1, server_distill_steps=2)
# the families' widths: the smoke configs' depth at d 64
_NARROW = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, frontend_len=8)
RUNS = {  # the port's engine runs beside its CLI's: name -> FedConfig changes
    "sequential": dict(engine="sequential"),
    "batched": dict(engine="batched"),
    "fused": dict(engine="fused"),
    "fused-int8": dict(engine="fused", quantize_wire=True),
    "fused_e2e-int8": dict(quantize_wire=True),
}


def _shrink(mp, cli, chan_cls):
    mp.setattr(cli, "REDUCED_CLIENT", cli.REDUCED_CLIENT.with_overrides(vocab_size=256))
    mp.setattr(cli, "REDUCED_SERVER", cli.REDUCED_SERVER.with_overrides(
        num_layers=2, d_model=96, d_ff=192, num_heads=2, num_kv_heads=2, vocab_size=256,
        max_seq_len=32))
    mp.setattr(cli, "get_smoke_config", lambda arch, f=cli.get_smoke_config: (
        f(arch) if arch == "gpt2-paper" else f(arch).with_overrides(**_NARROW)))
    short = dict(_SHORT, channel=chan_cls(**_CHAN))
    if cli is t_cli:
        mp.setattr(cli, "fed_config", lambda args, f=cli.fed_config: dataclasses.replace(
            f(args), **short))
    else:  # the reference builds its FedConfig inline
        mp.setattr(cli, "FedConfig", lambda f=cli.FedConfig, **kw: f(**{**kw, **short}))


def _record(out_dir: str) -> dict:
    (name,) = os.listdir(out_dir)
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("modal_fleet")
    j_ckpt, t_ckpt = str(root / "j_ckpt"), str(root / "t_ckpt")
    calls, j_cfgs = {}, []
    mp = pytest.MonkeyPatch()
    try:
        for name, cli, chan in (("reference", j_cli, JChannel), ("port", t_cli, TChannel)):
            _shrink(mp, cli, chan)

            def keep(client_cfg, server_cfg, ds, fed, real=cli.run_federated, name=name, **kw):
                if name == "reference":
                    j_cfgs[:] = list(client_cfg) + [server_cfg]
                run = real(client_cfg, server_cfg, ds, fed, **kw)
                calls.setdefault(name, (list(client_cfg), server_cfg, ds, fed, run))
                return run

            mp.setattr(cli, "run_federated", keep)
        assert j_cli.main(ARGV + ["--ckpt-dir", j_ckpt, "--out", str(root / "j")]) == 0

        def bridged(cfg, seed, device="cuda", **_):
            (j_cfg,) = [c for c in j_cfgs if dataclasses.asdict(c) == dataclasses.asdict(cfg)]
            return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed),
                                                                   j_cfg)), device)

        mp.setattr(t_model, "init", bridged)
        kept, init = [], HeteroFusedE2EEngine.__init__
        mp.setattr(HeteroFusedE2EEngine, "__init__",
                   lambda self, *a, **kw: (kept.append(self), init(self, *a, **kw))[1])
        assert t_cli.main(ARGV + ["--out", str(root / "t"), "--device", "cpu"]) == 0
        fams, server, ds, fed, _ = calls["port"]
        out = {"reference": calls["reference"][-1], "port": calls["port"][-1],
               "records": (_record(str(root / "j")), _record(str(root / "t"))),
               "engine": kept[0], "families": fams}
        for name, change in RUNS.items():
            out[name] = t_rounds.run_federated(fams, server, ds, dataclasses.replace(fed, **change),
                                               device="cpu")
        # the port resumes the reference's checkpoint after round 1
        shutil.copytree(j_ckpt, t_ckpt)
        for leftover in os.listdir(t_ckpt):
            if leftover.startswith("step_00000002"):
                os.remove(os.path.join(t_ckpt, leftover))
        calls.pop("port")
        assert t_cli.main(ARGV + ["--ckpt-dir", t_ckpt, "--resume", "--out", str(root / "r"),
                                  "--device", "cpu"]) == 0
        out["resumed"] = calls["port"][-1]
        out["scan"] = (fams, server, ds, fed)
    finally:
        mp.undo()
    return out


def _integers(run):
    return (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                               for r in run.ledger.rounds])


def _accuracies_close(got, want):
    np.testing.assert_allclose(got.server_acc, want.server_acc, rtol=0, atol=1 / EVAL + 1e-9)
    np.testing.assert_allclose(got.client_acc, want.client_acc, rtol=0, atol=1 / EVAL + 1e-9)


def test_the_cli_runs_the_references_fleet(fleet):
    want, got = fleet["reference"], fleet["port"]
    assert [c.family for c in fleet["families"]] == ["dense", "vlm", "audio"]
    assert _integers(got) == _integers(want)
    assert len({k for ks in got.per_client_k for k in ks}) > 2  # the budgets vary
    _accuracies_close(got, want)
    np.testing.assert_allclose(got.distill_loss, want.distill_loss, rtol=1e-4)
    j_rec, t_rec = fleet["records"]
    assert t_rec["families"] == j_rec["families"] == FAMILIES
    for key in ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round"):
        assert t_rec[key] == j_rec[key], key


@pytest.mark.parametrize("name", ["sequential", "batched", "fused"])
def test_every_engine_runs_the_references_fleet(fleet, name):
    want, got = fleet["reference"], fleet[name]
    assert _integers(got) == _integers(want)
    _accuracies_close(got, want)


def test_the_int8_wire_agrees_across_engines(fleet):
    assert _integers(fleet["fused-int8"]) == _integers(fleet["fused_e2e-int8"]) != _integers(
        fleet["port"])


def test_the_modal_buckets_train_their_encoder_adapters(fleet):
    eng = fleet["engine"]
    assert [b.cfg.family for b in eng.buckets] == ["dense", "vlm", "audio"]
    lora = eng._engines[2]._store.lora
    enc = [k for k in lora if k.startswith("encoder/")]
    assert enc and all(k.split("/")[2] == "lora" for k in enc)
    # the fleet's B started at zero; the cohorts' audio clients trained them
    assert any(float(lora[k].abs().max()) > 0 for k in enc if k.endswith("/B"))


def test_the_port_resumes_the_references_checkpoint(fleet):
    want, got = fleet["reference"], fleet["resumed"]
    assert _integers(got) == _integers(want)
    assert got.client_acc[0] == want.client_acc[0]  # round 0 came from the checkpoint
    _accuracies_close(got, want)
    np.testing.assert_allclose(got.distill_loss[1:], want.distill_loss[1:], rtol=1e-4)


def test_scan_rounds_on_a_mixed_fleet_with_a_vlm_still_raises(fleet):
    """The block of this fleet runs (``tests/test_torch_fed_train.py``,
    ``tests/test_torch_hetero_block*.py``), in fp16 too; with its VLM family
    in a dtype the port does not take (float64) it is refused before any
    work, naming the dtypes it does take."""
    fams, server, ds, fed = fleet["scan"]
    fams = [c.with_overrides(compute_dtype="float64") if c.family == "vlm" else c for c in fams]
    with pytest.raises(ValueError, match="float32, bfloat16, float16"):
        t_rounds.run_federated(fams, server, ds, dataclasses.replace(fed, scan_rounds=True),
                               device="cpu")
