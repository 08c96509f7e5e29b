"""The port's mixed-family fleets against the JAX reference, on the CPU: the
family buckets, the union wire, the family-bucketed engines and the
``fed_train --families`` CLI.

The fleet is ``[yi smoke, granite smoke]`` re-based as ``fed_train``'s
``family_configs`` re-bases a family (one vocabulary, one LoRA rank), at
the widths of ``tests/test_hetero.py`` (d 64, vocab 256; the server a
2-layer GPT-2 at d 96): a dense Llama-style family (RoPE, RMSNorm,
SwiGLU, GQA 8/2) beside a MoE one (4 experts, top-2), 5 clients, cohorts
of 3, the constrained channel of ``tests/test_hetero.py`` so k varies by
client.  Both packages start from the reference's init, bridged.

* The reference runs ``fused_e2e`` once; its sequential engine is held
  to it by the reference's own ``tests/test_hetero.py`` (identical k and
  bytes, accuracies at 1e-6), so the port's ``sequential`` and
  ``fused_e2e`` are both held to that run: per-client k, uplink and
  downlink bytes and transmitters identical, accuracies within one eval
  sample (1/64), and the e2e server-distill loss within rtol 1e-4.
* The port's four engines agree among themselves on those integers, on
  the float and the int8 wire, and the host fleet store is the device
  store's run exactly; a host-store checkpoint (one ``bucket{i}`` shard
  set a family) resumes under the device store to the uninterrupted run.
* The union wire of two buckets with different ``k_cap``: the
  reference's ``concat_wires``/``take_wire_rows`` entry for entry, and its
  aggregation ``torch.equal`` to the same rows sparsified at the wide
  ``k_cap`` (the padding is masked zeros at index 0, which the sums skip).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.fed_train as j_cli  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core.topk import concat_wires as j_concat  # noqa: E402
from repro.core.topk import sparsify_wire as j_sparsify  # noqa: E402
from repro.core.topk import take_wire_rows as j_take  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed import run_federated as j_run  # noqa: E402
from repro.fed.client import Client as JClient  # noqa: E402
from repro.fed.cohort import fleet_index as j_fleet_index  # noqa: E402
from repro.fed.cohort import partition_fleet as j_partition  # noqa: E402
from repro.fed.cohort import split_cohort as j_split  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.launch.fed_train as t_cli  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.aggregation import aggregate_wire  # noqa: E402
from repro_torch.core.topk import concat_wires, sparsify_wire, take_wire_rows  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed import run_federated as t_run  # noqa: E402
from repro_torch.fed.client import Client as TClient  # noqa: E402
from repro_torch.fed.cohort import (  # noqa: E402
    fleet_index, partition_fleet, split_cohort, validate_family_contracts,
)
from repro_torch.fed.engines import HeteroFusedE2EEngine, make_engine  # noqa: E402
from repro_torch.fed.server import Server as TServer  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_W = dict(num_layers=2, d_model=64, vocab_size=256, max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)


def _families(smoke, lora):
    return [smoke("yi-9b").with_overrides(name="fam-yi-9b", d_ff=128, lora=lora(**_LORA), **_W),
            smoke("granite-moe-1b-a400m").with_overrides(name="fam-granite-moe-1b-a400m",
                                                         lora=lora(**_LORA), **_W)]


J_FAMS, T_FAMS = _families(j_smoke, JLoRA), _families(t_smoke, TLoRA)
J_SERVER, T_SERVER = J_RS.with_overrides(**_S, lora=JLoRA(**_LORA)), T_RS.with_overrides(
    **_S, lora=TLoRA(**_LORA))
TO_JAX = {T_FAMS[0]: J_FAMS[0], T_FAMS[1]: J_FAMS[1], T_SERVER: J_SERVER}
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
EVAL = 64


def _bridged_init(cfg, seed, device="cuda", **_):
    return bridge.to_torch(jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), TO_JAX[cfg])),
                           device)


def _fed(fed_cls, chan_cls, engine, **kw):
    return fed_cls(**{**dict(
        method="adald", engine=engine, num_clients=5, clients_per_round=3, rounds=2,
        public_size=64, public_batch=16, eval_size=EVAL, local_steps=2, distill_steps=1,
        server_distill_steps=2, seed=0, pretrain_steps=0, use_kernels=True,
        channel=chan_cls(**_CHAN)), **kw})


def _dataset(make):
    return make(vocab_size=256, seq_len=12, total=500, seed=0)


RUNS = {  # the port's runs: name -> (engine, FedConfig changes)
    "sequential": ("sequential", {}),
    "batched": ("batched", {}),
    "fused": ("fused", {}),
    "fused_e2e": ("fused_e2e", {}),
    "fused-int8": ("fused", dict(quantize_wire=True)),
    "fused_e2e-int8": ("fused_e2e", dict(quantize_wire=True)),
    "fused_e2e-host": ("fused_e2e", dict(fleet_store="host")),
}


@pytest.fixture(scope="module")
def runs():
    out = {"reference": j_run(J_FAMS, J_SERVER, _dataset(j_dataset),
                              _fed(JFed, JChannel, "fused_e2e"))}
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    try:
        for name, (engine, change) in RUNS.items():
            out[name] = t_run(T_FAMS, T_SERVER, _dataset(t_dataset),
                              _fed(TFed, TChannel, engine, **change), device="cpu")
    finally:
        mp.undo()
    return out


def _integers(run):
    return (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                               for r in run.ledger.rounds])


@pytest.mark.parametrize("name", ["sequential", "fused_e2e"])
def test_a_mixed_fleet_is_the_references(runs, name):
    ref, got = runs["reference"], runs[name]
    assert _integers(got) == _integers(ref)
    assert len({k for ks in got.per_client_k for k in ks}) > 2  # the budgets vary
    np.testing.assert_allclose(got.server_acc, ref.server_acc, rtol=0, atol=1 / EVAL + 1e-9)
    np.testing.assert_allclose(got.client_acc, ref.client_acc, rtol=0, atol=1 / EVAL + 1e-9)
    if name == "fused_e2e":
        np.testing.assert_allclose(got.distill_loss, ref.distill_loss, rtol=1e-4)


@pytest.mark.parametrize("name", ["batched", "fused", "fused_e2e-int8", "fused_e2e-host"])
def test_the_port_engines_agree_on_a_mixed_fleet(runs, name):
    """Every engine gives the sequential engine's integers (the int8 wire
    its own, the same on every engine that carries it); the host store is
    the device store's run exactly."""
    if name.endswith("-int8"):
        assert _integers(runs["fused-int8"]) == _integers(runs[name]) != _integers(
            runs["fused_e2e"])
    else:
        assert _integers(runs[name]) == _integers(runs["sequential"])
    if name == "fused_e2e-host":
        got, want = runs[name], runs["fused_e2e"]
        for key in ("server_acc", "client_acc", "distill_loss", "mean_k"):
            assert getattr(got, key) == getattr(want, key), key
    else:  # within one eval sample of the sequential engine
        np.testing.assert_allclose(runs[name].server_acc, runs["sequential"].server_acc,
                                   rtol=0, atol=1 / EVAL + 1e-9)


def test_a_mixed_fleet_resumes_from_bucket_shards(tmp_path, monkeypatch):
    """A host-store checkpoint of a mixed fleet keeps each bucket's fleet in
    ``bucket{i}_*`` shards; resumed under the device store it gives the
    uninterrupted run exactly."""
    from repro_torch.checkpoint import ckpt as ckpt_io

    monkeypatch.setattr(t_model, "init", _bridged_init)
    fed = lambda **kw: _fed(TFed, TChannel, "fused_e2e", pretrain_steps=1,  # noqa: E731
                            server_pretrain="none", **kw)
    ds, ckpt = _dataset(t_dataset), str(tmp_path)
    fresh = t_run(T_FAMS, T_SERVER, ds, fed(rounds=3), device="cpu")
    t_run(T_FAMS, T_SERVER, ds, fed(rounds=2, fleet_store="host"), device="cpu", ckpt_dir=ckpt)
    shards = sorted(os.listdir(ckpt_io.fleet_shard_dir(ckpt, 2)))
    assert {name.split("_")[0] for name in shards} == {"bucket0", "bucket1"}, shards
    resumed = t_run(T_FAMS, T_SERVER, ds, fed(rounds=3), device="cpu", ckpt_dir=ckpt,
                    resume=True)
    assert _integers(resumed) == _integers(fresh)
    for key in ("server_acc", "client_acc", "distill_loss", "mean_k"):
        assert getattr(resumed, key) == getattr(fresh, key), key


# -- the buckets ----------------------------------------------------------------------------


def _fleets(n: int, shared: bool = False):
    """``n`` clients cycling the two families in each package (a shared
    backbone per family with ``shared``)."""
    ds_j, ds_t = _dataset(j_dataset), _dataset(t_dataset)
    backbones = {}
    if shared:
        for cfg in T_FAMS:
            backbones[cfg] = t_model.init(cfg, 7, "cpu")
    j_clients = [JClient(i, J_FAMS[i % 2], ds_j.subset(np.arange(i * 40, (i + 1) * 40)),
                         num_classes=ds_j.num_classes, seed=i) for i in range(n)]
    t_clients = [TClient(i, T_FAMS[i % 2], ds_t.subset(np.arange(i * 40, (i + 1) * 40)),
                         num_classes=ds_t.num_classes, seed=i, device="cpu",
                         initial_params=backbones.get(T_FAMS[i % 2])) for i in range(n)]
    return j_clients, t_clients


def test_the_fleet_buckets_are_the_references():
    j_clients, t_clients = _fleets(5)
    j_b, t_b = j_partition(j_clients), partition_fleet(t_clients)
    assert [(b.cfg.name, b.client_ids, b.shared_backbone) for b in t_b] == [
        (b.cfg.name, b.client_ids, b.shared_backbone) for b in j_b] == [
        ("fam-yi-9b", (0, 2, 4), False), ("fam-granite-moe-1b-a400m", (1, 3), False)]
    assert fleet_index(t_b) == j_fleet_index(j_b)
    for sel in ([3, 0, 4], [1, 3], [2]):
        assert [(b.index, p, loc) for b, p, loc in split_cohort(t_b, sel)] == [
            (b.index, p, loc) for b, p, loc in j_split(j_b, sel)]
    # one backbone per family: each bucket stores it once
    assert all(b.shared_backbone for b in partition_fleet(_fleets(4, shared=True)[1]))


def test_the_family_contracts_fail_fast():
    _, clients = _fleets(2)
    buckets = partition_fleet(clients)
    validate_family_contracts(buckets, server_cfg=T_SERVER)
    with pytest.raises(ValueError, match="vocab"):
        validate_family_contracts(buckets, server_cfg=T_SERVER.with_overrides(vocab_size=512))
    with pytest.raises(ValueError, match="rank"):
        validate_family_contracts(buckets, server_cfg=T_SERVER.with_overrides(
            lora=TLoRA(**dict(_LORA, rank=8))))
    # the reference's own refusal: the hetero e2e engine places no client axis
    server = TServer(T_SERVER, seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match="shard_clients is not supported"):
        make_engine("fused_e2e", clients, T_FAMS[0], server=server, num_classes=8,
                    shard_clients=True)
    engine = make_engine("fused_e2e", _fleets(2)[1], T_FAMS[0], server=server, num_classes=8)
    assert isinstance(engine, HeteroFusedE2EEngine)
    # the mixed fleet's block runs (an empty one here: tests/test_torch_hetero_block*.py
    # run real ones); on a host store it is the reference's refusal
    traj = engine.run_rounds([], [], [], adaptive_k=True, send_h=True)
    assert traj.ks == [] and traj.family_client_acc is None
    hosted = make_engine("fused_e2e", _fleets(2)[1], T_FAMS[0], server=server, num_classes=8,
                         fleet_store="host")
    with pytest.raises(RuntimeError, match="fleet_store='device'"):
        hosted.run_rounds([[0, 1]], [], [], adaptive_k=True, send_h=True)


# -- the union wire -------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_the_union_wire_is_the_references(quantize):
    rng = np.random.default_rng(9)
    logits = [rng.normal(size=(n, 5, 64)).astype(np.float32) for n in (2, 3)]
    ks = [np.array([3, 0], np.int32), np.array([9, 1, 16], np.int32)]
    caps = (4, 16)
    t_wires = [sparsify_wire(torch.as_tensor(x), torch.as_tensor(k), cap, quantize=quantize)
               for x, k, cap in zip(logits, ks, caps)]
    j_wires = [j_sparsify(jnp.asarray(x), jnp.asarray(k), cap, quantize=quantize)
               for x, k, cap in zip(logits, ks, caps)]
    order = [3, 0, 4, 1, 2]  # cohort positions of the concatenated rows
    inv = np.argsort(order)
    got, want = take_wire_rows(concat_wires(t_wires), inv), j_take(j_concat(j_wires), inv)
    assert type(got).__name__ == type(want).__name__ and got.vocab == want.vocab == 64
    for field in want._fields:
        if field != "vocab":
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
    # the padding is masked zeros at index 0: the union aggregates as the same
    # rows sparsified at the union's k_cap
    wide = take_wire_rows(concat_wires([
        sparsify_wire(torch.as_tensor(x), torch.as_tensor(k), 16, quantize=quantize)
        for x, k in zip(logits, ks)]), inv)
    assert got.k_cap == wide.k_cap == 16
    assert not torch.equal(got.indices, wide.indices)
    for mode in ("adaptive", "zeropad"):
        assert torch.equal(aggregate_wire(got, mode), aggregate_wire(wide, mode))


# -- the CLI --------------------------------------------------------------------------------


def test_fed_train_families_runs_a_mixed_fleet(tmp_path, monkeypatch):
    """``fed_train --families yi-9b,granite-moe-1b-a400m --device cpu``: the
    reference's ``family_configs`` field for field, and a round of the
    mixed fleet end to end (the CLI's reduced pair and pretraining cut to
    the tests' sizes)."""
    assert [dataclasses.asdict(c) for c in t_cli.family_configs("yi-9b,granite-moe-1b-a400m", 24)] \
        == [dataclasses.asdict(c) for c in j_cli.family_configs("yi-9b,granite-moe-1b-a400m", 24)]
    tiny = dict(vocab_size=256, max_seq_len=32, lora=TLoRA(**_LORA))
    monkeypatch.setattr(t_cli, "REDUCED_CLIENT", t_cli.REDUCED_CLIENT.with_overrides(**tiny))
    monkeypatch.setattr(t_cli, "REDUCED_SERVER", T_SERVER)
    fed_config = t_cli.fed_config
    monkeypatch.setattr(t_cli, "fed_config", lambda args: dataclasses.replace(
        fed_config(args), pretrain_steps=1, server_pretrain_steps=1, public_size=64,
        eval_size=64, local_steps=1, distill_steps=1, server_distill_steps=1))
    argv = ["--families", "yi-9b,granite-moe-1b-a400m", "--engine", "fused_e2e", "--rounds", "1",
            "--clients", "4", "--per-round", "2", "--public-batch", "16", "--device", "cpu",
            "--out", str(tmp_path)]
    assert t_cli.main(argv) == 0
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        rec = json.load(f)
    assert rec["families"] == "yi-9b,granite-moe-1b-a400m" and len(rec["server_acc"]) == 1
    assert np.isfinite(rec["summary"]["total_mb"]) and rec["distill_loss"][0] is not None
