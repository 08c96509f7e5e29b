"""The port's checkpoints against the JAX reference, on the CPU.

* The npz layout: a parameter tree, an AdamW state and a bf16 leaf saved by
  each package give the same keys and the same bytes; each package
  restores the other's file (a bf16 leaf as its bits: the reference itself
  cannot cast them back, the port can; an fp16 leaf is ``<f2`` and
  round-trips both ways); a leaf that does not line up (an
  AdamW count on the port's client axis, a master the file lacks) is
  refused naming its key, both ways; ``latest_step`` skips a torn file;
  the resume fingerprint's JSON is the reference's.
* Kill and resume in the port: a run checkpointed after round 1 and
  resumed to 3 rounds equals the uninterrupted run bitwise — integers,
  accuracies, distill losses, fault and channel taps, ledger and the final
  parameters — on ``batched`` and ``fused_e2e`` round by round, on
  ``fused_e2e`` as a ``scan_rounds`` block resumed at the block boundary
  (with a Gilbert-Elliott channel and ``faults="lossy"``), and with
  pretraining on.
* Across packages, on ``fused_e2e`` with ``faults="lossy"`` (one
  ``FedConfig``, field for field, ``use_kernels=False`` on both sides): a
  checkpoint the reference wrote after round 1 resumes in the port (also
  one of the reference's host fleet store, whose fleet is in shards beside
  the step: the fingerprint leaves the store out), and one the port wrote
  resumes in the reference; each reproduces the reference's
  uninterrupted run with integers and fault taps identical, accuracies
  within one eval sample and the distill loss within rtol 1e-4
  (``tests/test_torch_round.py``'s bounds: the packages compute the same
  rounds from the same state).
* The reference's refusals: a fingerprint mismatch, ``completed >=
  rounds``, ``resume`` without ``ckpt_dir``.
* Serving from a checkpoint: ``MonolithicSource``, ``ShardDirSource`` and
  ``export_adapters(ckpt_dir)`` decode the tokens the live store's
  adapters decode.
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

import repro.checkpoint.ckpt as j_ckpt  # noqa: E402
import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core.faults import FAULTS as J_FAULTS  # noqa: E402
from repro.core.scenario import get_scenario as j_get_scenario  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed.steps import init_lora_opt as j_init_lora_opt  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.optim import AdamWState as JAdam  # noqa: E402
import repro_torch.checkpoint.ckpt as t_ckpt  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.faults import FAULTS as T_FAULTS  # noqa: E402
from repro_torch.core.scenario import get_scenario as t_get_scenario  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.engines.base import one_model_opt  # noqa: E402
from repro_torch.fed.steps import init_lora_opt as t_init_lora_opt  # noqa: E402
from repro_torch.lora import lora_template, split_lora  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.optim import AdamWState as TAdam  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdapterCache,
    ServeConfig,
    ServeSession,
    export_adapters,
    serving_params,
)
from repro_torch.serve.export import FleetStoreSource, MonolithicSource, ShardDirSource  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
EVAL_SIZE = 64


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(autouse=True, scope="module")
def bridged():
    """The bridged JAX init for the whole module: both packages start from
    the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    yield
    mp.undo()


# -- the npz layout --------------------------------------------------------------


def _trees():
    """One state in both packages' forms: a model's parameters, its AdamW
    state (a count of shape ()) and a bf16 leaf."""
    j_params = j_init(jax.random.PRNGKey(3), J_CLIENT)
    j_opt = j_init_lora_opt(j_params, J_CLIENT)
    j_opt = j_opt._replace(count=jnp.asarray(7, jnp.int32),
                           m=jax.tree.map(lambda x: x + 0.5, j_opt.m))
    half = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    j_tree = {"params": j_params, "opt": j_opt, "half": jnp.asarray(half, jnp.bfloat16)}
    t_params = bridge.to_torch(jax.tree.map(np.asarray, j_params), "cpu")
    t_opt = one_model_opt(t_init_lora_opt(t_params, T_CLIENT))
    t_opt = t_opt._replace(count=torch.tensor(7, dtype=torch.int32),
                           m={k: v + 0.5 for k, v in t_opt.m.items()})
    t_tree = {"params": t_params, "opt": t_opt,
              "half": torch.as_tensor(half).to(torch.bfloat16)}
    return j_tree, t_tree


def test_both_packages_write_the_same_npz(tmp_path):
    j_tree, t_tree = _trees()
    j_ckpt.save(str(tmp_path / "j.npz"), j_tree, metadata={"step": 1})
    t_ckpt.save(str(tmp_path / "t.npz"), t_tree, metadata={"step": 1})
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        assert "opt__count" in t.files and "opt__m__stack__pos0__lora__q__A" in t.files
        assert not any(k.startswith("opt__master") for k in t.files)  # master None: no key
        for key in j.files:
            assert t[key].dtype == j[key].dtype and t[key].shape == j[key].shape, key
            assert t[key].tobytes() == j[key].tobytes(), key
        assert t["half"].dtype == np.dtype("V2")  # the bf16 bits, as the reference writes them
    assert t_ckpt.step_metadata(str(tmp_path), 1) is None  # not a step file
    with open(tmp_path / "t.npz.meta.json") as f:
        assert f.read() == '{"step": 1}'


def test_each_package_restores_the_others_file(tmp_path):
    j_tree, t_tree = _trees()
    j_ckpt.save(str(tmp_path / "j.npz"), j_tree)
    t_ckpt.save(str(tmp_path / "t.npz"), t_tree)
    zero = lambda t: torch.zeros_like(t)  # noqa: E731
    like = {"params": {k: zero(v) for k, v in t_tree["params"].items()},
            "opt": TAdam(*(None if f is None else ({k: zero(v) for k, v in f.items()}
                                                   if isinstance(f, dict) else zero(f))
                           for f in t_tree["opt"])),
            "half": zero(t_tree["half"])}
    got = t_ckpt.restore(str(tmp_path / "j.npz"), like)
    for key, want in bridge.flatten({"params": t_tree["params"], "opt": t_tree["opt"]._asdict(),
                                     "half": t_tree["half"]}).items():
        have = bridge.flatten({"params": got["params"], "opt": got["opt"]._asdict(),
                               "half": got["half"]})[key]
        assert have.dtype == want.dtype and torch.equal(have, want), key
    # the reference restores the port's file (all but the bf16 leaf, which
    # it cannot cast back from its own format either)
    j_like = {"params": j_tree["params"], "opt": j_tree["opt"]}
    back = j_ckpt.restore(str(tmp_path / "t.npz"), jax.tree.map(jnp.zeros_like, j_like))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_like)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        j_ckpt.restore(str(tmp_path / "t.npz"), {"half": j_tree["half"]})


@pytest.mark.parametrize("direction", ["port-reads-reference", "reference-reads-port"])
def test_an_fp16_leaf_round_trips_between_the_packages(tmp_path, direction):
    """An fp16 leaf (and an fp16 model's parameters) is ``<f2`` in the npz
    of either package, unlike bf16's bits, so each package restores the
    other's fp16 leaves exactly, subnormals, +-0, 65 504 and +-inf included."""
    vals = np.array([0.0, -0.0, 2.0**-24, -(2.0**-20), 1.5, -3.25, 65504.0, np.inf, -np.inf],
                    dtype=np.float16)
    j_params = j_init(jax.random.PRNGKey(4), J_CLIENT.with_overrides(param_dtype="float16"))
    j_tree = {"params": j_params, "h": jnp.asarray(vals)}
    t_tree = {"params": bridge.to_torch(jax.tree.map(np.asarray, j_params), "cpu"),
              "h": torch.as_tensor(vals)}
    assert all(v.dtype == torch.float16 for v in t_tree["params"].values())
    if direction == "port-reads-reference":
        j_ckpt.save(str(tmp_path / "c.npz"), j_tree)
        like = {"params": {k: torch.zeros_like(v) for k, v in t_tree["params"].items()},
                "h": torch.zeros_like(t_tree["h"])}
        got = t_ckpt.restore(str(tmp_path / "c.npz"), like)
        want = bridge.flatten(t_tree)
        for key, have in bridge.flatten(got).items():
            assert have.dtype == torch.float16 and torch.equal(have, want[key]), key
        assert torch.equal(torch.signbit(got["h"]), torch.signbit(t_tree["h"]))  # -0 kept
    else:
        t_ckpt.save(str(tmp_path / "c.npz"), t_tree)
        back = j_ckpt.restore(str(tmp_path / "c.npz"), jax.tree.map(jnp.zeros_like, j_tree))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_tree)):
            assert a.dtype == jnp.float16
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    with np.load(tmp_path / "c.npz") as f:
        assert f["h"].dtype == np.dtype("<f2")


def test_a_host_skeleton_restores_on_the_host(tmp_path):
    """A tree on another device (``meta`` stands in for the card) restores
    through its host skeleton to CPU tensors of its shapes and dtypes, the
    bf16 leaf included, each in storage of its own."""
    _, t_tree = _trees()
    t_ckpt.save(str(tmp_path / "t.npz"), t_tree)
    on_meta = t_ckpt._rebuild(t_tree, (), lambda _parts, leaf: leaf.to("meta"))
    got = t_ckpt.restore(str(tmp_path / "t.npz"), t_ckpt.host_skeleton(on_meta))
    want = bridge.flatten({"params": t_tree["params"], "opt": t_tree["opt"]._asdict(),
                           "half": t_tree["half"]})
    have = bridge.flatten({"params": got["params"], "opt": got["opt"]._asdict(),
                           "half": got["half"]})
    assert have.keys() == want.keys()
    for key, w in want.items():
        assert have[key].device.type == "cpu" and have[key].dtype == w.dtype, key
        assert torch.equal(have[key], w), key
    assert len({t.untyped_storage().data_ptr() for t in have.values()}) == len(have)


@pytest.mark.parametrize("direction", ["port-reads-reference", "reference-reads-port"])
def test_a_leaf_that_does_not_line_up_is_refused(tmp_path, direction):
    """The port's optimizer count carries a client axis of 1 in memory, the
    reference's is a scalar: the checkpoint holds the reference's shape,
    and a reader asking for another shape, or for a master the file does
    not hold, is refused with the key named."""
    j_tree, t_tree = _trees()
    path = str(tmp_path / "c.npz")
    if direction == "port-reads-reference":
        j_ckpt.save(path, {"opt": j_tree["opt"]})
        axis = {"opt": t_tree["opt"]._replace(count=torch.zeros(1, dtype=torch.int32))}
        with pytest.raises(ValueError, match="'opt__count' has shape"):
            t_ckpt.restore(path, axis)
        master = {"opt": t_tree["opt"]._replace(master=dict(t_tree["opt"].m))}
        with pytest.raises(ValueError, match="no entry for 'opt__master__"):
            t_ckpt.restore(path, master)
    else:
        t_ckpt.save(path, {"opt": t_tree["opt"]})
        axis = {"opt": j_tree["opt"]._replace(count=jnp.zeros((1,), jnp.int32))}
        with pytest.raises(ValueError, match="'opt__count' has shape"):
            j_ckpt.restore(path, axis)
        master = {"opt": JAdam(m=j_tree["opt"].m, v=j_tree["opt"].v, count=j_tree["opt"].count,
                               master=j_tree["opt"].m)}
        with pytest.raises(ValueError, match="no entry for 'opt__master__"):
            j_ckpt.restore(path, master)


def test_latest_step_skips_a_torn_file(tmp_path):
    for step in (1, 2):
        t_ckpt.save_step(str(tmp_path), step, {"x": torch.full((2,), float(step))}, note=step)
    (tmp_path / "step_00000003.npz").write_bytes(b"PK\x03\x04 torn")
    assert t_ckpt.latest_step(str(tmp_path)) == j_ckpt.latest_step(str(tmp_path)) == 2
    assert t_ckpt.step_metadata(str(tmp_path), 2) == j_ckpt.step_metadata(str(tmp_path), 2) == {
        "step": 2, "note": 2}
    tree, step = t_ckpt.restore_step(str(tmp_path), {"x": torch.zeros(2)})
    assert step == 2 and torch.equal(tree["x"], torch.full((2,), 2.0))
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # no temp file left behind
    assert t_ckpt.latest_step(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("scenario,faults", [
    (None, None), ("gilbert_elliott", "lossy"),
    (t_get_scenario("jakes"), T_FAULTS["bursty"]),
], ids=["plain", "preset-names", "preset-objects"])
def test_fingerprint_is_the_references(scenario, faults):
    """One FedConfig, field for field, gives one fingerprint in both
    packages (the resume check compares them as JSON)."""
    j_scenario = j_get_scenario(scenario.name) if hasattr(scenario, "name") else scenario
    j_faults = J_FAULTS[faults.name] if hasattr(faults, "name") else faults
    kw = dict(engine="fused_e2e", num_clients=6, seed=4, use_kernels=False)
    t = t_rounds._config_fingerprint(TFed(scenario=scenario, faults=faults, **kw))
    j = j_rounds._config_fingerprint(JFed(scenario=j_scenario, faults=j_faults, **kw))
    assert t == j
    assert t_rounds._config_fingerprint(TFed(scenario=scenario, faults=faults, rounds=99,
                                             **kw)) == t


# -- kill and resume in the port ---------------------------------------------------

CHAN = dict(bandwidth_hz=2e5, mean_snr_db=14.0)  # the faults tests' channel: retries fit
RESUME_CASES = {
    "batched": dict(engine="batched"),
    "fused_e2e": dict(engine="fused_e2e"),
    "fused_e2e-block-scenario-faults": dict(engine="fused_e2e", scan_rounds=True,
                                            scenario="gilbert_elliott", faults="lossy"),
    "fused_e2e-pretrained": dict(engine="fused_e2e", pretrain_steps=2, server_pretrain="none"),
}


def _fed(package, rounds, **change):
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    kw = dict(method="adald", engine="fused_e2e", num_clients=6, clients_per_round=4,
              rounds=rounds, public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=1,
              distill_steps=1, server_distill_steps=1, seed=4, pretrain_steps=0,
              channel=chan(**CHAN))
    return fed(**{**kw, **change})


def _t_run(fed, **kw):
    """The port's run, its engine and its Server."""
    built = {}
    mp = pytest.MonkeyPatch()
    for name in ("make_engine", "Server"):
        make = getattr(t_rounds, name)
        mp.setattr(t_rounds, name, lambda *a, _m=make, _n=name, **k: built.setdefault(_n, _m(*a, **k)))
    try:
        run = t_rounds.run_federated(T_CLIENT, T_SERVER,
                                     t_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                                     device="cpu", **kw)
    finally:
        mp.undo()
    return run, built["make_engine"], built["Server"]


def _j_run(fed, **kw):
    return j_rounds.run_federated(J_CLIENT, J_SERVER,
                                  j_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                                  **kw)


def _final_state(engine, server) -> dict:
    """The tensors a later round reads: the fleet's adapters and optimizer
    moments, the server's parameters and the broadcast carry."""
    fleet = engine.fleet_state()
    out = {**{f"lora/{k}": v for k, v in fleet["lora"].items()},
           **{f"m/{k}": v for k, v in fleet["opt"].m.items()},
           **{f"server/{k}": v for k, v in server.params.items()}}
    if getattr(engine, "_b_logits", None) is not None:
        out["b_logits"] = engine._b_logits
    return out


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """{case: (uninterrupted port run, its final state, resumed run, its
    final state, its engine, checkpoint dir)}."""
    out = {}
    for case, change in RESUME_CASES.items():
        d = str(tmp_path_factory.mktemp(case))
        full, full_eng, full_srv = _t_run(_fed("torch", 3, **change))
        _t_run(_fed("torch", 1, **change), ckpt_dir=d)
        res, res_eng, res_srv = _t_run(_fed("torch", 3, **change), ckpt_dir=d, resume=True)
        out[case] = (full, _final_state(full_eng, full_srv), res, _final_state(res_eng, res_srv),
                     res_eng, d)
    return out


def _same_run(a, b):
    assert a.per_client_k == b.per_client_k
    assert _nan_equal(a, b)
    np.testing.assert_array_equal(a.server_acc, b.server_acc)
    np.testing.assert_array_equal(a.client_acc, b.client_acc)
    np.testing.assert_array_equal(a.distill_loss, b.distill_loss)
    for tap in t_rounds._TAPS:
        assert getattr(a, tap) == getattr(b, tap), tap


def _nan_equal(a, b) -> bool:
    """Ledger entries equal, NaN equal to NaN (an all-dropped round's
    accuracy and the off-e2e distill loss)."""
    for x, y in zip(a.ledger.rounds, b.ledger.rounds):
        for key, v in dataclasses.asdict(x).items():
            w = getattr(y, key)
            if not (v == w or (isinstance(v, float) and np.isnan(v) and np.isnan(w))):
                return False
    return len(a.ledger.rounds) == len(b.ledger.rounds)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_kill_and_resume_is_the_uninterrupted_run(resumed, case):
    full, want, res, got, res_eng, ckpt_dir = resumed[case]
    _same_run(res, full)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # a block writes at its end only; a per-round run after every round
    steps = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    written = (1, 3) if "block" in case else (1, 2, 3)
    assert steps == [f"step_{i:08d}.npz" for i in written]
    if "pretrained" in case:
        assert res_eng._store.shared  # the placeholders rebuilt the shared layout
    if "scenario" in case:
        assert len(res.snr_db) == 3 and res.num_crashed is not None


# -- across packages ------------------------------------------------------------------

CROSS = dict(faults="lossy")


def _mark_resumed(ckpt_dir: str) -> None:
    """Put a sentinel into the round-1 checkpoint's record: a run that
    resumes from it reports it as round 0's client accuracy."""
    path = os.path.join(ckpt_dir, "step_00000001.npz.meta.json")
    with open(path) as f:
        meta = json.load(f)
    meta["client_acc"][0] = -1.0
    with open(path, "w") as f:
        json.dump(meta, f)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The reference's uninterrupted run, the port resuming the reference's
    round-1 checkpoint, and the reference resuming the port's."""
    j_dir, j_host_dir, t_dir = (str(tmp_path_factory.mktemp(n))
                                for n in ("jax_wrote", "jax_host_store_wrote", "port_wrote"))
    j_full = _j_run(_fed("jax", 3, **CROSS))
    _j_run(_fed("jax", 1, **CROSS), ckpt_dir=j_dir)
    _mark_resumed(j_dir)
    t_resumed = _t_run(_fed("torch", 3, **CROSS), ckpt_dir=j_dir, resume=True)[0]
    # the reference's host store checkpoints its fleet as shards beside the step
    _j_run(_fed("jax", 1, fleet_store="host", **CROSS), ckpt_dir=j_host_dir)
    assert os.path.isdir(os.path.join(j_host_dir, "step_00000001.fleet"))
    _mark_resumed(j_host_dir)
    t_from_shards = _t_run(_fed("torch", 3, **CROSS), ckpt_dir=j_host_dir, resume=True)[0]
    _t_run(_fed("torch", 1, **CROSS), ckpt_dir=t_dir)
    _mark_resumed(t_dir)
    j_resumed = _j_run(_fed("jax", 3, **CROSS), ckpt_dir=t_dir, resume=True)
    return {"port-resumes-reference": (j_full, t_resumed),
            "port-resumes-reference-host-store": (j_full, t_from_shards),
            "reference-resumes-port": (j_full, j_resumed)}


@pytest.mark.parametrize("case", ["port-resumes-reference", "port-resumes-reference-host-store",
                                  "reference-resumes-port"])
def test_a_checkpoint_resumes_across_packages(cross, case):
    want, got = cross[case]
    assert got.client_acc[0] == -1.0  # round 0 came from the checkpoint
    assert got.per_client_k == want.per_client_k
    assert got.attempted_k == want.attempted_k
    assert (got.num_quarantined, got.num_crashed, got.retrans_bytes) == (
        want.num_quarantined, want.num_crashed, want.retrans_bytes)
    assert sum(want.num_crashed) + sum(want.num_quarantined) > 0
    for t, j in zip(got.ledger.rounds, want.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes, t.num_transmitters, t.fault_counts) == (
            j.uplink_bytes, j.downlink_bytes, j.num_transmitters, j.fault_counts)
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(got.server_acc, want.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.client_acc[1:], want.client_acc[1:], rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.distill_loss, want.distill_loss, rtol=1e-4)


# -- the reference's refusals -----------------------------------------------------------


def test_resume_refusals(resumed):
    ckpt_dir = resumed["fused_e2e"][5]
    with pytest.raises(ValueError, match=r"different FedConfig \(differing fields: \['lr'\]\)"):
        _t_run(_fed("torch", 5, engine="fused_e2e", lr=5e-4), ckpt_dir=ckpt_dir, resume=True)
    with pytest.raises(ValueError, match="already holds 3 completed rounds >= fed.rounds=3"):
        _t_run(_fed("torch", 3, engine="fused_e2e"), ckpt_dir=ckpt_dir, resume=True)
    with pytest.raises(ValueError, match="resume=True requires ckpt_dir"):
        _t_run(_fed("torch", 3), resume=True)


# -- serving from a checkpoint ------------------------------------------------------------


def _decode(source, tenants):
    params = serving_params(source, t_model.init(T_CLIENT, 11, "cpu"))
    cache = AdapterCache(source, like=lora_template(params), slots=2, device="cpu")
    sess = ServeSession(ServeConfig(model=T_CLIENT, batch=2, cache_len=16), params,
                        adapters=cache, device="cpu")
    sess.attach(tenants)
    sess.prefill(np.random.default_rng(5).integers(0, 256, size=(2, 4)).astype(np.int32))
    return sess.decode(8)[0]


def test_checkpoint_sources_serve_the_live_adapters(resumed, tmp_path):
    """The pretrained run's fleet (one shared backbone) from its last
    step's npz, from shards of it, and resolved from the checkpoint
    directory: the tokens the live store decodes, for two tenants."""
    eng, ckpt_dir = resumed["fused_e2e-pretrained"][4:]
    tenants = [5, 2]
    want = _decode(FleetStoreSource(eng._store), tenants)
    eng.save_fleet_shards(str(tmp_path / "shards"))
    step = os.path.join(ckpt_dir, "step_00000003.npz")
    sources = {"monolithic": MonolithicSource(step), "shards": ShardDirSource(str(tmp_path / "shards")),
               "export": export_adapters(ckpt_dir)}
    assert isinstance(sources["export"], MonolithicSource)
    for name, src in sources.items():
        assert src.num_adapters == 6, name
        np.testing.assert_array_equal(_decode(src, tenants), want, err_msg=name)
        frozen = src.frozen_tree()
        assert set(frozen) == {k for k in split_lora(eng.client_params(0))[1]}, name
    with pytest.raises(ValueError, match="PER-CLIENT backbone"):
        MonolithicSource(os.path.join(resumed["batched"][5], "step_00000003.npz")).frozen_tree()
    with pytest.raises(FileNotFoundError):
        export_adapters(str(tmp_path / "nothing-here"))
    with pytest.raises(TypeError):
        export_adapters(42)
