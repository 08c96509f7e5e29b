"""The port's fleet stores on the CPU: the host store against the device
store, the port against the JAX reference's host store.

* The store alone, on toy rows (the reference's ``tests/test_store.py``
  cases): fetch and commit round trip; a prefetched fetch equals an
  unprefetched one when the staged cohort overlaps rows committed after
  the hint (the dirty-row patch), also in the round loop's order (hint
  r+1, then fetch r: the double buffer); a hint miss; duplicate commits;
  no stacked device tree; shards across both stores, incomplete shards
  refused; ``spill_dir`` paging; ``from_template`` at N = 100 000; the
  ``make_fleet_store`` spec; a bf16 optimizer state; and the port's own
  rule that a failed staging thread raises at the fetch of its cohort.
* Runs: ``fleet_store="host"`` on ``batched``, ``fused`` and
  ``fused_e2e`` equals the device store bitwise (k, bytes, accuracies,
  distill losses and every trained fleet tensor), with prefetch on or off,
  and on a Gilbert-Elliott channel with ``faults="lossy"``;
  ``scan_rounds`` falls back to the per-round loop; the sequential engine
  refuses a host store and takes a built device store.
* Checkpoints: a host store's fleet in shards beside the step (the shards
  first, ``fleet_sharded`` in the metadata), resumed bitwise under either
  store; across packages both ways.
* Against the reference's host store (``fused_e2e``, the bridged JAX
  init, ``use_kernels=False``): integers identical, accuracies within one
  eval sample, the distill loss within rtol 1e-4 (``test_torch_round.py``'s
  bounds: the packages compute the same rounds from the same state).
* Serving: a live host store through ``export_adapters`` and an
  ``AdapterCache`` gives the device store's rows and tokens.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.checkpoint.ckpt as t_ckpt  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core.channel import BatchedChannelState, ChannelState  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed.engine import FusedE2EEngine, SequentialEngine, make_engine  # noqa: E402
from repro_torch.fed.server import Server  # noqa: E402
from repro_torch.fed.store import (  # noqa: E402
    DeviceFleetStore,
    FleetStore,
    HostFleetStore,
    make_fleet_store,
)
from repro_torch.lora import lora_template, split_lora  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.serve import AdapterCache, ServeConfig, ServeSession, export_adapters  # noqa: E402
from repro_torch.serve import serving_params  # noqa: E402
from repro_torch.serve.export import FleetStoreSource, ShardDirSource  # noqa: E402

# -- the store alone, on toy rows ---------------------------------------------------


def _toy(n, seed=0):
    """n per-client LoRA rows and one shared backbone, numpy-seeded."""
    rng = np.random.default_rng(seed)
    row = lambda: {"w": torch.as_tensor(rng.normal(size=(3, 2)).astype(np.float32)),  # noqa: E731
                   "b/v": torch.as_tensor(rng.normal(size=(4,)).astype(np.float32))}
    return [row() for _ in range(n)], row()


def _mk_host(n=6, **kw):
    loras, frozen = _toy(n)
    return HostFleetStore(loras, [frozen] * n, shared=True, **kw)


def _bump(tree, scale=2.0):
    return {k: v * scale + 1.0 for k, v in tree.items()}


def _bump_opt(opt):
    return AdamWState(m=_bump(opt.m), v=_bump(opt.v, 3.0), count=opt.count + 1)


def _flat(lora, opt) -> dict:
    out = {f"lora/{k}": v for k, v in lora.items()}
    out.update({f"m/{k}": v for k, v in opt.m.items()})
    out.update({f"v/{k}": v for k, v in opt.v.items()})
    out["count"] = opt.count
    return out


def _assert_cohort_equal(a, b):
    fa, fb = _flat(a[1], a[3]), _flat(b[1], b[3])
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def _round(st, sel):
    """One round's fetch and commit of advanced rows."""
    idx, lora, _, opt = st.fetch(sel)
    st.commit(idx, _bump(lora), _bump_opt(opt))


def test_host_fetch_commit_roundtrip():
    loras, _ = _toy(6)
    st = _mk_host(prefetch=False)
    idx, lora, frozen, opt = st.fetch([1, 3])
    assert idx.tolist() == [1, 3] and frozen is st.frozen
    assert torch.equal(lora["w"][0], loras[1]["w"]) and torch.equal(lora["b/v"][1], loras[3]["b/v"])
    assert opt.count.dtype == torch.int32 and opt.count.tolist() == [0, 0]
    st.commit(idx, _bump(lora), _bump_opt(opt))
    _, lora2, _, opt2 = st.fetch([1, 3])
    assert all(torch.equal(lora2[k], _bump(lora)[k]) for k in lora)
    assert torch.equal(opt2.v["w"], _bump(opt.v, 3.0)["w"]) and opt2.count.tolist() == [1, 1]
    # untouched rows unaffected; a fetch owns its storage (the host stack does not move)
    _, lora0, _, _ = st.fetch([0])
    assert torch.equal(lora0["w"][0], loras[0]["w"])
    lora0["w"].add_(100.0)
    assert torch.equal(st.fetch([0])[1]["w"][0], loras[0]["w"])


def test_host_prefetch_overlap_bit_identity():
    """A prefetched fetch returns exactly what an unprefetched one would,
    when the staged cohort overlaps rows committed AFTER the hint."""
    a, b = _mk_host(prefetch=True), _mk_host(prefetch=False)
    sel0, sel1 = [0, 1], [1, 2]  # round r, round r+1: client 1 in both
    fa, fb = a.fetch(sel0), b.fetch(sel0)
    a.prefetch(sel1)  # staged BEFORE round r's rows are committed
    a.commit(fa[0], _bump(fa[1]), _bump_opt(fa[3]))
    b.commit(fb[0], _bump(fb[1]), _bump_opt(fb[3]))
    assert a._pf[tuple(sel1)][2] == {0, 1}  # the commit marked its rows dirty
    _assert_cohort_equal(a.fetch(sel1), b.fetch(sel1))


def test_host_prefetch_double_buffer_driver_order():
    """The round loop hints round r+1 BEFORE it fetches round r's staged
    cohort: both entries are held, and the result is the unprefetched one."""
    a, b = _mk_host(prefetch=True), _mk_host(prefetch=False)
    sels = [[0, 1], [1, 2], [2, 3], [0, 3]]  # consecutive overlaps
    a.prefetch(sels[0])
    for r, sel in enumerate(sels):
        if r + 1 < len(sels):
            a.prefetch(sels[r + 1])
        assert tuple(sel) in a._pf  # this round's entry survived the hint
        fa, fb = a.fetch(sel), b.fetch(sel)
        assert tuple(sel) not in a._pf  # consumed, not staged again
        _assert_cohort_equal(fa, fb)
        a.commit(fa[0], _bump(fa[1]), _bump_opt(fa[3]))
        b.commit(fb[0], _bump(fb[1]), _bump_opt(fb[3]))


def test_host_prefetch_hint_miss_falls_back():
    a, b = _mk_host(prefetch=True), _mk_host(prefetch=False)
    a.prefetch([2, 3])
    _assert_cohort_equal(a.fetch([3, 2]), b.fetch([3, 2]))  # a reordering is a miss


def test_a_failed_staging_thread_raises_at_its_fetch(monkeypatch):
    """Where the reference falls back to a cold fetch, the port raises: a
    broken staging path must not pass unseen.  A miss still cold-fetches."""
    st, ref = _mk_host(prefetch=True), _mk_host(prefetch=False)
    stage = HostFleetStore._stage

    def broken(self, ids, keys, stream):
        if ids == [4, 5]:
            raise OSError("staging failed")
        return stage(self, ids, keys, stream)

    monkeypatch.setattr(HostFleetStore, "_stage", broken)
    st.prefetch([4, 5])
    _assert_cohort_equal(st.fetch([0, 1]), ref.fetch([0, 1]))  # a miss
    with pytest.raises(RuntimeError, match=r"staging the prefetched cohort \[4, 5\] failed") as e:
        st.fetch([4, 5])
    assert isinstance(e.value.__cause__, OSError)


def test_prefetch_under_a_short_switch_interval():
    """The staging threads and the round's commits share the host rows: with
    the interpreter switching threads every microsecond, 60 rounds of
    overlapping cohorts in the round loop's order still give the
    unprefetched store's rows at every fetch, and no staging thread is left
    running."""
    import sys

    a, b = _mk_host(8, prefetch=True), _mk_host(8, prefetch=False)
    rng = np.random.default_rng(11)
    sels = [[int(x) for x in rng.choice(8, 3, replace=False)] for _ in range(60)]
    interval, threads = sys.getswitchinterval(), set()
    sys.setswitchinterval(1e-6)
    try:
        for r, sel in enumerate(sels):
            if r + 1 < len(sels):
                a.prefetch(sels[r + 1])
            threads.update(entry[0] for entry in a._pf.values())
            fa, fb = a.fetch(sel), b.fetch(sel)
            _assert_cohort_equal(fa, fb)
            a.commit(fa[0], _bump(fa[1], 1.5), _bump_opt(fa[3]))
            b.commit(fb[0], _bump(fb[1], 1.5), _bump_opt(fb[3]))
        a._drop_prefetch()
    finally:
        sys.setswitchinterval(interval)
    assert len(threads) > 30 and not any(t.is_alive() for t in threads) and not a._pf
    _assert_state_equal(a, b)


def test_host_commit_duplicate_rejected():
    st = _mk_host(prefetch=False)
    idx, lora, _, opt = st.fetch([1, 1])  # reads may repeat; writes may not
    with pytest.raises(ValueError, match="duplicate"):
        st.commit(idx, lora, opt)


def test_host_store_has_no_stacked_device_tree():
    st = _mk_host()
    for name in ("lora", "opt"):
        with pytest.raises(RuntimeError, match="scan"):
            getattr(st, name)
    per_client = HostFleetStore(*_toy(2)[:1], [_toy(1, 5)[1], _toy(1, 6)[1]], shared=False)
    with pytest.raises(RuntimeError, match="scan"):
        per_client.frozen  # noqa: B018


def _state(st) -> dict:
    sd = st.state_dict()
    return {**_flat(sd["lora"], sd["opt"]), **{f"frozen/{k}": v for k, v in sd["frozen"].items()}}


def _assert_state_equal(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k].cpu(), sb[k].cpu()), k


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-client"])
def test_shard_roundtrip_cross_store(tmp_path, shared):
    """Shards the device store writes restore into the host store bitwise,
    and the host store's (another shard size) into a device store."""
    loras, frozen = _toy(5)
    frozens = [frozen] * 5 if shared else [_toy(1, 10 + i)[1] for i in range(5)]
    blank = [{k: torch.zeros_like(v) for k, v in r.items()} for r in loras]
    dev = DeviceFleetStore(loras, frozens, shared=shared)
    _round(dev, [0, 2])
    _round(dev, [4, 2])
    dev.shard_size = 2  # 3 shards for 5 clients
    d1 = str(tmp_path / "dev")
    dev.save_shards(d1)
    assert sorted(os.listdir(d1)) == (
        ["fleet_00000000_00000002.npz", "fleet_00000002_00000004.npz",
         "fleet_00000004_00000005.npz"] + (["fleet_frozen.npz"] if shared else []))
    host = HostFleetStore(blank, [{k: torch.zeros_like(v) for k, v in frozen.items()}] * 5
                          if shared else [{k: torch.zeros_like(v) for k, v in f.items()}
                                          for f in frozens], shared=shared, prefetch=False)
    host.load_shards(d1)
    _assert_state_equal(dev, host)
    host.shard_size = 3
    d2 = str(tmp_path / "host")
    host.save_shards(d2)
    dev2 = DeviceFleetStore(blank, [frozen] * 5 if shared else frozens, shared=shared)
    dev2.load_shards(d2)
    _assert_state_equal(dev, dev2)


def test_incomplete_shards_rejected(tmp_path):
    st = _mk_host(5, prefetch=False)
    st.shard_size = 2
    st.save_shards(str(tmp_path))
    os.remove(tmp_path / "fleet_00000002_00000004.npz")
    with pytest.raises(ValueError, match="cover"):
        _mk_host(5, prefetch=False).load_shards(str(tmp_path))


def test_spill_dir_pages_fleet_to_disk(tmp_path):
    """Spilled stacks live as npz shards (host_bytes 0); commits across more
    shards than the cache holds force write-back, and every row round-trips
    exactly, through the state dict too."""
    ref = _mk_host(10, prefetch=False)
    sp = _mk_host(10, prefetch=True, spill_dir=str(tmp_path), shard_size=1)
    assert sp.host_bytes() == 0 and ref.host_bytes() > 0
    assert any(f.startswith("spill_") for f in os.listdir(tmp_path))
    for cid in range(10):  # 10 shards > the cache's 4
        for st in (ref, sp):
            _round(st, [cid])
    sp.prefetch([9, 0])
    for cid in range(10):
        _assert_cohort_equal(sp.fetch([cid]), ref.fetch([cid]))
    _assert_state_equal(sp, ref)


def test_from_template_lazy_rows():
    """Every row reads the template until its first commit; committed rows
    persist; device bytes do not grow with N; resident host bytes count the
    committed rows only."""
    (lora_row,), frozen = _toy(1, seed=7)
    mk = lambda n: HostFleetStore.from_template(lora_row, frozen, num_clients=n,  # noqa: E731
                                                prefetch=False)
    st = mk(8)
    _, lora, _, opt = st.fetch([2, 5])
    for j in range(2):
        assert torch.equal(lora["w"][j], lora_row["w"]) and float(opt.m["w"][j].abs().sum()) == 0
    st.commit(torch.as_tensor([2]), {k: v[:1] * 3.0 for k, v in lora.items()},
              _bump_opt(AdamWState(m={k: v[:1] for k, v in opt.m.items()},
                                   v={k: v[:1] for k, v in opt.v.items()}, count=opt.count[:1])))
    _, lora2, _, opt2 = st.fetch([2, 5])
    assert torch.equal(lora2["w"][0], lora_row["w"] * 3.0) and opt2.count.tolist() == [1, 0]
    assert torch.equal(lora2["w"][1], lora_row["w"])  # still the template
    big = mk(100_000)
    assert big.num_clients == 100_000 and big.device_bytes() == st.device_bytes() > 0
    row_bytes = st.host_bytes() // 2  # the template and one committed row
    assert big.host_bytes() == row_bytes  # nothing committed: the template only
    _round(big, [99_999, 3])
    assert big.host_bytes() == 3 * row_bytes
    assert big.fetch([99_999])[3].count.tolist() == [1]


def test_make_fleet_store_spec():
    loras, frozen = _toy(3)
    kw = dict(loras=loras, frozens=[frozen] * 3, shared=True)
    assert make_fleet_store(None, **kw).kind == "device"
    assert make_fleet_store("device", **kw).kind == "device"
    host = make_fleet_store("host", **kw)
    assert host.kind == "host" and isinstance(host, FleetStore)
    assert make_fleet_store(host, **kw) is host
    assert make_fleet_store("host", state_dtype="bfloat16", **kw).fetch([0])[3].m["w"].dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="fleet_store"):
        make_fleet_store("gpu", **kw)


def test_bf16_optimizer_state_round_trip(tmp_path):
    """bf16 Adam moments: fetch, commit, the state dict and shards carry
    them bitwise under both stores, and a lazy fleet's bf16 leaves start at
    zero."""
    loras, frozen = _toy(4)
    dev = DeviceFleetStore(loras, [frozen] * 4, shared=True, state_dtype="bfloat16")
    host = HostFleetStore(loras, [frozen] * 4, shared=True, state_dtype="bfloat16")
    for st in (dev, host):
        for sel in ([0, 2], [2, 3], [1, 0]):
            host.prefetch(sel) if st is host else None
            _round(st, sel)
    _assert_state_equal(dev, host)
    assert host.state_dict()["opt"].m["w"].dtype == torch.bfloat16
    host.save_shards(str(tmp_path))
    back = DeviceFleetStore(loras, [frozen] * 4, shared=True, state_dtype="bfloat16")
    back.load_shards(str(tmp_path))
    _assert_state_equal(dev, back)
    lazy = HostFleetStore.from_template(loras[0], frozen, num_clients=1000, state_dtype="bfloat16")
    m = lazy.fetch([999])[3].m["w"]
    assert m.dtype == torch.bfloat16 and float(m.abs().sum()) == 0


# -- runs: the host store against the device store ----------------------------------------

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
_C = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
          max_seq_len=32)
_S = dict(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192, vocab_size=256,
          max_seq_len=32)
J_CLIENT, J_SERVER = J_RC.with_overrides(**_C, lora=JLoRA(**_LORA)), J_RS.with_overrides(**_S, lora=JLoRA(**_LORA))
T_CLIENT, T_SERVER = T_RC.with_overrides(**_C, lora=TLoRA(**_LORA)), T_RS.with_overrides(**_S, lora=TLoRA(**_LORA))
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
EVAL_SIZE = 64


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(autouse=True, scope="module")
def bridged():
    """Both packages start from the same weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    yield
    mp.undo()


def _fed(package, rounds=3, **change):
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    kw = dict(method="adald", engine="fused_e2e", num_clients=4, clients_per_round=2,
              rounds=rounds, public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=2,
              distill_steps=1, server_distill_steps=2, seed=0, pretrain_steps=0,
              channel=chan(**_CHAN))
    return fed(**{**kw, **change})


def _t_run(fed, **kw):
    """The port's run and its engine."""
    built = []
    make = t_rounds.make_engine
    mp = pytest.MonkeyPatch()
    mp.setattr(t_rounds, "make_engine", lambda *a, **k: built.append(make(*a, **k)) or built[-1])
    try:
        run = t_rounds.run_federated(T_CLIENT, T_SERVER,
                                     t_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                                     device="cpu", **kw)
    finally:
        mp.undo()
    return run, built[0]


def _j_run(fed, **kw):
    return j_rounds.run_federated(J_CLIENT, J_SERVER,
                                  j_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                                  **kw)


def _trained(engine) -> dict:
    """Every trained fleet tensor: adapters, Adam m, v and count."""
    fleet = engine.fleet_state()
    return {k: v.cpu() for k, v in _flat(fleet["lora"], fleet["opt"]).items()}


def _same_run(a, b):
    assert a.per_client_k == b.per_client_k
    for x, y in zip(a.ledger.rounds, b.ledger.rounds):
        assert (x.uplink_bytes, x.downlink_bytes, x.num_transmitters, x.fault_counts) == (
            y.uplink_bytes, y.downlink_bytes, y.num_transmitters, y.fault_counts)
    assert len(a.ledger.rounds) == len(b.ledger.rounds)
    assert (a.server_acc, a.client_acc) == (b.server_acc, b.client_acc)
    np.testing.assert_array_equal(a.distill_loss, b.distill_loss)
    for tap in t_rounds._TAPS:
        assert getattr(a, tap) == getattr(b, tap), tap


def _same_trained(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


ENGINES = ["batched", "fused", "fused_e2e"]


@pytest.fixture(scope="module")
def store_runs():
    """{engine: {store: (run, trained fleet, prefetch hits)}}: the device
    store, the host store, and the host store with prefetch off."""
    out = {}
    hits = []
    take, prefetch = HostFleetStore._take_prefetched, HostFleetStore.prefetch

    def counting(self, sel):
        dev = take(self, sel)
        hits.append((sel, dev is not None))
        return dev

    mp = pytest.MonkeyPatch()
    mp.setattr(HostFleetStore, "_take_prefetched", counting)
    try:
        for engine in ENGINES:
            out[engine] = {}
            for store in ("device", "host", "host-no-prefetch"):
                hits.clear()
                if store == "host-no-prefetch":
                    mp.setattr(HostFleetStore, "prefetch", FleetStore.prefetch)
                run, eng = _t_run(_fed("torch", engine=engine,
                                       fleet_store="device" if store == "device" else "host"))
                mp.setattr(HostFleetStore, "prefetch", prefetch)
                assert eng.store_kind == store.split("-")[0]
                out[engine][store] = (run, _trained(eng), list(hits))
    finally:
        mp.undo()
    return out


def _expected_hits(sels) -> list[bool]:
    """Which fetches find their cohort staged, in the round loop's order
    (hint r+1, then fetch r): a cohort drawn twice in a row is staged once."""
    staged, out = set(), []
    for r, sel in enumerate(sels):
        if r + 1 < len(sels):
            staged.add(sels[r + 1])
        out.append(sel in staged)
        staged.discard(sel)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_host_store_run_is_the_device_store_run(store_runs, engine):
    """k, bytes, accuracies, distill losses and every trained fleet tensor,
    bitwise, with prefetch on and off; the staged cohorts are the ones the
    round loop hinted, and consecutive cohorts of a 4-client fleet share
    clients (the dirty-row patch ran)."""
    dev_run, dev_fleet, _ = store_runs[engine]["device"]
    for store in ("host", "host-no-prefetch"):
        run, fleet, fetches = store_runs[engine][store]
        sels = [sel for sel, _hit in fetches]
        assert len(sels) == 3 and any(set(a) & set(b) for a, b in zip(sels, sels[1:]))
        want = _expected_hits(sels) if store == "host" else [False] * 3
        assert [hit for _sel, hit in fetches] == want, store
        assert any(want) == (store == "host")
        _same_run(run, dev_run)
        _same_trained(fleet, dev_fleet)


def test_host_store_under_a_scenario_and_faults():
    change = dict(scenario="gilbert_elliott", faults="lossy",
                  channel=TChannel(bandwidth_hz=2e5, mean_snr_db=14.0))
    dev, dev_eng = _t_run(_fed("torch", **change))
    host, host_eng = _t_run(_fed("torch", fleet_store="host", **change))
    assert sum(dev.num_crashed) + sum(dev.num_quarantined) + sum(
        k == 0 for ks in dev.per_client_k for k in ks) > 0
    _same_run(host, dev)
    _same_trained(_trained(host_eng), _trained(dev_eng))


def test_scan_rounds_with_a_host_store_falls_back(store_runs, capsys):
    """The block needs the whole fleet on the device: with a host store
    ``scan_rounds`` runs the per-round loop, with the reference's line, and
    gives its result; ``run_rounds`` refuses with the reference's message."""
    fed = _fed("torch", fleet_store="host", scan_rounds=True)
    scan, eng = t_rounds.run_federated(T_CLIENT, T_SERVER,
                                       t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                                       fed, device="cpu", verbose=True), None
    assert "scan_rounds needs the device fleet store; fleet_store='host' falls back" in \
        capsys.readouterr().out
    _same_run(scan, store_runs["fused_e2e"]["host"][0])
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    from repro_torch.fed.client import Client
    clients = [Client(i, T_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)), seed=i,
                      device="cpu") for i in range(2)]
    eng = FusedE2EEngine(clients, T_CLIENT, server=Server(T_SERVER, device="cpu"),
                         num_classes=ds.num_classes, local_steps=1, distill_steps=1,
                         server_distill_steps=1, fleet_store="host")
    states = BatchedChannelState.from_states([ChannelState(1e6, 10.0, 0.5, 1.0)] * 2)
    pub = torch.as_tensor(ds.tokens[:16])
    with pytest.raises(RuntimeError, match="fleet_store='device'"):
        eng.run_rounds([[0, 1]], [pub], [states], adaptive_k=True, send_h=True)


def test_sequential_engine_refuses_a_host_store_and_takes_a_built_device_store():
    """As the reference checks ``getattr(store, "kind", store)``: a built
    device store passes, a host store (spec or built) is refused."""
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    from repro_torch.fed.client import Client
    clients = [Client(i, T_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)), seed=i,
                      device="cpu") for i in range(2)]
    lora, frozen = split_lora(clients[0].params)
    kw = dict(num_classes=ds.num_classes)
    for store in ("host", HostFleetStore([lora], [frozen], shared=True)):
        with pytest.raises(NotImplementedError, match="sequential"):
            make_engine("sequential", clients, T_CLIENT, fleet_store=store, **kw)
    built = DeviceFleetStore([lora], [frozen], shared=True)
    assert isinstance(make_engine("sequential", clients, T_CLIENT, fleet_store=built, **kw),
                      SequentialEngine)


# -- checkpoints ----------------------------------------------------------------------------


def _shards_first(order: list):
    """A ``save_step`` wrapper noting, at each step, whether its shard
    directory was complete before the main npz was written."""
    save_step = t_ckpt.save_step

    def call(ckpt_dir, step, tree, **meta):
        shard_dir = t_ckpt.fleet_shard_dir(ckpt_dir, step)
        order.append((step, os.path.isdir(shard_dir) and bool(
            t_ckpt.list_fleet_shards(shard_dir)), "fleet" in tree))
        return save_step(ckpt_dir, step, tree, **meta)

    return call


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Each resume case's resumed run and trained fleet; the step order of
    the host store's checkpoint."""
    out, order = {}, []
    mp = pytest.MonkeyPatch()
    mp.setattr(t_ckpt, "save_step", _shards_first(order))
    try:
        for case, (write, read) in {"host-host": ("host", "host"), "host-device": ("host", "device"),
                                    "device-host": ("device", "host")}.items():
            d = str(tmp_path_factory.mktemp(case))
            _t_run(_fed("torch", rounds=1, fleet_store=write), ckpt_dir=d)
            run, eng = _t_run(_fed("torch", fleet_store=read), ckpt_dir=d, resume=True)
            out[case] = (run, _trained(eng), d)
    finally:
        mp.undo()
    out["order"] = order
    return out


@pytest.mark.parametrize("case", ["host-host", "host-device", "device-host"])
def test_a_resume_under_either_store_is_the_uninterrupted_run(resumed, store_runs, case):
    run, fleet, d = resumed[case]
    want_run, want_fleet, _ = store_runs["fused_e2e"]["device"]
    _same_run(run, want_run)
    _same_trained(fleet, want_fleet)
    sharded = t_ckpt.step_metadata(d, 1).get("fleet_sharded", False)
    assert sharded == case.startswith("host")
    if sharded:  # per-client backbones (no pretraining): inside the one shard
        assert os.listdir(t_ckpt.fleet_shard_dir(d, 1)) == ["fleet_00000000_00000004.npz"]


def test_the_shards_are_written_before_the_step(resumed):
    host_steps = [row for row in resumed["order"] if not row[2]]
    assert host_steps and all(complete for _step, complete, _ in host_steps)
    # a device store's step holds its fleet in the npz
    assert any(row[2] for row in resumed["order"])


# -- against the reference's host store ---------------------------------------------------------


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The reference's host-store run; each package resuming the other's
    host-store checkpoint of round 1, with the reference's uninterrupted run
    to hold them to."""
    j_dir, t_dir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_wrote", "port_wrote"))
    j_full = _j_run(_fed("jax", fleet_store="host"))
    _j_run(_fed("jax", rounds=1, fleet_store="host"), ckpt_dir=j_dir)
    assert j_ckpt_sharded(j_dir)
    t_from_jax = _t_run(_fed("torch", fleet_store="host"), ckpt_dir=j_dir, resume=True)[0]
    _t_run(_fed("torch", rounds=1, fleet_store="host"), ckpt_dir=t_dir)
    j_from_port = _j_run(_fed("jax", fleet_store="host"), ckpt_dir=t_dir, resume=True)
    return {"reference": j_full, "port-resumes-reference": t_from_jax,
            "reference-resumes-port": j_from_port}


def j_ckpt_sharded(ckpt_dir) -> bool:
    return bool((t_ckpt.step_metadata(ckpt_dir, 1) or {}).get("fleet_sharded"))


def _matches_reference(got, want):
    assert got.per_client_k == want.per_client_k
    for t, j in zip(got.ledger.rounds, want.ledger.rounds):
        assert (t.uplink_bytes, t.downlink_bytes, t.num_selected, t.num_transmitters) == (
            j.uplink_bytes, j.downlink_bytes, j.num_selected, j.num_transmitters)
    assert len(got.ledger.rounds) == len(want.ledger.rounds)
    one_sample = 1.0 / EVAL_SIZE + 1e-9
    np.testing.assert_allclose(got.server_acc, want.server_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.client_acc, want.client_acc, rtol=0, atol=one_sample)
    np.testing.assert_allclose(got.distill_loss, want.distill_loss, rtol=1e-4)


@pytest.mark.parametrize("case", ["port", "port-resumes-reference", "reference-resumes-port"])
def test_the_host_store_matches_the_references(cross, store_runs, case):
    got = store_runs["fused_e2e"]["host"][0] if case == "port" else cross[case]
    _matches_reference(got, cross["reference"])


# -- serving from a live host store ----------------------------------------------------------------


def _decode(source):
    params = serving_params(source, t_model.init(T_CLIENT, 11, "cpu"))
    cache = AdapterCache(source, like=lora_template(params), slots=2, device="cpu")
    sess = ServeSession(ServeConfig(model=T_CLIENT, batch=2, cache_len=16), params,
                        adapters=cache, device="cpu")
    sess.attach([3, 1])
    sess.prefill(np.random.default_rng(5).integers(0, 256, size=(2, 4)).astype(np.int32))
    return sess.decode(8)[0], cache.stats


def test_a_live_host_store_serves_the_device_stores_adapters(tmp_path):
    """A pretrained (shared-backbone) run under each store; the host store
    read live through ``export_adapters`` and its checkpoint's shards give
    the device store's rows and tokens."""
    runs = {store: _t_run(_fed("torch", rounds=1, clients_per_round=4, fleet_store=store,
                               pretrain_steps=1, server_pretrain="none"),
                          ckpt_dir=str(tmp_path / store))[1]
            for store in ("device", "host")}
    dev, host = (export_adapters(runs[s]._store) for s in ("device", "host"))
    assert isinstance(host, FleetStoreSource) and host.num_adapters == dev.num_adapters == 4
    for cid in range(4):
        a, b = host.lora_row(cid), dev.lora_row(cid)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(host.frozen_tree()[k], v) for k, v in dev.frozen_tree().items())
    from_shards = export_adapters(str(tmp_path / "host"))
    assert isinstance(from_shards, ShardDirSource)
    want, stats = _decode(dev)
    for src in (host, from_shards):
        got, got_stats = _decode(src)
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(got_stats) == dataclasses.asdict(stats)
