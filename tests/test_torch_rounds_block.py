"""The port's multi-round block against the JAX reference, on the CPU
(the pretrained federations themselves: ``tests/test_torch_pretrain.py``).

* ``FusedE2EEngine.run_rounds`` against R ``run_round`` calls of the port
  and against the reference's ``run_rounds`` (``tests/test_engine.py``'s
  engine-level block test), and ``FedConfig.scan_rounds`` against the
  port's per-round run, with a shared pretrained backbone and with
  per-client random ones, and (the first) against the reference's scan.
* The reference's refusals, and the in-block eval tap against the host
  evaluator.

Both packages start from the same weights: the port's model init is
replaced by the bridged JAX init for the same (config, seed), so the
pretraining and every client and server init match.  Tolerances: against
the reference, integers (per-client k, bytes, transmitters) identical,
accuracies within one eval sample, the server-distill loss within rtol
1e-4 (``tests/test_torch_round.py``'s bounds; after pretraining, two
samples and rtol 1e-3, as ``tests/test_torch_pretrain.py`` states why),
the advanced LoRA leaves of
the engine-level block within 1e-3 in relative L2 norm: their B factors
start at zero and hold a few Adam steps of size lr, each step normalised,
so a relative difference in a gradient reaches them undiminished (the
query adapter's B sits 1.4e-4 (clients) and 2e-4 (server) from the
reference after two rounds, on the per-round path as in the block).
The block against the port's own per-round rounds: the reference's
contract for its scan (``tests/test_engine.py``), taps within 1e-6
(accuracies) and rtol 1e-4 (distill loss), parameters within 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fed.pretrain as j_pre  # noqa: E402
import repro.fed.rounds as j_rounds  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core import ChannelSimulator as JSim  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import FedConfig as JFed  # noqa: E402
from repro.fed import FusedE2EEngine as JE2E  # noqa: E402
from repro.fed.client import Client as JClient  # noqa: E402
from repro.fed.server import Server as JServer  # noqa: E402
from repro.models import init as j_init  # noqa: E402
import repro_torch.fed.pretrain as t_pre  # noqa: E402
import repro_torch.fed.rounds as t_rounds  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core import ChannelSimulator as TSim  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import FedConfig as TFed  # noqa: E402
from repro_torch.fed import FusedE2EEngine as TE2E  # noqa: E402
from repro_torch.fed.client import Client as TClient  # noqa: E402
from repro_torch.fed.server import Server as TServer  # noqa: E402
from repro_torch.fed.steps import make_eval_fn, make_scan_eval_fn  # noqa: E402
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
ONE_SAMPLE = 1.0 / EVAL_SIZE + 1e-9

# run_federated cases: (engine, server_pretrain, pretrain_steps, scan_rounds)
SCAN_CASES = {"scan-pretrained": ("fused_e2e", "none", 2, True),
              "loop-pretrained": ("fused_e2e", "none", 2, False),
              "loop-random-init": ("fused_e2e", "none", 0, False),
              "scan-random-init": ("fused_e2e", "none", 0, True)}
# read on the port's side only: the port's pretrained loop is held to the
# reference's by tests/test_torch_pretrain.py (its fused_e2e-none case),
# its random-init loop by tests/test_torch_round.py (the float_wire case),
# and the reference's scan to its loop without a shared backbone by
# tests/test_engine.py::test_scan_rounds_without_shared_backbone
PORT_ONLY = ("loop-pretrained", "loop-random-init", "scan-random-init")


def _bridged_init(cfg, seed, device="cuda", **_):
    tree = j_init(jax.random.PRNGKey(seed), {T_CLIENT: J_CLIENT, T_SERVER: J_SERVER}[cfg])
    return bridge.to_torch(jax.tree.map(np.asarray, tree), device)


@pytest.fixture(autouse=True, scope="module")
def bridged():
    """The bridged init and empty pretraining caches for the whole module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    mp.setattr(t_pre, "_CACHE", {})
    mp.setattr(j_pre, "_CACHE", {})
    yield
    mp.undo()


def _fed(case, package):
    engine, server_pretrain, pretrain_steps, scan = SCAN_CASES[case]
    fed, chan = (JFed, JChannel) if package == "jax" else (TFed, TChannel)
    return fed(method="adald", engine=engine, num_clients=4, clients_per_round=2, rounds=2,
               public_size=64, public_batch=16, eval_size=EVAL_SIZE, local_steps=2,
               distill_steps=1, server_distill_steps=2, seed=0, pretrain_steps=pretrain_steps,
               server_pretrain=server_pretrain, scan_rounds=scan, channel=chan(**_CHAN),
               **({} if package == "jax" else {"use_kernels": True}))


def _run_both(cases):
    """{case: (reference run or None, port run, port engine)}."""
    out, built = {}, []
    make = t_rounds.make_engine
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_rounds, "make_engine", lambda *a, **k: built.append(make(*a, **k)) or built[-1])
        for case in cases:
            j_run = None if case in PORT_ONLY else j_rounds.run_federated(
                J_CLIENT, J_SERVER, j_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(case, "jax"))
            t_run = t_rounds.run_federated(
                T_CLIENT, T_SERVER, t_dataset(vocab_size=256, seq_len=12, total=500, seed=0),
                _fed(case, "torch"), device="cpu")
            out[case] = (j_run, t_run, built[-1])
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def scan_runs():
    return _run_both(SCAN_CASES)


def _integers_identical(a, b):
    assert a.per_client_k == b.per_client_k
    assert len(a.ledger.rounds) == len(b.ledger.rounds) == 2
    for x, y in zip(a.ledger.rounds, b.ledger.rounds):
        assert (x.uplink_bytes, x.downlink_bytes) == (y.uplink_bytes, y.downlink_bytes)
        assert (x.num_selected, x.num_transmitters) == (y.num_selected, y.num_transmitters)


def _floats_match(a, b, acc_atol=ONE_SAMPLE, loss_rtol=1e-4):
    np.testing.assert_allclose(a.server_acc, b.server_acc, rtol=0, atol=acc_atol)
    np.testing.assert_allclose(a.client_acc, b.client_acc, rtol=0, atol=acc_atol)
    np.testing.assert_allclose(a.distill_loss, b.distill_loss, rtol=loss_rtol, equal_nan=True)


@pytest.mark.parametrize("case", ["pretrained", "random-init"])
def test_scan_rounds_matches_per_round_and_reference(scan_runs, case):
    """``scan_rounds=True`` against the port's per-round run (the
    reference's scan contract), with a shared pretrained backbone and with
    per-client random backbones (the store's stacked layout); the first
    also against the reference's scan run (the second reaches it through
    the tests that ``PORT_ONLY`` names)."""
    _, loop, loop_eng = scan_runs[f"loop-{case}"]
    j_scan, scan, scan_eng = scan_runs[f"scan-{case}"]
    assert scan_eng._store.shared == loop_eng._store.shared == (case == "pretrained")
    _integers_identical(scan, loop)
    np.testing.assert_allclose(scan.mean_k, loop.mean_k, rtol=1e-6)
    _floats_match(scan, loop, acc_atol=1e-6)
    assert len(scan.round_seconds) == 2
    if j_scan is not None:  # after pretraining: test_torch_pretrain.py's bounds
        _integers_identical(scan, j_scan)
        np.testing.assert_allclose(scan.mean_k, j_scan.mean_k, rtol=1e-6)
        _floats_match(scan, j_scan, acc_atol=2 * ONE_SAMPLE, loss_rtol=1e-3)


def _cohort(package, n=4, seed=7):
    """``tests/test_engine.py``'s ``_shared_cohort`` and ``_e2e_engine``:
    clients on one backbone, a server of seed 42."""
    backbone = j_init(jax.random.PRNGKey(seed), J_CLIENT)
    if package == "jax":
        ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
        clients = [JClient(i, J_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)),
                           num_classes=ds.num_classes, seed=i, local_steps=1, distill_steps=1,
                           initial_params=backbone) for i in range(n)]
        server = JServer(J_SERVER, aggregation="adaptive", distill_steps=2)
        return ds, JE2E(clients, J_CLIENT, server=server, num_classes=ds.num_classes,
                        local_steps=1, distill_steps=1, server_distill_steps=2)
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    shared = bridge.to_torch(jax.tree.map(np.asarray, backbone), "cpu")
    clients = [TClient(i, T_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)),
                       num_classes=ds.num_classes, seed=i, local_steps=1, distill_steps=1,
                       device="cpu", initial_params=shared) for i in range(n)]
    server = TServer(T_SERVER, aggregation="adaptive", distill_steps=2, device="cpu")
    return ds, TE2E(clients, T_CLIENT, server=server, num_classes=ds.num_classes, local_steps=1,
                    distill_steps=1, server_distill_steps=2, use_kernels=True)


SELS = [[0, 1], [2, 3]]


def _block_inputs(ds, package):
    sim = (JSim if package == "jax" else TSim)(4, (JChannel if package == "jax" else TChannel)(
        **_CHAN), seed=0)
    as_array = jnp.asarray if package == "jax" else torch.as_tensor
    pubs = [as_array(ds.tokens[:16]), as_array(ds.tokens[16:32])]
    states = [sim.states_batched(r, SELS[r]) for r in range(2)]
    return pubs, states, as_array(ds.tokens[300:364]), as_array(ds.labels[300:364])


@pytest.fixture(scope="module")
def blocks():
    """The port's engine after 2 ``run_round`` calls (with the host's eval
    after each) and after one 2-round ``run_rounds`` block, and the
    reference's engine after its block."""
    ds, a = _cohort("torch")
    _, b = _cohort("torch")
    pubs, states, ev_tok, ev_lab = _block_inputs(ds, "torch")
    evaluate_s, evaluate_c = make_eval_fn(T_SERVER, ds.num_classes), make_eval_fn(T_CLIENT, ds.num_classes)
    per_round, bcast = {"phases": [], "s": [], "c": [], "d": []}, None
    for r in range(2):
        per_round["phases"].append(a.run_round(SELS[r], pubs[r], bcast, states[r], adaptive_k=True,
                                               send_h=True))
        bcast = a.broadcast_state(pubs[r])
        a.sync_server()
        per_round["s"].append(evaluate_s(a.server.params, ev_tok, ev_lab))
        per_round["c"].append(evaluate_c(a.client_params(SELS[r][0]), ev_tok, ev_lab))
        per_round["d"].append(a.last_distill_loss)
    traj = b.run_rounds(SELS, pubs, states, adaptive_k=True, send_h=True, eval_tokens=ev_tok,
                        eval_labels=ev_lab)
    b.sync_server()
    j_ds, j_eng = _cohort("jax")
    j_pubs, j_states, j_tok, j_lab = _block_inputs(j_ds, "jax")
    j_traj = j_eng.run_rounds(SELS, j_pubs, j_states, adaptive_k=True, send_h=True,
                              eval_tokens=j_tok, eval_labels=j_lab)
    j_eng.sync_server()
    return a, per_round, b, traj, j_eng, j_traj


def test_run_rounds_matches_run_round(blocks):
    """The block leaves the fleet, the server and the broadcast where two
    ``run_round`` calls leave them, with the same accounting, and its
    in-block taps are the per-round host evaluation."""
    a, per_round, b, traj, _, _ = blocks
    assert b._store.shared
    p0, p1 = per_round["phases"]
    assert traj.ks == [p0.ks, p1.ks]
    assert [[p.bytes for p in pl] for pl in traj.payloads] == [
        [p.bytes for p in p0.payloads], [p.bytes for p in p1.payloads]]
    np.testing.assert_allclose(traj.server_acc, per_round["s"], atol=1e-6)
    np.testing.assert_allclose(traj.client_acc, per_round["c"], atol=1e-6)
    np.testing.assert_allclose(traj.distill_loss, per_round["d"], rtol=1e-4)
    np.testing.assert_allclose(traj.mean_k, [np.mean(p0.ks), np.mean(p1.ks)], rtol=1e-6)
    for i in range(4):
        for k, v in a.client_params(i).items():
            np.testing.assert_allclose(v.numpy(), b.client_params(i)[k].numpy(), atol=2e-5)
    for k, v in a.server.params.items():
        np.testing.assert_allclose(v.numpy(), b.server.params[k].numpy(), atol=2e-5)
    np.testing.assert_allclose(a._b_logits.numpy(), b._b_logits.numpy(), atol=1e-4)
    np.testing.assert_allclose(b.last_distill_loss, a.last_distill_loss, rtol=1e-4)


def test_run_rounds_matches_reference(blocks):
    """The port's block against the reference's ``run_rounds`` on the same
    cohort, channel and eval split: k and payload bytes identical, taps and
    advanced adapters within the module's bounds."""
    _, _, b, traj, j_eng, j_traj = blocks
    assert traj.ks == j_traj.ks
    assert [[p.bytes for p in pl] for pl in traj.payloads] == [
        [p.bytes for p in pl] for pl in j_traj.payloads]
    np.testing.assert_allclose(traj.server_acc, j_traj.server_acc, rtol=0, atol=ONE_SAMPLE)
    np.testing.assert_allclose(traj.client_acc, j_traj.client_acc, rtol=0, atol=ONE_SAMPLE)
    np.testing.assert_allclose(traj.distill_loss, j_traj.distill_loss, rtol=1e-4)
    np.testing.assert_allclose(traj.mean_k, j_traj.mean_k, rtol=1e-6)
    for cid in range(4):
        j_p = bridge.flatten(jax.tree.map(np.asarray, j_eng.client_params(cid)))
        for k, v in b.client_params(cid).items():
            if "lora" in k:
                assert np.linalg.norm(v.numpy() - j_p[k]) <= 1e-3 * np.linalg.norm(j_p[k]), k
    j_s = bridge.flatten(jax.tree.map(np.asarray, j_eng.server.params))
    for k, v in b.server.params.items():
        if "lora" in k:
            assert np.linalg.norm(v.numpy() - j_s[k]) <= 1e-3 * np.linalg.norm(j_s[k]), k


def test_scan_rounds_needs_the_whole_round_engine():
    """As the reference: ``scan_rounds`` on another engine is refused."""
    fed = _fed("scan-random-init", "torch")
    fed.engine = "batched"
    with pytest.raises(ValueError, match="scan_rounds requires engine='fused_e2e'"):
        t_rounds.run_federated(T_CLIENT, T_SERVER,
                               t_dataset(vocab_size=256, seq_len=12, total=500, seed=0), fed,
                               device="cpu")


@pytest.mark.parametrize("change,error,match", [
    (dict(eval_tokens=32, eval_labels=32), ValueError, "smaller than one eval batch"),
    (dict(eval_tokens=64), ValueError, "pass eval_tokens and eval_labels together"),
    (dict(sels=[[0, 1], [2]]), ValueError, "equal-size cohorts"),
    (dict(sels=[[0, 0], [2, 3]]), ValueError, "duplicate client ids"),
    (dict(channel_scan={}), ValueError, "channel_scan is missing key"),
], ids=["eval-split-under-one-batch", "eval-tokens-without-labels", "unequal-cohorts",
        "duplicate-client", "channel-scan"])
def test_run_rounds_refuses(change, error, match):
    """The reference's refusals, before any work: the fleet is left as it
    was."""
    ds, eng = _cohort("torch")
    pubs, states, ev_tok, ev_lab = _block_inputs(ds, "torch")
    kw = dict(sels=SELS, pubs=pubs, states_per_round=states)
    for key in ("eval_tokens", "eval_labels"):
        if key in change:
            kw[key] = (ev_tok if key == "eval_tokens" else ev_lab)[:change[key]]
    kw.update({k: v for k, v in change.items() if k not in ("eval_tokens", "eval_labels")})
    before = {k: v.clone() for k, v in eng._store.lora.items()}
    with pytest.raises(error, match=match):
        eng.run_rounds(adaptive_k=True, send_h=True, **kw)
    assert all(torch.equal(v, before[k]) for k, v in eng._store.lora.items())


def test_scan_eval_fn_is_the_host_eval_on_the_device():
    """The in-block eval tap walks the split in ``EVAL_BATCH`` chunks to the
    host evaluator's value, as a tensor, and refuses a split that is not a
    non-empty multiple of ``EVAL_BATCH``."""
    ds, eng = _cohort("torch")
    tokens, labels = torch.as_tensor(ds.tokens[:128]), torch.as_tensor(ds.labels[:128])
    lora, frozen = eng._store.client_row(1)
    acc = make_scan_eval_fn(T_CLIENT, ds.num_classes)
    got = acc(lora, frozen, tokens, labels)
    assert isinstance(got, torch.Tensor) and got.shape == ()
    want = make_eval_fn(T_CLIENT, ds.num_classes)(eng.client_params(1), tokens, labels)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-7)
    for n in (0, 96):
        with pytest.raises(ValueError, match="non-empty multiple of EVAL_BATCH"):
            acc(lora, frozen, tokens[:n], labels[:n])


def test_run_rounds_of_no_rounds_is_empty():
    """R = 0: the empty trajectory, and nothing moved."""
    ds, eng = _cohort("torch")
    _, _, ev_tok, ev_lab = _block_inputs(ds, "torch")
    before = {k: v.clone() for k, v in eng._store.lora.items()}
    traj = eng.run_rounds([], [], [], adaptive_k=True, send_h=True, eval_tokens=ev_tok,
                          eval_labels=ev_lab)
    assert (traj.ks, traj.payloads, traj.mean_k, traj.distill_loss) == ([], [], [], [])
    assert traj.server_acc == [] and traj.client_acc == []
    assert traj.snr_db is None and traj.family_client_acc is None
    assert all(torch.equal(v, before[k]) for k, v in eng._store.lora.items())
    assert eng.run_rounds([], [], [], adaptive_k=True, send_h=True).server_acc is None
