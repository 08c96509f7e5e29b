"""The port's multi-round block on a mixed fleet,
``HeteroFusedE2EEngine.run_rounds``, against the reference's ``run_rounds``
and against the port's own rounds one at a time, on the CPU, on the float
and the int8 wire.

The fleet: three families at the widths of ``tests/test_torch_ssm_fleet.py``
and ``tests/_torch_modal.py`` (a 2-layer GPT-2 at d 64; mamba2's smoke at d
64, state 16; seamless's smoke at d 64, GQA 4/2, 8 stub frames), each on
vocabulary 256 with LoRA rank 4 on q, v and the head; 6 clients, client i
of family i % 3, the dense family on one shared backbone, the others on a
backbone each; a 2-layer GPT-2 server at d 96.  Three hand-chosen cohorts
of 3: the audio family sits round 0 out, the dense family round 1, and
rounds 0 and 1 hold two clients of one family; the constrained channel of
``tests/test_hetero.py``, so k varies by client.  Both packages start from
the reference's init, bridged, and the port's stub frontend is the
reference's draw (``_torch_modal``).

Against the reference's block (``tests/test_torch_rounds_block.py``'s
bounds, for its reasons): per-client k, payload bytes and transmitters
identical; ``server_acc``, ``client_acc`` and every ``family_client_acc``
entry within one eval sample (1/64), since a last-bit difference in a
logit can flip one sample's argmax; ``distill_loss`` within rtol 1e-4; the
advanced LoRA leaves within 1e-3 in relative L2 norm: their B factors start
at zero and hold a few Adam steps of size lr, each step normalised, so a
relative difference in a gradient reaches them undiminished.

Against the port's own rounds one at a time (the reference's contract for
its scan, ``tests/test_hetero.py``): accuracies within 1e-6, the distill
loss within rtol 1e-4, parameters within 2e-5.  The block's union wire is
in bucket order, the per-round path's in cohort order, so the server sums
the same rows in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_modal import reference_frontend  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS  # noqa: E402
from repro.core import ChannelConfig as JChannel  # noqa: E402
from repro.core import ChannelSimulator as JSim  # noqa: E402
from repro.data import make_banking77_like as j_dataset  # noqa: E402
from repro.fed import HeteroFusedE2EEngine as JHetero  # noqa: E402
from repro.fed.client import Client as JClient  # noqa: E402
from repro.fed.server import Server as JServer  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import LoRAConfig as TLoRA  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSM  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT as T_RC  # noqa: E402
from repro_torch.configs.gpt2_paper import REDUCED_SERVER as T_RS  # noqa: E402
from repro_torch.core import ChannelConfig as TChannel  # noqa: E402
from repro_torch.core import ChannelSimulator as TSim  # noqa: E402
from repro_torch.data import make_banking77_like as t_dataset  # noqa: E402
from repro_torch.fed import HeteroFusedE2EEngine as THetero  # noqa: E402
from repro_torch.fed.client import Client as TClient  # noqa: E402
from repro_torch.fed.server import Server as TServer  # noqa: E402
from repro_torch.fed.steps import make_eval_fn  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))


def _families(smoke, rc, rs, lora_cls, ssm_cls):
    lora = lora_cls(**_LORA)
    dense = rc.with_overrides(name="b-dense", num_layers=2, d_model=64, num_heads=2,
                              num_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=32, lora=lora)
    ssm = smoke("mamba2-130m").with_overrides(
        name="b-ssm", d_model=64, vocab_size=256, max_seq_len=32, lora=lora,
        ssm=ssm_cls(state_dim=16, head_dim=16, expand=2, chunk_size=4))
    audio = smoke("seamless-m4t-large-v2").with_overrides(
        name="b-audio", d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, frontend_len=8,
        vocab_size=256, max_seq_len=32, lora=lora)
    server = rs.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192,
                               vocab_size=256, max_seq_len=32, lora=lora)
    return [dense, ssm, audio], server


J_FAMS, J_SERVER = _families(j_smoke, J_RC, J_RS, JLoRA, JSSM)
T_FAMS, T_SERVER = _families(t_smoke, T_RC, T_RS, TLoRA, TSSM)
TO_JAX = dict(zip(T_FAMS + [T_SERVER], J_FAMS + [J_SERVER]))
_CHAN = dict(bandwidth_hz=2e5, mean_snr_db=2.0)
N_CLIENTS, EVAL = 6, 64
ONE_SAMPLE = 1.0 / EVAL + 1e-9
# the audio family (2, 5) sits round 0 out, the dense one (0, 3) round 1
SELS = [[3, 1, 0], [5, 2, 4], [4, 0, 2]]


_INITS: dict = {}  # (config, seed) -> the reference's init as numpy, drawn once


def _bridged_init(cfg, seed, device="cuda", **_):
    if (cfg, seed) not in _INITS:
        _INITS[cfg, seed] = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), TO_JAX[cfg]))
    return bridge.to_torch(jax.tree.map(np.copy, _INITS[cfg, seed]), device)


@pytest.fixture(autouse=True, scope="module")
def bridged():
    mp = pytest.MonkeyPatch()
    mp.setattr(t_model, "init", _bridged_init)
    yield
    mp.undo()


def _engine(package, quantize):
    """The fleet, its server and the mixed-fleet e2e engine in ``package``."""
    dense_backbone = j_init(jax.random.PRNGKey(7), J_FAMS[0])
    kw = dict(local_steps=1, distill_steps=1)
    if package == "jax":
        ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
        clients = [JClient(i, J_FAMS[i % 3], ds.subset(np.arange(i * 40, (i + 1) * 40)),
                           num_classes=ds.num_classes, seed=i,
                           initial_params=dense_backbone if i % 3 == 0 else None, **kw)
                   for i in range(N_CLIENTS)]
        server = JServer(J_SERVER, aggregation="adaptive", distill_steps=2)
        return ds, JHetero(clients, server=server, num_classes=ds.num_classes,
                           server_distill_steps=2, quantize_wire=quantize, **kw)
    ds = t_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    shared = bridge.to_torch(jax.tree.map(np.asarray, dense_backbone), "cpu")
    clients = [TClient(i, T_FAMS[i % 3], ds.subset(np.arange(i * 40, (i + 1) * 40)),
                       num_classes=ds.num_classes, seed=i, device="cpu",
                       initial_params=shared if i % 3 == 0 else None, **kw)
               for i in range(N_CLIENTS)]
    server = TServer(T_SERVER, aggregation="adaptive", distill_steps=2, device="cpu")
    return ds, THetero(clients, server=server, num_classes=ds.num_classes,
                       server_distill_steps=2, use_kernels=True, quantize_wire=quantize, **kw)


def _inputs(ds, package):
    sim = (JSim if package == "jax" else TSim)(N_CLIENTS, (JChannel if package == "jax"
                                                           else TChannel)(**_CHAN), seed=0)
    as_array = jnp.asarray if package == "jax" else torch.as_tensor
    pubs = [as_array(ds.tokens[16 * r:16 * (r + 1)]) for r in range(len(SELS))]
    states = [sim.states_batched(r, sel) for r, sel in enumerate(SELS)]
    return pubs, states, as_array(ds.tokens[300:364]), as_array(ds.labels[300:364])


def _per_round(ds, eng):
    """The port's rounds one at a time, each followed by the host's
    evaluation of the server, the round's first client and each family's
    tap client."""
    pubs, states, ev_tok, ev_lab = _inputs(ds, "torch")
    evaluate_s = make_eval_fn(T_SERVER, ds.num_classes)
    evaluate_f = [make_eval_fn(cfg, ds.num_classes) for cfg in T_FAMS]
    out, bcast = {"phases": [], "s": [], "c": [], "fam": [], "d": []}, None
    for r, sel in enumerate(SELS):
        out["phases"].append(eng.run_round(sel, pubs[r], bcast, states[r], adaptive_k=True,
                                           send_h=True))
        bcast = eng.broadcast_state(pubs[r])
        eng.sync_server()
        out["s"].append(evaluate_s(eng.server.params, ev_tok, ev_lab))
        out["c"].append(evaluate_f[sel[0] % 3](eng.client_params(sel[0]), ev_tok, ev_lab))
        taps = [next((c for c in sel if c % 3 == f), f) for f in range(3)]
        out["fam"].append([evaluate_f[f](eng.client_params(c), ev_tok, ev_lab)
                           for f, c in enumerate(taps)])
        out["d"].append(eng.last_distill_loss)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["float", "int8"])
def blocks(request):
    """The port's block, the port's rounds one at a time and the
    reference's block, each from a fresh fleet, on one wire."""
    quantize = request.param
    ds, loop = _engine("torch", quantize)
    per_round = _per_round(ds, loop)
    _, block = _engine("torch", quantize)
    pubs, states, ev_tok, ev_lab = _inputs(ds, "torch")
    traj = block.run_rounds(SELS, pubs, states, adaptive_k=True, send_h=True, eval_tokens=ev_tok,
                            eval_labels=ev_lab)
    block.sync_server()
    j_ds, j_eng = _engine("jax", quantize)
    j_pubs, j_states, j_tok, j_lab = _inputs(j_ds, "jax")
    j_traj = j_eng.run_rounds(SELS, j_pubs, j_states, adaptive_k=True, send_h=True,
                              eval_tokens=j_tok, eval_labels=j_lab)
    j_eng.sync_server()
    return loop, per_round, block, traj, j_eng, j_traj


def test_the_block_is_the_references(blocks):
    _, _, block, traj, j_eng, j_traj = blocks
    assert traj.ks == j_traj.ks
    assert len({k for ks in traj.ks for k in ks}) > 2  # the budgets vary
    assert [[(p.client_id, p.bytes) for p in pl] for pl in traj.payloads] == [
        [(p.client_id, p.bytes) for p in pl] for pl in j_traj.payloads]
    np.testing.assert_allclose(traj.server_acc, j_traj.server_acc, rtol=0, atol=ONE_SAMPLE)
    np.testing.assert_allclose(traj.client_acc, j_traj.client_acc, rtol=0, atol=ONE_SAMPLE)
    np.testing.assert_allclose(traj.family_client_acc, j_traj.family_client_acc, rtol=0,
                               atol=ONE_SAMPLE)
    np.testing.assert_allclose(traj.distill_loss, j_traj.distill_loss, rtol=1e-4)
    np.testing.assert_allclose(traj.mean_k, j_traj.mean_k, rtol=1e-6)
    trees = [(block.client_params(c), j_eng.client_params(c)) for c in range(N_CLIENTS)]
    for got, want in trees + [(block.server.params, j_eng.server.params)]:
        want = bridge.flatten(jax.tree.map(np.asarray, want))
        for k, v in got.items():
            if "lora" in k:
                assert np.linalg.norm(v.numpy() - want[k]) <= 1e-3 * np.linalg.norm(want[k]), k


def test_the_block_is_the_per_round_path(blocks):
    loop, per_round, block, traj, _, _ = blocks
    assert traj.ks == [p.ks for p in per_round["phases"]]
    assert [[p.bytes for p in pl] for pl in traj.payloads] == [
        [p.bytes for p in ph.payloads] for ph in per_round["phases"]]
    np.testing.assert_allclose(traj.server_acc, per_round["s"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(traj.client_acc, per_round["c"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(traj.family_client_acc, per_round["fam"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(traj.distill_loss, per_round["d"], rtol=1e-4)
    np.testing.assert_allclose(traj.mean_k, [np.mean(p.ks) for p in per_round["phases"]],
                               rtol=1e-6)
    for c in range(N_CLIENTS):
        for k, v in loop.client_params(c).items():
            np.testing.assert_allclose(v.numpy(), block.client_params(c)[k].numpy(), atol=2e-5)
    for k, v in loop.server.params.items():
        np.testing.assert_allclose(v.numpy(), block.server.params[k].numpy(), atol=2e-5)
    np.testing.assert_allclose(loop._b_logits.numpy(), block._b_logits.numpy(), atol=1e-4)


def test_the_family_tap(blocks):
    """One accuracy a family a round; ``client_acc`` is the entry of the
    round's first client's family; a family that sat a round out reports
    its local client 0, untouched by the round."""
    _, _, block, traj, _, _ = blocks
    assert [b.client_ids for b in block.buckets] == [(0, 3), (1, 4), (2, 5)]
    assert [len(row) for row in traj.family_client_acc] == [3, 3, 3]
    assert traj.client_acc == [traj.family_client_acc[r][SELS[r][0] % 3] for r in range(3)]
    # round 0's audio entry: its local client 0, client 2, as the fleet began
    ds, fresh = _engine("torch", False)
    _, _, ev_tok, ev_lab = _inputs(ds, "torch")
    untouched = make_eval_fn(T_FAMS[2], ds.num_classes)(fresh.client_params(2), ev_tok, ev_lab)
    assert abs(traj.family_client_acc[0][2] - untouched) <= 1e-6
