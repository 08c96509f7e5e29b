"""What ``tests/test_torch_shard.py`` (``fused``) and
``tests/test_torch_shard_e2e.py`` (``fused_e2e``) share: the spawned ranks,
the reference's unsharded engine cases, and the checks.

Three processes are spawned once a file (``tests/_torch_shard_worker.py``):
two ranks of a gloo group, and one rank alone (world size 1).  They run
the engine's cases with ``shard_clients=True`` (the float and the int8
wire, cohorts of 2, one row a rank, and of 3, one pad row; two rounds each,
the cold round then a warm one; from the bridged JAX init), and its
multi-round case.  The test process runs the same cases unsharded, in the
port and in the reference.

Integers (per-client k, payload bytes, transmitters, wire masks) must be
identical.  Floats are held per leaf in relative L2 norm: within
:data:`TO_PORT` (1e-4) of the port's unsharded round (a rank computes its
block's 1 or 2 rows where the unsharded round computes 2 or 3, and CPU
matmuls over another batch round differently in the last bit; Adam's
normalised step carries such a bit into the LoRA leaves at up to lr: the
bound of ``test_torch_round.py``, whose server LoRA leaves drift so from
the reference; these cases stay under 1e-5, a head adapter's B factor
after 2 rounds of 2 local steps reaches 1.4e-5), and
within :data:`TO_REF` (1e-3) of the reference's, ``test_torch_rounds_block.py``'s
bound for LoRA leaves after two rounds (their B factors start at zero, so a
relative gradient difference reaches them undiminished).  The reference's
own sharded test misses its elementwise atol of 1e-5 by one element of
1 024 (1.74e-5) on this tree, a last-bit drift of the same kind: a norm per
leaf is what such a drift cannot break.  Both ranks' states are
``torch.equal``, and at world size 1 sharded equals unsharded bit for bit.
"""

import numpy as np
import torch
import torch.multiprocessing as tmp

import jax
import jax.numpy as jnp

import _torch_shard_worker as w
from repro.configs.base import LoRAConfig as JLoRA
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC
from repro.configs.gpt2_paper import REDUCED_SERVER as J_RS
from repro.core import ChannelConfig as JChannel
from repro.core import ChannelSimulator as JSim
from repro.data import make_banking77_like as j_dataset
from repro.fed.client import Client as JClient
from repro.fed.engines import BroadcastState as JBcast
from repro.fed.engines import FusedE2EEngine as JE2E
from repro.fed.engines import FusedEngine as JFused
from repro.fed.server import Server as JServer
from repro.models import init as j_init
from repro_torch import bridge
from repro_torch.models import model as t_model

_LORA = dict(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
J_CLIENT = J_RC.with_overrides(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                               vocab_size=256, max_seq_len=32, lora=JLoRA(**_LORA))
J_SERVER = J_RS.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2, d_ff=192,
                               vocab_size=256, max_seq_len=32, lora=JLoRA(**_LORA))
J_CFG = {w.CLIENT.name: J_CLIENT, w.SERVER.name: J_SERVER}
TO_PORT, TO_REF = 1e-4, 1e-3  # relative L2 per leaf (see the module docstring)


def cases(engine: str) -> list:
    return [c for c in w.ENGINE_CASES if c[0] == engine]


def case_ids(engine: str) -> list[str]:
    return [f"{e}-{'int8' if q else 'float'}-{n}" for e, q, n in cases(engine)]


def ref_engine_case(engine: str, quant: bool, n: int) -> dict:
    """``_torch_shard_worker.engine_case`` in the reference, unsharded (its
    jnp top-k and wire aggregation: the same semantics as its kernels, at
    a fraction of the CPU compile time)."""
    ds = j_dataset(vocab_size=256, seq_len=12, total=500, seed=0)
    backbone = j_init(jax.random.PRNGKey(7), J_CLIENT) if engine == "fused_e2e" else None
    clients = [JClient(i, J_CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)),
                       num_classes=ds.num_classes, seed=i, local_steps=1, distill_steps=1,
                       initial_params=backbone) for i in range(n)]
    kw = dict(num_classes=ds.num_classes, local_steps=1, distill_steps=1, quantize_wire=quant)
    eng = (JFused(clients, J_CLIENT, **kw) if engine == "fused" else
           JE2E(clients, J_CLIENT, server=JServer(J_SERVER, distill_steps=2),
                server_distill_steps=2, **kw))
    sim = JSim(4, JChannel(bandwidth_hz=2e5, mean_snr_db=2.0), seed=0)
    sel, rounds, bcast = list(range(n)), [], None
    for rnd in range(2):
        pub = jnp.asarray(ds.tokens[16 * rnd:16 * (rnd + 1)])
        phase = eng.run_round(sel, pub, bcast, sim.states_batched(rnd, sel), adaptive_k=True,
                              send_h=True)
        up = ({"values": phase.sparse.values, "mask": phase.sparse.mask}
              if engine == "fused_e2e" else {"dense": phase.dense, "h": phase.h})
        rounds.append(dict(ks=list(phase.ks), bytes=[p.bytes for p in phase.payloads],
                           tx=[p.client_id for p in phase.payloads],
                           uplink={k: np.asarray(v) for k, v in up.items()}))
        if engine == "fused_e2e":
            bcast = eng.broadcast_state(pub)
        else:
            rng = np.random.default_rng(5)
            bcast = JBcast(tokens=pub, bits=0,
                           logits=jnp.asarray(rng.normal(size=(16, 256)), jnp.float32),
                           h=jnp.asarray(rng.normal(size=(16, 4)), jnp.float32))
    state = {"lora": [bridge.flatten(jax.tree.map(np.asarray, eng.client_params(i)))
                      for i in sel]}
    if engine == "fused_e2e":
        state.update(s_lora=bridge.flatten(jax.tree.map(np.asarray, eng._s_lora)),
                     b_logits=np.asarray(eng._b_logits))
    return dict(rounds=rounds, state=state)


def shard_runs(root, engine: str) -> dict:
    """The spawned ranks' results, the port's unsharded cases (from the
    bridged init) and the reference's."""
    inits = str(root / "inits.npz")
    np.savez(inits, **{f"{cfg.name}/{seed}/{k}": v for cfg, seed in w.INITS
                       for k, v in bridge.flatten(jax.tree.map(
                           np.asarray, j_init(jax.random.PRNGKey(seed), J_CFG[cfg.name]))).items()})
    tmp.spawn(w.main, args=(str(root / "rdzv"), str(root), inits, engine), nprocs=3)
    out = dict(ranks=[torch.load(root / f"rank{i}.pt", weights_only=False) for i in range(3)],
               ckpt=str(root / "ckpt"))
    own_init, t_model.init = t_model.init, w.init_from(inits)
    try:
        out["engine"] = {c: w.engine_case(*c, shard=False) for c in cases(engine)}
        if engine == "fused_e2e":
            out["block"] = w.block_case(False)
    finally:
        t_model.init = own_init
    if engine == "fused":
        out["fed"] = w.fed_case(False)
    out["ref"] = {c: ref_engine_case(*c) for c in cases(engine)}
    return out


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)  # NaN equals NaN


def _mask(up) -> np.ndarray:
    return np.asarray(up["mask"]) if "mask" in up else np.asarray(up["dense"]) != 0


def check_integers(runs: dict, case) -> None:
    """k, bytes, transmitters and wire masks: the port's and the
    reference's unsharded rounds'."""
    got = runs["ranks"][0]["engine"][case]["rounds"]
    for want in (runs["engine"][case]["rounds"], runs["ref"][case]["rounds"]):
        assert [(r["ks"], r["bytes"], r["tx"]) for r in got] == [
            (r["ks"], r["bytes"], r["tx"]) for r in want]
        for g, u in zip(got, want):
            np.testing.assert_array_equal(_mask(g["uplink"]), _mask(u["uplink"]))
    assert any(k > 0 for r in got for k in r["ks"])


def check_port_floats(runs: dict, case) -> None:
    got, want = runs["ranks"][0]["engine"][case], runs["engine"][case]
    for g, u in zip(got["rounds"], want["rounds"]):
        for k, v in u["uplink"].items():
            if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
                assert rel(g["uplink"][k], v) <= TO_PORT, k
    for part in ("lora", "s_lora"):  # the Adam moments follow their parameters
        for k, v in want["state"].get(part, {}).items():
            assert rel(got["state"][part][k], v) <= TO_PORT, (part, k)
    if "b_logits" in want["state"]:
        assert rel(got["state"]["b_logits"], want["state"]["b_logits"]) <= TO_PORT


def check_ref_floats(runs: dict, case) -> None:
    got, ref = runs["ranks"][0]["engine"][case], runs["ref"][case]
    for g, j in zip(got["rounds"], ref["rounds"]):
        name = "values" if "values" in j["uplink"] else "dense"  # int8 codes on the int8 wire
        assert rel(g["uplink"][name], j["uplink"][name]) <= TO_REF
    for i, j_params in enumerate(ref["state"]["lora"]):
        for k, v in got["state"]["lora"].items():
            assert rel(v[i], j_params[k]) <= TO_REF, (i, k)
    if "s_lora" in ref["state"]:
        assert got["state"]["s_lora"].keys() == ref["state"]["s_lora"].keys()
        for k, v in got["state"]["s_lora"].items():
            assert rel(v, ref["state"]["s_lora"][k]) <= TO_REF, k
        assert rel(got["state"]["b_logits"], ref["state"]["b_logits"]) <= TO_REF


def check_ranks_equal(runs: dict) -> None:
    r0, r1 = runs["ranks"][:2]
    assert r0.keys() == r1.keys()
    for key in r0:
        if key == "fed":  # each rank's own hints and writes differ by design
            for k in ("per_client_k", "server_acc", "client_acc", "distill_loss", "bytes"):
                assert r0[key][k] == r1[key][k], k
        else:
            assert equal(r0[key], r1[key]), key


def check_world_one(runs: dict) -> None:
    alone = runs["ranks"][2]
    assert equal(alone["engine"], alone["unsharded_engine"])
    if "fed" in alone:
        for key in ("per_client_k", "server_acc", "client_acc", "distill_loss", "bytes", "hits"):
            assert equal(alone["fed"][key], alone["unsharded_fed"][key]), key
