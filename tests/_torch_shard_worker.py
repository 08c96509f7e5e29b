"""The port's ``shard_clients`` runs for ``tests/test_torch_shard*.py``:
one process per rank over gloo on the CPU, started by ``spawn`` (this
module imports the port, torch and numpy only, so a rank starts without
JAX).

:func:`main` is the spawned entry: ranks 0 and 1 form a group of two,
index 2 a group of its own (world size 1).  Each writes what it computed
to ``{out}/rank{index}.pt``.  The same case functions run unsharded in the
test process (``tests/_torch_shard_checks.py``), which holds the two
against each other and the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.checkpoint.ckpt as t_ckpt
import repro_torch.fed.rounds as t_rounds
from repro_torch.configs.base import LoRAConfig
from repro_torch.configs.gpt2_paper import REDUCED_CLIENT, REDUCED_SERVER
from repro_torch.core import ChannelConfig, ChannelSimulator
from repro_torch.data import make_banking77_like
from repro_torch.fed import FedConfig, FusedE2EEngine, FusedEngine
from repro_torch.fed.client import Client
from repro_torch.fed.engines import BroadcastState
from repro_torch.fed.server import Server
from repro_torch.fed.store import HostFleetStore
from repro_torch.models import model as t_model

_LORA = LoRAConfig(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
CLIENT = REDUCED_CLIENT.with_overrides(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                                       d_ff=128, vocab_size=256, max_seq_len=32, lora=_LORA)
SERVER = REDUCED_SERVER.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2,
                                       d_ff=192, vocab_size=256, max_seq_len=32, lora=_LORA)
# (cfg, seed) of every init the engine cases draw: the clients' own, the
# shared backbone (7) and the server's default (42)
INITS = [(CLIENT, s) for s in (0, 1, 2, 3, 7)] + [(SERVER, 42)]
ENGINE_CASES = [(engine, quant, n) for engine in ("fused", "fused_e2e")
                for quant in (False, True) for n in (2, 3)]
BLOCK_SELS = [[0, 1, 2], [1, 2, 3]]
FED = dict(method="adald", engine="fused_e2e", num_clients=5, clients_per_round=3, rounds=3,
           public_size=64, public_batch=16, eval_size=64, local_steps=1, distill_steps=1,
           server_distill_steps=2, seed=0, pretrain_steps=0, use_kernels=True,
           channel=ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0))


def dataset():
    return make_banking77_like(vocab_size=256, seq_len=12, total=500, seed=0)


def init_from(path: str):
    """``models.init`` that returns the inits saved at ``path`` (flat
    ``{cfg name}/{seed}/{key}`` arrays), the bridged JAX init."""
    saved = np.load(path)

    def init(cfg, seed, device="cuda", **_):
        head = f"{cfg.name}/{seed}/"
        return {k[len(head):]: torch.as_tensor(saved[k], device=device)
                for k in saved.files if k.startswith(head)}

    return init


def _cohort(ds, n: int, shared: bool):
    backbone = t_model.init(CLIENT, 7, "cpu") if shared else None
    return [Client(i, CLIENT, ds.subset(np.arange(i * 60, (i + 1) * 60)),
                   num_classes=ds.num_classes, seed=i, local_steps=1, distill_steps=1,
                   device="cpu", initial_params=backbone) for i in range(n)]


def _engine(engine: str, clients, ds, quant: bool, shard: bool):
    kw = dict(num_classes=ds.num_classes, local_steps=1, distill_steps=1, quantize_wire=quant,
              shard_clients=shard, use_kernels=True)
    if engine == "fused":
        return FusedEngine(clients, CLIENT, **kw)
    return FusedE2EEngine(clients, CLIENT, server=Server(SERVER, distill_steps=2, device="cpu"),
                          server_distill_steps=2, **kw)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def _state(eng) -> dict:
    """The engine's whole trained state: fleet LoRA and Adam rows, and the
    server's (fused_e2e)."""
    fleet = eng.fleet_state()
    out = {"lora": fleet["lora"], "opt": fleet["opt"]}
    if hasattr(eng, "server_state"):
        srv = eng.server_state()
        out.update(s_lora=srv["s_lora"], s_opt=srv["s_opt"], b_logits=eng._b_logits)
    return _host(out)


def engine_case(engine: str, quant: bool, n: int, shard: bool) -> dict:
    """Two rounds of ``run_round`` on a cohort of ``n``: the cold round, then
    a warm one (``fused``: a seeded broadcast; ``fused_e2e``: its own).
    ``fused`` clients keep their own backbones, ``fused_e2e`` share one."""
    ds = dataset()
    eng = _engine(engine, _cohort(ds, n, shared=engine == "fused_e2e"), ds, quant, shard)
    sim = ChannelSimulator(4, ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0), seed=0)
    sel = list(range(n))
    rounds, bcast = [], None
    for rnd in range(2):
        pub = torch.as_tensor(ds.tokens[16 * rnd:16 * (rnd + 1)])
        phase = eng.run_round(sel, pub, bcast, sim.states_batched(rnd, sel), adaptive_k=True,
                              send_h=True)
        up = phase.sparse._asdict() if engine == "fused_e2e" else {"dense": phase.dense,
                                                                   "h": phase.h}
        rounds.append(dict(ks=list(phase.ks), bytes=[p.bytes for p in phase.payloads],
                           tx=[p.client_id for p in phase.payloads], uplink=_host(up)))
        if engine == "fused_e2e":
            bcast = eng.broadcast_state(pub)
        else:
            rng = np.random.default_rng(5)
            g_logits, g_h = rng.normal(size=(16, 256)), rng.normal(size=(16, 4))
            bcast = BroadcastState(tokens=pub, bits=0,
                                   logits=torch.as_tensor(g_logits, dtype=torch.float32),
                                   h=torch.as_tensor(g_h, dtype=torch.float32))
    return dict(rounds=rounds, state=_state(eng))


def block_case(shard: bool) -> dict:
    """``run_rounds`` over :data:`BLOCK_SELS` with the eval tap, as the
    reference's two-device test drives it."""
    ds = dataset()
    eng = _engine("fused_e2e", _cohort(ds, 4, shared=True), ds, False, shard)
    sim = ChannelSimulator(4, ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0), seed=0)
    traj = eng.run_rounds(
        BLOCK_SELS, [torch.as_tensor(ds.tokens[:16]), torch.as_tensor(ds.tokens[16:32])],
        [sim.states_batched(r, sel) for r, sel in enumerate(BLOCK_SELS)],
        adaptive_k=True, send_h=True, eval_tokens=torch.as_tensor(ds.tokens[300:364]),
        eval_labels=torch.as_tensor(ds.labels[300:364]))
    return dict(ks=traj.ks, bytes=[[p.bytes for p in ps] for ps in traj.payloads],
                server_acc=traj.server_acc, client_acc=traj.client_acc,
                distill_loss=traj.distill_loss, state=_state(eng))


def fed_case(shard: bool, ckpt_dir: str | None = None) -> dict:
    """``run_federated`` on the host store, a cohort of 3, 3 rounds: the
    rows each rank hinted, the rows it fetched and whether the fetch found
    them staged, and the files it wrote."""
    hints, hits, writes = [], [], []
    take, save_step, save = (HostFleetStore._take_prefetched, t_ckpt.save_step, t_ckpt.save)
    prefetch = HostFleetStore.prefetch

    def hinting(self, sel):
        hints.append(list(sel))
        return prefetch(self, sel)

    def taking(self, sel):
        got = take(self, sel)
        hits.append((list(sel), got is not None))
        return got

    def counting(fn):
        def call(path, *args, **kwargs):
            writes.append(os.path.basename(str(path)))
            return fn(path, *args, **kwargs)
        return call

    HostFleetStore._take_prefetched, HostFleetStore.prefetch = taking, hinting
    t_ckpt.save_step, t_ckpt.save = counting(save_step), counting(save)
    try:
        run = t_rounds.run_federated(CLIENT, SERVER, dataset(),
                                     FedConfig(fleet_store="host", shard_clients=shard, **FED),
                                     device="cpu", ckpt_dir=ckpt_dir)
    finally:
        HostFleetStore._take_prefetched, HostFleetStore.prefetch = take, prefetch
        t_ckpt.save_step, t_ckpt.save = save_step, save
    return dict(per_client_k=run.per_client_k, server_acc=run.server_acc,
                client_acc=run.client_acc, distill_loss=run.distill_loss,
                bytes=[(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                       for r in run.ledger.rounds], hints=hints, hits=hits, writes=writes)


def main(index: int, rdzv: str, out: str, inits: str, engine: str) -> None:
    """Ranks 0 and 1 of a gloo group of two run ``engine``'s cases sharded,
    and its multi-round case (``fused``: the federation on the host store,
    both ranks writing to one checkpoint directory; ``fused_e2e``: the
    block); index 2, a group of one, runs the engine cases, and for
    ``fused`` the federation, sharded AND unsharded."""
    torch.set_num_threads(1)
    world, rank = (1, 0) if index == 2 else (2, index)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}.{world}", rank=rank,
                            world_size=world)
    cases = [c for c in ENGINE_CASES if c[0] == engine]
    own_init, t_model.init = t_model.init, init_from(inits)
    try:
        res = {"engine": {c: engine_case(*c, shard=True) for c in cases}}
        if world == 1:
            res["unsharded_engine"] = {c: engine_case(*c, shard=False) for c in cases}
        elif engine == "fused_e2e":
            res["block"] = block_case(True)
        t_model.init = own_init  # the federation draws the port's own init
        if engine == "fused" and world == 1:
            res["fed"], res["unsharded_fed"] = fed_case(True), fed_case(False)
        elif engine == "fused":
            res["fed"] = fed_case(True, ckpt_dir=os.path.join(out, "ckpt"))
        torch.save(res, os.path.join(out, f"rank{index}.pt"))
    finally:
        t_model.init = own_init
        dist.destroy_process_group()
