"""Multi-pod dry run: trace every (arch x shape x mesh) at full size over a
fake world of 256 or 512 ranks, allocating nothing — the port of
``repro/launch/dryrun.py``.

The reference has XLA lower and compile each step over 512 fake host
devices and reads the compiled program's memory and cost analyses and
the collectives in its post-SPMD HLO.  PyTorch has no SPMD compiler to
ask, so for each combination this driver:

  1. starts a fake process group of 256 (16x16) or 512 (2x16x16) ranks,
     this process being rank 0, and builds the production mesh on it;
  2. builds the parameters (:func:`repro_torch.models.model.param_shapes`),
     the AdamW state and the inputs (:func:`policy.input_specs`) as
     ``meta`` tensors, distributed as DTensors by the spec rules
     (:mod:`repro_torch.sharding`);
  3. runs the train, prefill or decode step eagerly on them, with the
     activation rules installed, under :class:`StepAccounting` and
     ``MemTracker``;
  4. writes one JSON record, the reference's schema, to
     ``experiments/dryrun/``.

What each number is.  Every count is rank 0's: the local shards' work
(a DTensor runs each op as a local op on its shard, plus the collectives
its redistributions need), so a combo whose batch does not divide the
batch axes computes replicated and is not the logical count over the
ranks.  ``memory``: ``argument_size_in_bytes`` the exact sum of rank 0's
shards of the step's inputs; ``output_size_in_bytes`` its shards of the
step's outputs; ``alias_size_in_bytes`` the output bytes that are input
storage (the decode cache, written in place); ``temp_size_in_bytes`` the
peak of what the step allocates above its arguments (``MemTracker``'s
peak on the shards' device, outputs included); ``generated_code_size_in_
bytes`` ``null`` (eager runs no generated program).  ``cost``: ``flops``
what ``torch.utils.flop_counter`` counts (matmuls, convolutions,
attention), where XLA counts every op; ``bytes accessed`` every non-view
op's inputs read and outputs written once, unfused.  ``collectives``: the
result bytes of each collective DTensor issues, under the reference's
keys.  ``compile_s`` is ``null``: eager has no compile; ``lower_s`` is the
trace.  A combo whose arguments plus temp exceed the card's memory
(``H100["hbm_bytes"]``) traces all the same and is named in a warning.
A train step rematerialises as ``cfg.remat`` asks (every full config
does): the recompute runs inside the step's backward, under the same
accounting and activation rules, so ``temp_size_in_bytes`` is the remat'd
step's peak and ``flops`` and the collectives count the recompute too, as
XLA's analyses of a remat'd step do.

The shards are ``meta`` tensors and not fake ones: DTensor's sharding
propagator runs each op once more on global-shape fake tensors, and only
with the shards on ``meta`` can the accounting tell that run from the
shard's own op (``MemTracker``'s peak is read on ``meta`` for the same
reason).  The dry run starts a fake process group: run it in a process of
its own (its CLI, or a spawned process).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod] [--device cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 4]
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --cost-mode
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as sh
from repro_torch.configs import ARCHITECTURES
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import H100, PRODUCTION_SHAPES, make_host_mesh
from repro_torch.launch.policy import arch_shape_config, input_specs, window_for

__all__ = ["COLLECTIVES", "StepAccounting", "collective_bytes", "start_fake_world", "step_args",
           "trace_combo", "run_one", "peak_bytes", "run_cost", "main"]

DEFAULT_OUT = "experiments/dryrun"
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor", "c10d")


def _collective_kind(func) -> str | None:
    """The reference's key of a collective op, or None for any other op
    (``wait_tensor`` included)."""
    ns, name = func.namespace, func._overloadpacket.__name__
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("all_reduce") or name.startswith("allreduce"):
        return "all-reduce"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if name.startswith(("broadcast", "permute", "send", "recv")):
        return "collective-permute"
    return None


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class StepAccounting(TorchDispatchMode):
    """Counts what one rank computes: the flops, bytes and collectives of
    the local ops a DTensor program runs on its shards.

    A DTensor op comes here first and is handed back (``NotImplemented``),
    so DTensor runs it as local ops on the shards, which come here again
    and are counted; an op on fake tensors is DTensor's sharding
    propagation on the global shapes, and is not.  Plain tensors (one
    device, no mesh) are counted as they are."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {c: 0 for c in COLLECTIVES}
        self.collectives["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(x, FakeTensor) for x in ins):
            return out
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] += sum(x.numel() * x.element_size() for x in outs)
            self.collectives["count"] += 1
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and outs:
            self.bytes_accessed += sum(x.numel() * x.element_size() for x in ins + outs)
        return out

    def record(self) -> tuple[dict, dict]:
        """``(cost, collectives)`` in the reference's keys."""
        return ({"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed)},
                dict(self.collectives))


def collective_bytes(fn, *args, **kwargs) -> dict[str, int]:
    """Per-collective-kind result-payload bytes (and ``count``) of the
    collectives ``fn(*args, **kwargs)`` issues on this rank: the port's
    counterpart of the reference's post-SPMD HLO parser."""
    with StepAccounting() as acc:
        fn(*args, **kwargs)
    return acc.record()[1]


def start_fake_world(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _batch_shardable(shape: ShapeConfig, mesh) -> bool:
    sizes = dict(zip(sh.axis_names(mesh), mesh.shape))
    return shape.global_batch % math.prod(sizes[a] for a in sh.batch_axes(mesh)) == 0


def _alias_bytes(outs, ins) -> int:
    """Bytes of the outputs' local shards that are input storage."""
    from torch.distributed.tensor import DTensor

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    seen = {local(x).untyped_storage()._cdata for x in _tensors(ins)}
    return sum(local(x).numel() * local(x).element_size() for x in _tensors(outs)
               if local(x).untyped_storage()._cdata in seen)


def step_args(cfg: ModelConfig, shape: ShapeConfig, mesh) -> tuple:
    """``(step, args)`` of one step of ``cfg`` at ``shape``, as the
    reference's ``lower_combo`` picks them: the train step on the
    parameters, the AdamW state and the batch, the prefill step on the
    parameters and the batch, or the decode step on the parameters, the
    cache and the token.  Every argument is a ``meta`` DTensor placed on
    ``mesh`` by the spec rules; a batch that the batch axes do not divide
    (long_500k's 1) is replicated."""
    from repro_torch.launch.steps import init_train_opt, make_train_step
    from repro_torch.models.model import param_shapes
    from repro_torch.serve.steps import make_decode_step, make_prefill_step

    w = window_for(cfg, shape)
    shardable = _batch_shardable(shape, mesh)
    meta_params = param_shapes(cfg)
    pspecs = sh.param_specs(meta_params, mesh)
    params = sh.distribute_tree(meta_params, pspecs, mesh)
    specs = input_specs(cfg, shape, mesh)
    bspecs = sh.batch_specs(mesh, batch_shardable=shardable,
                            with_frontend=cfg.frontend != "none", with_labels=False)
    if shape.kind == "train":
        opt = init_train_opt(meta_params, cfg)
        opt = sh.distribute_tree(opt, sh.opt_state_specs(pspecs, master=opt.master is not None),
                                 mesh)
        return make_train_step(cfg), (params, opt, sh.distribute_tree(specs["batch"], bspecs,
                                                                        mesh))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, window=w),
                (params, sh.distribute_tree(specs["batch"], bspecs, mesh)))
    cspecs = sh.cache_specs(specs["cache"], mesh, batch_shardable=shardable)
    tspec = (bspecs["tokens"][0],)  # the token is (B,)
    return make_decode_step(cfg, window=w), (
        params, sh.distribute_tree(specs["cache"], cspecs, mesh),
        sh.distribute_tree(specs["token"], tspec, mesh))


def trace_combo(arch: str, shape: ShapeConfig, mesh, *, cfg_override: ModelConfig | None = None
                ) -> dict:
    """Trace one step of ``arch`` at ``shape`` on ``mesh`` (a mesh over the
    process group the caller started), the shards on ``meta``.  Returns
    the record's ``memory``, ``cost``, ``collectives``, ``lower_s`` and
    the config."""
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    cfg = cfg_override if cfg_override is not None else arch_shape_config(arch, shape)
    step, args = step_args(cfg, shape, mesh)
    arg_bytes = sh.local_bytes(args)
    tracker = MemTracker()
    with tracker, StepAccounting() as acc, sh.on_mesh(mesh):
        out = step(*args)
    lower_s = time.perf_counter() - t0
    peak = tracker.get_tracker_snapshot("peak").get(torch.device("meta"), {}).get("Total", 0)
    cost, coll = acc.record()
    memory = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sh.local_bytes(out),
        "temp_size_in_bytes": int(peak),
        "alias_size_in_bytes": _alias_bytes(out, args),
        "generated_code_size_in_bytes": None,
    }
    return {"cfg": cfg, "memory": memory, "cost": cost, "collectives": coll, "lower_s": lower_s}


def run_one(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
            device: str = "cuda") -> dict:
    """Start the fake world, trace one combo on the production mesh, and
    write its record ``{arch}__{shape}__{mesh}.json`` to ``out_dir``."""
    shape = INPUT_SHAPES[shape_name]
    chips = math.prod(PRODUCTION_SHAPES[multi_pod][0])
    start_fake_world(chips)
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    traced = trace_combo(arch, shape, mesh)
    cfg = traced["cfg"]
    print("memory:", traced["memory"])
    print("cost flops=%.4g bytes=%.4g" % (traced["cost"]["flops"],
                                          traced["cost"]["bytes accessed"]))
    print("collectives:", {k: f"{v / 1e6:.1f}MB" for k, v in traced["collectives"].items()
                           if k != "count" and v}, "count:", traced["collectives"]["count"])
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi_pod" if multi_pod else "single_pod",
        "chips": chips,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "lower_s": traced["lower_s"],
        "compile_s": None,
        "memory": traced["memory"],
        "cost": traced["cost"],
        "collectives": traced["collectives"],
        "model_params": cfg.param_count(),
        "model_params_active": cfg.param_count(active_only=True),
        "microbatches": cfg.microbatches,
        "hw": H100,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{record['mesh']}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[dryrun] OK {arch} x {shape_name} x {record['mesh']} "
          f"(trace {traced['lower_s']:.1f}s) -> {path}")
    peak = peak_bytes(record)
    if peak > H100["hbm_bytes"]:
        print(f"[dryrun] WARNING {arch} x {shape_name} x {record['mesh']}: a peak of "
              f"{peak / 1024**3:.1f} GiB a device exceeds the card's "
              f"{H100['hbm_bytes'] / 1024**3:.0f} GiB", file=sys.stderr)
    return record


def peak_bytes(record: dict) -> int:
    """A record's peak bytes a device: its arguments plus the step's peak
    above them; a combo fits the card when this is within
    ``H100["hbm_bytes"]``."""
    mem = record["memory"]
    return mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def _depth_reduced(cfg: ModelConfig, n: int) -> ModelConfig:
    """Config with n periods of layers (and n encoder layers), microbatch 1."""
    from repro_torch.models.transformer import period_of

    kw = dict(num_layers=n * period_of(cfg), microbatches=1)
    if cfg.encoder_layers:
        kw["encoder_layers"] = n
    return cfg.with_overrides(**kw)


def run_cost(arch: str, shape: str | ShapeConfig, *, out_dir: str, device: str = "cuda",
             mesh=None, base_cfg: ModelConfig | None = None) -> dict:
    """The reference's loop-corrected cost estimate: the same step at
    depths of 1 and 2 layer periods, the per-period cost as their
    difference, extrapolated: ``total = f(P) + (R-1) * (f(2P) - f(P))``.
    Eager counting sees every layer, so the estimate equals the
    full-depth count (a test holds it); the record keeps the reference's
    schema.  Runs on the single-pod mesh over a fake world it starts, or
    on ``mesh``; ``base_cfg`` replaces the arch's config."""
    from repro_torch.models.transformer import period_of

    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    base_cfg = base_cfg if base_cfg is not None else arch_shape_config(arch, shape)
    repeats = base_cfg.num_layers // period_of(base_cfg)
    if base_cfg.encoder_layers and base_cfg.encoder_layers != repeats:
        raise ValueError("body extrapolation assumes equal encoder/decoder repeat counts")
    if mesh is None:
        dims, axes = PRODUCTION_SHAPES[False]
        start_fake_world(math.prod(dims))
        mesh = make_host_mesh(dims, axes, device)
    results = []
    for n in (1, 2):
        traced = trace_combo(arch, shape, mesh, cfg_override=_depth_reduced(base_cfg, n))
        results.append({"flops": traced["cost"]["flops"],
                        "bytes": traced["cost"]["bytes accessed"],
                        "collectives": traced["collectives"]})
        print(f"[cost] {arch} x {shape.name} depth n={n}: flops={results[-1]['flops']:.4g} "
              f"coll={traced['collectives']['count']}")
    f1, f2 = results

    def extrap(a, b):
        return a + (repeats - 1) * (b - a)

    est = {
        "flops": extrap(f1["flops"], f2["flops"]),
        "bytes": extrap(f1["bytes"], f2["bytes"]),
        "collectives": {k: extrap(f1["collectives"][k], f2["collectives"][k])
                        for k in f1["collectives"]},
    }
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "single_pod",
        "kind": shape.kind,
        "repeats": repeats,
        "depth1": f1,
        "depth2": f2,
        "estimate": est,
        "model_params": base_cfg.param_count(),
        "model_params_active": base_cfg.param_count(active_only=True),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape.name}__cost.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[cost] OK {arch} x {shape.name}: est flops/device {est['flops']:.4g} -> {path}")
    return record


def run_matrix(*, multi_pod: bool, cost_mode: bool, jobs: int, out_dir: str, device: str) -> int:
    """Every (arch x shape) but ``gpt2-paper``'s, each in a process of its
    own; a combo that fails is reported ``FAIL`` and the matrix exits 1.
    A combo that traces but whose peak exceeds the card's memory is listed
    in a warning: the trace proves the path, not that it fits."""
    combos = [(a, s) for a in ARCHITECTURES if a != "gpt2-paper" for s in INPUT_SHAPES]
    procs: list[tuple[tuple, subprocess.Popen]] = []
    failures, over = [], []
    mesh = "multi_pod" if multi_pod else "single_pod"
    pending = list(combos)
    while pending or procs:
        while pending and len(procs) < jobs:
            a, s = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
                   "--out", out_dir, "--device", device]
            if multi_pod:
                cmd.append("--multi-pod")
            if cost_mode:
                cmd.append("--cost-mode")
            procs.append(((a, s), subprocess.Popen(cmd)))
        done = [(c, p) for c, p in procs if p.poll() is not None]
        procs = [(c, p) for c, p in procs if p.poll() is None]
        for c, p in done:
            if p.returncode != 0:
                failures.append(c)
                print(f"[dryrun] FAIL {c} (exit code {p.returncode})", flush=True)
            elif not cost_mode:
                with open(os.path.join(out_dir, f"{c[0]}__{c[1]}__{mesh}.json")) as f:
                    if peak_bytes(json.load(f)) > H100["hbm_bytes"]:
                        over.append(c)
        time.sleep(0.2)
    print(f"[dryrun] matrix done, {len(failures)} failures: {failures}")
    if over:
        print(f"[dryrun] WARNING {len(over)} combos traced but exceed the card's "
              f"{H100['hbm_bytes'] / 1024**3:.0f} GiB a device: {over}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cost-mode", action="store_true",
                    help="depth-1/depth-2 cost extrapolation (single-pod)")
    ap.add_argument("--all", action="store_true", help="run the full matrix via subprocesses")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: the card by default, 'cpu' without one "
                         "(the shards are meta tensors either way)")
    args = ap.parse_args(argv)

    if args.all:
        return run_matrix(multi_pod=args.multi_pod, cost_mode=args.cost_mode, jobs=args.jobs,
                          out_dir=args.out, device=args.device)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all) required")
    import torch.distributed as dist

    try:
        if args.cost_mode:
            run_cost(args.arch, args.shape, out_dir=args.out, device=args.device)
        else:
            run_one(args.arch, args.shape, multi_pod=args.multi_pod, out_dir=args.out,
                    device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
