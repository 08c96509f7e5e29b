"""The port's dry-run machinery (``repro_torch.launch.dryrun``,
``repro_torch.launch.policy``, ``models.model.param_shapes``) against the
reference's (``repro.launch.policy``, ``jax.eval_shape(init)``, the
collective parser's cases), on the CPU.

Shapes, dtypes, windows and byte counts are compared exactly.  The
accounting tests run over a fake world of 4 ranks (a 2x2 mesh) started in
this process and torn down after the module; the full-size run is one
``python -m repro_torch.launch.dryrun --device cpu`` subprocess over a fake
world of 256.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs import ARCHITECTURES, INPUT_SHAPES, get_config as j_config  # noqa: E402
from repro.launch.policy import arch_shape_config as j_arch_shape_config  # noqa: E402
from repro.launch.policy import input_specs as j_input_specs  # noqa: E402
from repro.launch.policy import window_for as j_window_for  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.sharding import _path_strings  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.policy import arch_shape_config, input_specs, window_for  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of a record the reference's run_one writes (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "seq_len", "global_batch", "lower_s",
               "compile_s", "memory", "cost", "collectives", "model_params",
               "model_params_active", "microbatches", "hw"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes", "generated_code_size_in_bytes"}


def _leaves(tree) -> dict:
    """``{"a/b/c": (shape, dtype name)}`` of a reference pytree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_path_strings(p)): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in leaves}


def _port_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_port_leaves(v, f"{prefix}{f}/"))
        return out
    assert tree.device.type == "meta"
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", list(ARCHITECTURES))
def test_param_shapes_are_the_references_eval_shape(arch):
    want = _leaves(jax.eval_shape(lambda k: j_init(k, j_config(arch)), jax.random.PRNGKey(0)))
    got = param_shapes(get_config(arch))
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in got.items()} == want
    assert {str(t.dtype) for t in param_shapes(get_config(arch), "float16").values()} == {
        "torch.float16"}


def test_window_policy_is_the_references():
    for arch in ARCHITECTURES:
        for shape in INPUT_SHAPES.values():
            assert window_for(get_config(arch), shape) == j_window_for(j_config(arch), shape)
    assert window_for(get_config("command-r-35b"), INPUT_SHAPES["long_500k"]) == 4096
    assert window_for(get_config("jamba-1.5-large-398b"), INPUT_SHAPES["long_500k"]) is None


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-76b", "seamless-m4t-large-v2",
                                  "mamba2-130m", "command-r-35b", "jamba-1.5-large-398b"])
def test_input_specs_are_the_references(arch, shape_name):
    """Every stand-in, leaf for leaf: the batch (the VLM's text after its
    patches; the frontend), or the token and the whole cache (the ring
    bounded by the window at long_500k, jamba's attention cache at full
    length); ``arch_shape_config``'s microbatches."""
    shape = INPUT_SHAPES[shape_name]
    jc, tc = j_arch_shape_config(arch, shape), arch_shape_config(arch, shape)
    assert tc.microbatches == jc.microbatches
    assert (tc.microbatches == 1) == (shape.kind != "train" or get_config(arch).microbatches == 1)
    want, got = j_input_specs(jc, shape), input_specs(tc, shape)
    assert set(got) == set(want)
    assert _port_leaves(got) == _leaves(want)


def test_decode_cache_ring_bounded_by_window():
    shape = INPUT_SHAPES["long_500k"]
    k = input_specs(arch_shape_config("command-r-35b", shape), shape)["cache"]["layers"]["pos0"].k
    assert k.shape[2] == 4096
    cfg = arch_shape_config("jamba-1.5-large-398b", shape)
    layers = input_specs(cfg, shape)["cache"]["layers"]
    assert layers[f"pos{cfg.attn_offset}"].k.shape[2] == 524288


@pytest.fixture(scope="module")
def mesh():
    """A 2x2 ("data", "model") mesh over a fake world of 4 ranks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dryrun.start_fake_world(4)
    try:
        yield make_host_mesh((2, 2), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_collective_bytes_counts_and_bytes(mesh):
    """Known redistributions of a (16, 8) fp32 tensor: all-gather of the
    row shards over data (the (16, 8) result, 512 bytes), all-reduce of a
    partial sum over model (the (8, 8) local result, 256 bytes),
    reduce-scatter of a partial sum into row shards ((8, 8), 256 bytes);
    a redistribution that moves nothing counts nothing."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = DTensor.from_local(torch.ones(8, 8), mesh, [Shard(0), Replicate()], run_check=False)
    got = dryrun.collective_bytes(lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
    assert got == {"all-gather": 16 * 8 * 4, "all-reduce": 0, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0, "count": 1}
    p = DTensor.from_local(torch.ones(8, 8), mesh, [Shard(0), Partial()], run_check=False)
    got = dryrun.collective_bytes(lambda: p.redistribute(mesh, [Shard(0), Replicate()]))
    assert got["all-reduce"] == 8 * 8 * 4 and got["count"] == 1
    q = DTensor.from_local(torch.ones(16, 8), mesh, [Replicate(), Partial()], run_check=False)
    got = dryrun.collective_bytes(lambda: q.redistribute(mesh, [Replicate(), Shard(0)]))
    assert got["reduce-scatter"] == 8 * 8 * 4 and got["count"] == 1
    got = dryrun.collective_bytes(lambda: x.redistribute(mesh, [Shard(0), Replicate()]))
    assert got["count"] == 0 and sum(v for k, v in got.items() if k != "count") == 0


def test_flops_are_the_local_shards(mesh):
    """A replicated-batch matmul, x (1, 64) on every rank against w (64,
    32) column-sharded over model: each rank computes x @ its (64, 16)
    shard, 2·64·16 flops; the logical product's count over the 4 ranks
    (2·64·32 / 4) is not it, and neither is FlopCounterMode's count of the
    logical op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    x = DTensor.from_local(torch.ones(1, 64), mesh, [Replicate(), Replicate()], run_check=False)
    w = DTensor.from_local(torch.ones(64, 16), mesh, [Replicate(), Shard(1)], run_check=False)
    with dryrun.StepAccounting() as acc:
        y = x @ w
    assert acc.flops == 2 * 64 * 16
    assert acc.flops != 2 * 64 * 32 // 4
    with FlopCounterMode(display=False) as fc:
        x @ w
    assert fc.get_total_flops() == 2 * 64 * 32 != acc.flops
    assert tuple(y.to_local().shape) == (1, 16)


def _small(arch: str):
    """The arch's smoke config at widths the 2x2 mesh divides."""
    return get_smoke_config(arch).with_overrides(num_layers=4, microbatches=1)


def test_cost_extrapolation_is_the_full_depth_count(mesh, tmp_path):
    """Eager counting sees every layer: the depth-1/depth-2 extrapolation
    of ``run_cost`` equals the full-depth trace's flops and collectives
    exactly.  Its bytes under-read the full depth's: the gradient of each
    layer's slice of a stacked ``(R, ...)`` leaf is a whole ``(R, ...)``
    buffer (``select_backward``), so a period's bytes grow with R."""
    shape = ShapeConfig("train_tiny", 64, 8, "train")
    cfg = _small("yi-9b")
    rec = dryrun.run_cost("yi-9b", shape, out_dir=str(tmp_path), mesh=mesh, base_cfg=cfg)
    assert rec["repeats"] == 4
    full = dryrun.trace_combo("yi-9b", shape, mesh, cfg_override=cfg)
    assert rec["estimate"]["flops"] == full["cost"]["flops"] > 0
    assert rec["estimate"]["collectives"] == full["collectives"]
    assert rec["estimate"]["bytes"] < full["cost"]["bytes accessed"]
    assert os.path.exists(tmp_path / "yi-9b__train_tiny__cost.json")


REMAT_SHAPE = ShapeConfig("train_tiny", 64, 8, "train")


def _stack_forward_flops(cfg, shape, mesh) -> int:
    """``StepAccounting``'s flops of one forward of the decoder stack alone
    on the train step's inputs (the embedding outside it)."""
    from repro_torch import sharding as sh
    from repro_torch.models.model import _embed
    from repro_torch.models.transformer import stack_apply

    _, (params, _, batch) = dryrun.step_args(cfg, shape, mesh)
    tokens = batch["tokens"][None]
    with torch.no_grad(), sh.on_mesh(mesh):
        x = _embed(params, cfg, tokens, torch.arange(tokens.shape[-1]))
        with dryrun.StepAccounting() as acc:
            stack_apply(params, x, cfg)
    return acc.flops


@pytest.mark.parametrize("arch,layers,recomputes", [
    ("yi-9b", 4, 1), ("yi-9b", 8, 1),
    ("jamba-1.5-large-398b", 4, 2), ("jamba-1.5-large-398b", 8, 2)])
def test_remat_recomputes_the_stack_forward(mesh, arch, layers, recomputes):
    """A remat'd train step on the 2x2 mesh.  With PyTorch's early stop
    off (each recompute runs its region whole) its flops are the plain
    step's plus exactly one forward of the stack (yi-9b: each repeat
    recomputed once) or two (jamba's period of 4, nested: the repeat
    recomputed once, then each position inside it once more).  The port
    runs with early stop on (a recompute ends at its region's last saved
    tensor, as XLA's recompute drops what the backward does not read), which
    recomputes at most that (and the plain step's embedding, checkpointed
    too, a little less).  The recompute issues its collectives again, and
    the step's temp peak is lower."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    cfg = get_smoke_config(arch).with_overrides(num_layers=layers, microbatches=1)
    on = cfg.with_overrides(remat=True)
    with set_checkpoint_early_stop(False):  # the plain step's embedding is checkpointed too
        plain = dryrun.trace_combo(arch, REMAT_SHAPE, mesh, cfg_override=cfg)
        whole = dryrun.trace_combo(arch, REMAT_SHAPE, mesh, cfg_override=on)["cost"]["flops"]
    remat = dryrun.trace_combo(arch, REMAT_SHAPE, mesh, cfg_override=on)
    forward = _stack_forward_flops(cfg, REMAT_SHAPE, mesh)
    assert whole == plain["cost"]["flops"] + recomputes * forward
    assert plain["cost"]["flops"] < remat["cost"]["flops"] <= whole
    assert remat["collectives"]["count"] > plain["collectives"]["count"]
    assert remat["memory"]["temp_size_in_bytes"] < plain["memory"]["temp_size_in_bytes"]
    assert remat["memory"]["argument_size_in_bytes"] == plain["memory"]["argument_size_in_bytes"]


def test_cost_extrapolation_with_remat_is_the_full_depth_count(mesh, tmp_path):
    """With remat each repeat's recompute is the same work, so the
    depth-1/depth-2 extrapolation still equals the full-depth flops and
    collectives exactly."""
    shape = REMAT_SHAPE
    cfg = _small("yi-9b").with_overrides(remat=True)
    rec = dryrun.run_cost("yi-9b", shape, out_dir=str(tmp_path), mesh=mesh, base_cfg=cfg)
    full = dryrun.trace_combo("yi-9b", shape, mesh, cfg_override=cfg)
    assert rec["estimate"]["flops"] == full["cost"]["flops"] > 0
    assert rec["estimate"]["collectives"] == full["collectives"]


def test_a_replicated_batch_is_not_divided(mesh):
    """long_500k's batch of 1 does not divide the batch axes: it stays
    whole on every rank, so a rank computes the logical step's batch
    (its flops are not the 2x2 mesh's share of a sharded batch)."""
    cfg = _small("yi-9b")
    one = dryrun.trace_combo("yi-9b", ShapeConfig("d1", 64, 1, "decode"), mesh, cfg_override=cfg)
    two = dryrun.trace_combo("yi-9b", ShapeConfig("d2", 64, 2, "decode"), mesh, cfg_override=cfg)
    assert one["cost"]["flops"] == two["cost"]["flops"] > 0


def test_the_cli_writes_the_references_record(tmp_path):
    """One full-size combo through the CLI, over a fake world of 256:
    mamba2-130m x decode_32k on the single-pod mesh.  Its record has the
    reference's keys, 256 chips, per-device bytes and flops and the H100
    cost model."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m", "--shape",
         "decode_32k", "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__single_pod.json").read_text())
    assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert rec["chips"] == 256 and rec["mesh"] == "single_pod" and rec["kind"] == "decode"
    assert rec["compile_s"] is None and rec["memory"]["generated_code_size_in_bytes"] is None
    assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert rec["memory"]["alias_size_in_bytes"] > 0  # the cache, written in place
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES) | {"count"}
    assert rec["hw"]["hbm_bytes"] == 80 * 1024**3 and "nvlink_bandwidth" in rec["hw"]
    assert rec["model_params"] == get_config("mamba2-130m").param_count()
    assert dryrun.peak_bytes(rec) < rec["hw"]["hbm_bytes"] and "WARNING" not in out.stderr


def test_the_matrix_names_the_combos_over_the_cards_memory(tmp_path, monkeypatch, capsys):
    """``--all`` reads each record its processes wrote: a combo whose
    arguments plus temp exceed the card's 80 GiB is named in a warning, a
    combo that fails to trace is a ``FAIL`` and the exit code 1."""
    fits, over, failing = ("a", "s1"), ("a", "s2"), ("b", "s1")
    temp = {fits: 79 * 1024**3, over: 80 * 1024**3, ("b", "s2"): 0}

    class Done:
        def __init__(self, cmd):
            combo = (cmd[cmd.index("--arch") + 1], cmd[cmd.index("--shape") + 1])
            self.returncode = 1 if combo == failing else 0
            if combo in temp:
                mem = {"argument_size_in_bytes": 1, "temp_size_in_bytes": temp[combo]}
                (tmp_path / f"{combo[0]}__{combo[1]}__single_pod.json").write_text(
                    json.dumps({"memory": mem}))

        def poll(self):
            return self.returncode

    monkeypatch.setattr(dryrun, "ARCHITECTURES", {"a": "", "b": "", "gpt2-paper": ""})
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {"s1": None, "s2": None})
    monkeypatch.setattr(dryrun.subprocess, "Popen", Done)
    monkeypatch.setattr(dryrun.time, "sleep", lambda _: None)
    rc = dryrun.run_matrix(multi_pod=False, cost_mode=False, jobs=2, out_dir=str(tmp_path),
                           device="cpu")
    text = capsys.readouterr().out
    assert rc == 1 and f"FAIL {failing}" in text
    warning = [line for line in text.splitlines() if "WARNING" in line]
    assert len(warning) == 1 and str(over) in warning[0] and str(fits) not in warning[0]
