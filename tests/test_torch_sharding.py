"""The port's production-mesh spec rules (``repro_torch.sharding``) against
the reference's (``repro.sharding``), leaf for leaf, for every full-size
architecture on the single-pod (16x16) and multi-pod (2x16x16) meshes.

Specs are compared exactly (they are integers and names).  The meshes of
the spec tests are stand-ins with axis names and sizes (the reference's
``FakeMesh``, ``tests/test_sharding.py``); the argument-bytes test places
the port's ``meta`` trees as DTensors over a fake world of 512 ranks
started in this process and torn down after it.
"""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import sharding as j_sh  # noqa: E402
from repro.configs import ARCHITECTURES, INPUT_SHAPES, get_config as j_config  # noqa: E402
from repro.launch.policy import input_specs as j_input_specs  # noqa: E402
from repro.launch.policy import window_for as j_window_for  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.sharding import _path_strings  # noqa: E402
from repro_torch import sharding as t_sh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.policy import arch_shape_config, input_specs  # noqa: E402
from repro_torch.launch.steps import init_train_opt  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402

FULL_ARCHS = [a for a in ARCHITECTURES if a != "gpt2-paper"]
MESHES = {"single_pod": {"data": 16, "model": 16}, "multi_pod": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Both packages' mesh interface for spec derivation: the reference's
    ``axis_names``/``shape`` dict and the port's ``mesh_dim_names``/``shape``
    tuple are given by one object each."""

    def __init__(self, sizes: dict, port: bool):
        names = tuple(sizes)
        if port:
            self.mesh_dim_names, self.shape = names, tuple(sizes.values())
        else:
            self.axis_names, self.shape = names, dict(sizes)


def _meshes(name):
    return FakeMesh(MESHES[name], port=False), FakeMesh(MESHES[name], port=True)


def _flat(tree) -> dict:
    """``{"a/b/c": leaf}`` of a reference pytree (specs kept whole)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_path_strings(p)): leaf for p, leaf in leaves}


def _port_flat(tree, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` of the port's dicts and named tuples of specs or
    tensors (a spec is a plain tuple)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            if v is not None:
                out.update(_port_flat(v, f"{prefix}{f}/"))
        return out
    return {prefix[:-1]: tree}


def _size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    return math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str) else entry))


@pytest.fixture(scope="module")
def shapes():
    """Each full arch's reference ``eval_shape(init)`` and port
    ``param_shapes``, made once."""
    out = {}
    for arch in FULL_ARCHS:
        j = jax.eval_shape(lambda k, a=arch: j_init(k, j_config(a)), jax.random.PRNGKey(0))
        out[arch] = (j, param_shapes(get_config(arch)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_param_specs_are_the_references(shapes, arch, mesh):
    jm, tm = _meshes(mesh)
    j_shapes, t_shapes = shapes[arch]
    want = {k: tuple(s) for k, s in _flat(j_sh.param_specs(j_shapes, jm)).items()}
    got = t_sh.param_specs(t_shapes, tm)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_every_sharded_dim_divides(shapes, arch, mesh):
    """Parameters and their AdamW moments: each sharded dim divides by its
    mesh axes, and each spec has its tensor's rank."""
    _, tm = _meshes(mesh)
    t_shapes = shapes[arch][1]
    pspecs = t_sh.param_specs(t_shapes, tm)
    opt = init_train_opt(t_shapes, get_config(arch))
    ospecs = t_sh.opt_state_specs(pspecs)
    leaves = [(t_shapes[k], pspecs[k]) for k in t_shapes]
    leaves += [(opt.m[k], ospecs.m[k]) for k in opt.m] + [(opt.v[k], ospecs.v[k]) for k in opt.v]
    for x, spec in leaves:
        assert len(spec) == x.ndim
        for dim, entry in zip(x.shape, spec):
            assert dim % _size(MESHES[mesh], entry) == 0, (arch, x.shape, spec)


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b", "mamba2-130m"])
def test_opt_state_specs_carry_the_client_axis(shapes, arch):
    """The port's AdamW state has a client axis of 1 in front of every
    leaf: each moment's spec is its parameter's behind one replicated
    axis; ``count (1,)`` and a master copy's likewise."""
    _, tm = _meshes("single_pod")
    t_shapes = shapes[arch][1]
    pspecs = t_sh.param_specs(t_shapes, tm)
    opt = init_train_opt(t_shapes, get_config(arch))
    for master in (False, True):
        ospecs = t_sh.opt_state_specs(pspecs, master=master)
        assert ospecs.count == (None,) and opt.count.shape == (1,)
        assert (ospecs.master is not None) == master
        for tree in (ospecs.m, ospecs.v) + ((ospecs.master,) if master else ()):
            assert tree == {k: (None,) + s for k, s in pspecs.items()}
    for k, m in opt.m.items():
        assert m.shape == (1,) + tuple(t_shapes[k].shape)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["command-r-35b", "jamba-1.5-large-398b", "mamba2-130m"])
def test_cache_specs_are_the_references(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    shardable = shape.global_batch % 16 == 0
    jm, tm = _meshes("single_pod")
    jc = j_config(arch)
    j_cache = j_input_specs(jc, shape)["cache"]
    assert j_window_for(jc, shape) == (4096 if shape_name == "long_500k"
                                       and jc.family not in ("ssm", "hybrid") else None)
    want = {k: tuple(s) for k, s in _flat(
        j_sh.cache_specs(j_cache, jm, batch_shardable=shardable)).items()}
    t_cache = input_specs(arch_shape_config(arch, shape), shape)["cache"]
    got = _port_flat(t_sh.cache_specs(t_cache, tm, batch_shardable=shardable))
    assert got == want
    for key, x in _port_flat(t_cache).items():
        for dim, entry in zip(x.shape, got[key]):
            assert dim % _size(MESHES["single_pod"], entry) == 0, (key, x.shape, got[key])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_and_axes_are_the_references(mesh):
    jm, tm = _meshes(mesh)
    assert t_sh.batch_axes(tm) == j_sh.batch_axes(jm) == t_sh.fsdp_axes(tm)
    assert t_sh.axis_names(tm) == j_sh.axis_names(jm)
    for shardable in (True, False):
        for frontend in (True, False):
            for labels in (True, False):
                kw = dict(batch_shardable=shardable, with_frontend=frontend, with_labels=labels)
                want = {k: tuple(s) for k, s in j_sh.batch_specs(jm, **kw).items()}
                assert t_sh.batch_specs(tm, **kw) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_shard_outer_axes_first(fake_world, mesh):
    """``("pod", "data")`` shards one tensor dim over two mesh dims, pod
    the outer: rank 0's shard of a (64, 32) tensor is its first 2 rows."""
    from torch.distributed.tensor import Replicate, Shard

    tm = fake_world[mesh]
    spec = (t_sh.batch_axes(tm), "model")
    pl = t_sh.placements(spec, tm)
    assert pl == ([Shard(0), Shard(0), Shard(1)] if mesh == "multi_pod" else [Shard(0), Shard(1)])
    assert t_sh.placements((None, None), tm) == [Replicate()] * tm.ndim
    x = t_sh.distribute_tree({"x": torch.empty(64, 32, device="meta")}, {"x": spec}, tm)["x"]
    rows = 64 // (32 if mesh == "multi_pod" else 16)
    assert tuple(x.to_local().shape) == (rows, 2)
    with pytest.raises(ValueError, match="mesh's order"):
        t_sh.placements((("data", "pod"), None), FakeMesh(MESHES["multi_pod"], port=True))


@pytest.fixture(scope="module")
def fake_world():
    """A fake world of 512 ranks (this process rank 0) with the single-pod
    mesh on its first 256 and the multi-pod mesh on all of them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.dryrun import start_fake_world

    start_fake_world(512)
    try:
        yield {"single_pod": DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                                        mesh_dim_names=("data", "model")),
               "multi_pod": DeviceMesh("cpu", torch.arange(512).reshape(2, 16, 16),
                                       mesh_dim_names=("pod", "data", "model"))}
    finally:
        dist.destroy_process_group()


def _ref_bytes(shapes, specs, sizes) -> int:
    """Per-device bytes of a reference pytree of ShapeDtypeStructs under its
    specs (every sharded dim divides)."""
    total = 0
    flat_specs = _flat(specs)
    for key, leaf in _flat(shapes).items():
        spec = tuple(flat_specs[key]) + (None,) * (len(leaf.shape) - len(flat_specs[key]))
        n = math.prod(d // _size(sizes, e) for d, e in zip(leaf.shape, spec))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("combo", [
    ("yi-9b", "train_4k", "single_pod"), ("yi-9b", "train_4k", "multi_pod"),
    ("jamba-1.5-large-398b", "decode_32k", "single_pod"),
    ("mamba2-130m", "long_500k", "single_pod"), ("seamless-m4t-large-v2", "prefill_32k",
                                                 "multi_pod"),
], ids=lambda c: "-".join(c))
def test_argument_bytes_are_the_references_specs(fake_world, shapes, combo):
    """The dry run's ``argument_size_in_bytes``: rank 0's shards of the
    parameters, the AdamW state and the batch (train), of the parameters
    and the batch (prefill) or of the parameters, the cache and the token
    (decode), placed as DTensors, against the bytes the reference's specs
    give its own trees on one device."""
    from repro_torch.launch.dryrun import step_args

    arch, shape_name, mesh = combo
    shape = INPUT_SHAPES[shape_name]
    sizes = MESHES[mesh]
    jm = FakeMesh(sizes, port=False)
    cfg = arch_shape_config(arch, shape)
    _, args = step_args(cfg, shape, fake_world[mesh])
    got = t_sh.local_bytes(args)

    jc = j_config(arch).with_overrides(microbatches=cfg.microbatches)
    j_params = shapes[arch][0]
    pspecs = j_sh.param_specs(j_params, jm)
    shardable = shape.global_batch % _size(sizes, j_sh.batch_axes(jm)) == 0
    specs = j_input_specs(jc, shape)
    want = _ref_bytes(j_params, pspecs, sizes)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: j_adamw_init(p, state_dtype=jc.optimizer_state_dtype),
                             j_params)
        want += _ref_bytes(opt.m, pspecs, sizes) + _ref_bytes(opt.v, pspecs, sizes) + 4
    if shape.kind in ("train", "prefill"):
        want += _ref_bytes(specs["batch"], j_sh.batch_specs(
            jm, batch_shardable=shardable, with_frontend=jc.frontend != "none",
            with_labels=False), sizes)
    else:
        cache = specs["cache"]
        want += _ref_bytes(cache, j_sh.cache_specs(cache, jm, batch_shardable=shardable), sizes)
        want += shape.global_batch // (_size(sizes, j_sh.batch_axes(jm)) if shardable else 1) * 4
    assert got == want


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "bf16-transposed"])
def test_adamw_norm_sums_each_leaf_in_row_major_order(layout):
    """AdamW's per-client norm reduces each ``(C, ...)`` leaf over its own
    dims (a sharded gradient is never flattened), bitwise the sum over
    the leaf flattened in row-major order, also where its strides are not
    row-major."""
    from repro_torch.optim import global_norm

    rng = np.random.default_rng(0)
    grads = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
             for k, s in (("w", (3, 96, 130)), ("b", (3, 130)), ("e", (3, 4, 33, 17)))}
    if layout != "contiguous":
        grads = {k: g.transpose(1, -1) for k, g in grads.items()}
    if layout.startswith("bf16"):
        grads = {k: g.to(torch.bfloat16) for k, g in grads.items()}
    flat = sum(torch.square(g.float()).reshape(3, -1).sum(dim=1) for g in grads.values())
    assert torch.equal(global_norm(grads), torch.sqrt(flat))
