"""Sharding — the port of ``repro/sharding.py``: the production mesh's
spec rules and activation anchors, and the federated cohort axis over
processes.

**The spec rules.** Physical mesh axes: single-pod ``("data", "model")``
= (16, 16), multi-pod ``("pod", "data", "model")`` = (2, 16, 16).
Logical roles: BATCH, the activations' batch, over ``("pod", "data")``;
FSDP, the weights' shard axis (ZeRO-3 style), the same axes; TENSOR
(heads, d_ff, experts, vocab) over ``"model"``; SEQ, the decode KV
cache's sequence axis, over ``"model"``.  A spec is a plain tuple with one
entry a tensor dim: ``None``, a mesh axis name or a tuple of names (the
reference's ``PartitionSpec`` entries, so a test compares them directly).
Parameter specs follow the parameters' ``/``-joined paths line for line
as the reference's do (``key.split("/")`` is its ``_path_strings``); a
leading stacked-layer axis (``pos{j}`` in the path) is never sharded.
:func:`placements` turns a spec into DTensor placements, one a mesh dim.

**The activation anchors.** :func:`set_activation_sharding` installs
logical -> mesh rules; the model calls :func:`constrain` at the
reference's few sites, which redistributes a DTensor to the rule's
placements and is the identity when no rules are installed (one device,
the federated runtime) or on a plain tensor.

**The cohort axis.** The round engines' leading client axis is embarrassingly parallel
(Algorithm 1 runs each selected client independently).  The reference
places it over a process's devices with ``shard_map``; the port places it
over the ranks of a ``torch.distributed`` process group, one process per
device.  ``shard_clients=True`` runs the client phase on each rank's block
of the cohort, gathers the blocks into cohort order on every rank, and
runs the server phase, replicated, on the gathered cohort: every rank then
holds the state the reference's single controller sees.

A cohort that does not divide the world size is padded with duplicate
rows of its first client; they ride at ``k = 0`` and are dropped right
after the gather (:class:`CohortShard`), before anything reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication, local_map
from torch.utils import _pytree

__all__ = [
    "COHORT_AXIS", "CohortShard", "cohort_mesh", "gather_cohort", "rank", "world_size",
    "axis_names", "batch_axes", "fsdp_axes", "param_specs", "opt_state_specs", "batch_specs",
    "cache_specs", "placements", "distribute_tree", "local_bytes", "set_activation_sharding",
    "rules_installed", "constrain", "split_axes", "local_apply", "reduce_over", "gather_fsdp", "split_last", "index_copy_",
    "on_mesh",
]

COHORT_AXIS = "clients"


# ---------------------------------------------------------------------------
# the production mesh's spec rules
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names, outermost first (a ``DeviceMesh``'s
    ``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names)


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(axis_names(mesh), (int(n) for n in mesh.shape)))


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_axes(mesh) -> tuple[str, ...]:
    return batch_axes(mesh)


def _spec(*entries) -> tuple:
    """A spec of ``entries``, a one-name tuple written as the name, as
    ``PartitionSpec`` normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _param_spec_for(path: tuple[str, ...], shape: tuple[int, ...], mesh) -> tuple:
    """Spec for one parameter leaf given its path and shape: the
    reference's rules, in its order of precedence."""
    ndim = len(shape)
    model_size = _axis_sizes(mesh)["model"]
    fsdp = fsdp_axes(mesh)
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    gparent = path[-3] if len(path) >= 3 else ""

    # ---- stacked-layer leading axes (posJ dicts under "stack"/"encoder") ----
    lead: tuple = ()
    core_ndim = ndim
    if any(p.startswith("pos") and p[3:].isdigit() for p in path):
        lead = (None,)
        core_ndim = ndim - 1

    def spec(*axes):
        if len(axes) != core_ndim:
            raise ValueError(f"{'/'.join(path)} {shape}: spec {axes} has the wrong rank")
        return _spec(*lead, *axes)

    # ---- embeddings / heads ----
    if name in ("embed", "lm_head", "pos_embed"):
        return _spec("model", fsdp)  # (V, D): vocab tensor-sharded, D fsdp

    # ---- norms / scalars / vectors (the reference's ``a or b and c and d``) ----
    if parent in ("norm1", "norm2", "norm_x", "final_norm", "enc_norm") or name in (
        "scale",
        "bias",
    ) and core_ndim == 1 and parent not in ("gate_norm",):
        return spec(*([None] * core_ndim))
    if parent == "gate_norm":  # (d_inner,) — model-sharded like its activations
        return spec("model")

    # ---- attention projections ----
    if gparent in ("attn", "cross") or parent in ("attn", "cross"):
        if name == "b":
            return spec("model") if parent != "wo" else spec(None)
        if parent in ("wq", "wk", "wv"):
            return spec(fsdp, "model")
        if parent == "wo":
            return spec("model", fsdp)

    # ---- LoRA ----
    if name == "A":
        return spec(fsdp, None)
    if name == "B" and core_ndim == 2 and parent not in ("in_proj", "out_proj"):
        return spec(None, "model")

    # ---- MoE ----
    if parent == "router":
        return spec(fsdp, None) if core_ndim == 2 else spec(None)
    if name in ("up", "gate", "down") and core_ndim == 3:
        # experts over model, per-expert F over fsdp (2D weight-stationary)
        return spec("model", None, fsdp) if name != "down" else spec("model", fsdp, None)

    # ---- dense MLP ----
    if parent in ("up", "gate"):
        if name == "w":
            return spec(fsdp, "model")
        return spec("model")
    if parent == "down":
        if name == "w":
            return spec("model", fsdp)
        return spec(None)

    # ---- SSM (Mamba2) ----
    if parent in ("w_z", "w_x"):
        return spec(fsdp, "model") if name == "w" else spec("model")
    if parent == "w_bc":
        return spec(fsdp, None) if name == "w" else spec(None)
    if parent == "w_dt":
        # dt heads over model when divisible (jamba H=256), else replicated
        # (mamba2-130m H=24)
        div = shape[-1] % model_size == 0
        if name == "w":
            return spec(fsdp, "model") if div else spec(fsdp, None)
        return spec("model") if div else spec(None)
    if parent == "out_proj":
        if name == "w":
            return spec("model", fsdp)
        return spec(None)
    if name == "conv_x_w":
        return spec(None, "model")
    if name == "conv_x_b":
        return spec("model")
    if name in ("conv_bc_w",):
        return spec(None, None)
    if name in ("dt_bias", "a_log", "d_skip"):
        return spec("model") if shape[-1] % model_size == 0 else spec(None)
    if name == "conv_bc_b":
        return spec(None)

    # fallback: replicate
    return spec(*([None] * core_ndim))


def param_specs(params: dict[str, Any], mesh) -> dict[str, tuple]:
    """The spec of every leaf of one model's flat parameter dict (tensors,
    ``meta`` ones included, or anything with a ``shape``)."""
    return {k: _param_spec_for(tuple(k.split("/")), tuple(v.shape), mesh)
            for k, v in params.items()}


def opt_state_specs(params_specs: dict[str, tuple], *, master: bool = False):
    """The port's AdamW state (:func:`repro_torch.launch.steps.init_train_opt`:
    a client axis of 1 in front of every leaf): ``m``, ``v`` and, for 16-bit
    parameters, the fp32 ``master`` sharded as their parameter behind one
    replicated leading axis; ``count (1,)`` replicated."""
    from repro_torch.optim import AdamWState

    lead = {k: (None,) + s for k, s in params_specs.items()}
    return AdamWState(m=lead, v=dict(lead), count=(None,), master=dict(lead) if master else None)


def batch_specs(mesh, *, batch_shardable: bool = True, with_frontend: bool = False,
                with_labels: bool = True) -> dict[str, tuple]:
    """Input batch: tokens/labels (B, S) batch-sharded (unless B = 1)."""
    b = batch_axes(mesh) if batch_shardable else None
    out = {"tokens": _spec(b, None)}
    if with_labels:
        out["labels"] = _spec(b, None)
    if with_frontend:
        out["frontend"] = _spec(b, None, None)
    return out


def _cache_spec(last: str, nd: int, b) -> tuple:
    if last in ("k", "v") and nd == 5:  # (R, B, C, Kv, Dh)
        return (None, b, "model", None, None)
    if last == "pos":  # (R, C)
        return (None, "model")
    if last == "length":
        return () if nd == 0 else (None,)
    if last == "conv_x":  # (R, B, W-1, d_inner)
        return (None, b, None, "model")
    if last == "conv_bc":  # (R, B, W-1, 2N)
        return (None, b, None, None)
    if last == "state":  # (R, B, H, P, N): H is not mesh-divisible for
        # every arch (mamba2-130m has 24 heads); N = 128 always divides
        return (None, b, None, None, "model")
    if last == "enc_out":  # (B, F, D)
        return (b, None, None)
    return (None,) * nd


def cache_specs(cache: Any, mesh, *, batch_shardable: bool = True) -> Any:
    """Decode cache (:func:`repro_torch.models.init_cache`): KV ``k``/``v``
    ``(R, B, C, Kv, Dh)`` sequence-sharded over ``"model"``; the SSM's
    ``conv_x (R, B, W-1, ch)`` channel-sharded, its ``state (R, B, H, P,
    N)`` state-sharded.  The same dicts and named tuples as the cache, a
    spec at each leaf."""
    b = batch_axes(mesh) if batch_shardable else None

    def walk(node, last: str):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f) for f, v in zip(node._fields, node)))
        return _spec(*_cache_spec(last, len(node.shape), b))

    return walk(cache, "")


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` on the tensor dim whose entry names it, else
    ``Replicate()`` (also on a mesh dim of one rank, where the two are
    the same).  An entry of several names (``("pod", "data")``) shards its
    dim over those mesh dims, outer first, as JAX's does."""
    names, sizes = axis_names(mesh), _axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        group = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in dims:
            if sizes[names[i]] > 1:  # a mesh dim of one rank holds the whole dim
                out[i] = Shard(d)
    return out


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` (dicts, named tuples) as a DTensor placed by
    its spec in ``specs`` (the same structure; ``None`` where the tree has
    ``None``): the counterpart of the reference's ``tree_named``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, s, mesh) for v, s in zip(tree, specs)))
    if tree is None:
        return None
    if not isinstance(specs, tuple) or len(specs) != tree.ndim:
        raise ValueError(f"spec {specs} for a tensor of shape {tuple(tree.shape)}")
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a DTensor
    counts its local shard, a plain tensor itself)."""
    total = 0
    for x in _pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# activation anchors
#
# DTensor's propagation picks each op's output placements from its inputs'
# and a cost model; the reference anchors the head axis of the attention
# scores, q/k/v, the SSD's inputs and the embedding's one-hot, where XLA's
# propagation otherwise replicates them.  The launcher installs the
# logical -> mesh rules here; default None = the identity (one device, the
# federated runtime).
# ---------------------------------------------------------------------------

_ACTIVATION_RULES: dict | None = None


def _rules(mesh) -> dict:
    return {
        "mesh": mesh,
        "batch": batch_axes(mesh),
        "heads": "model",
        "dff": "model",
        "vocab": "model",
        "kv": None,
        "seq": "model",  # the decode KV cache's slots (the flash-decoding layout)
    }


def set_activation_sharding(mesh) -> None:
    """Install (or clear, with None) activation-constraint rules."""
    global _ACTIVATION_RULES
    _ACTIVATION_RULES = None if mesh is None else _rules(mesh)


def rules_installed() -> bool:
    return _ACTIVATION_RULES is not None


def constrain(x, *logical: str | None):
    """Redistribute the DTensor ``x`` to the placements the rules give its
    dims' logical axes (one name or None a dim); the identity when no
    rules are installed or on a plain tensor."""
    if _ACTIVATION_RULES is None or not isinstance(x, DTensor):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"{len(logical)} logical axes for a tensor of {x.ndim} dims")
    mesh = _ACTIVATION_RULES["mesh"]
    want = _logical_placements(_ACTIVATION_RULES, logical, x.shape, mesh)
    return x if list(x.placements) == want else x.redistribute(mesh, want)


def split_axes(name: str, size: int) -> tuple[str, ...]:
    """The mesh axes the installed rules split a dim of ``size`` over for
    the logical axis ``name``: ``()`` with no rules, or where no axis of
    it divides the dim and :func:`constrain` leaves it whole."""
    if _ACTIVATION_RULES is None:
        return ()
    return _fit(_ACTIVATION_RULES, name, size, _axis_sizes(_ACTIVATION_RULES["mesh"]))


def _fit(rules: dict, name: str | None, size: int, sizes_of: dict) -> tuple[str, ...]:
    """The axes of ``name``'s rule that a dim of ``size`` splits over: all
    of them, else the inner ones that divide it, else none (an axis of one
    rank splits nothing)."""
    group = rules.get(name) if name else None
    group = () if group is None else (group,) if isinstance(group, str) else tuple(group)
    group = tuple(a for a in group if sizes_of[a] > 1)
    while group and size % math.prod(sizes_of[a] for a in group):
        group = group[1:]
    return group


def _logical_placements(rules: dict, logical, sizes, mesh) -> list:
    """Placements of a tensor of dim ``sizes`` whose dims take the
    ``logical`` axes.  A dim its mesh axes do not divide is split over the
    inner axes that do, and stays whole where none does (16 rows a
    microbatch over ("pod", "data") split over "data" alone; a batch of 1;
    mamba2-130m's 24 SSD heads over 16 ranks), where XLA pads: DTensor
    cannot split or merge an uneven shard."""
    sizes_of = _axis_sizes(mesh)
    return placements(_spec(*(_fit(rules, name, n, sizes_of) or None
                              for name, n in zip(logical, sizes))), mesh)


def local_apply(fn, args: tuple, in_axes: tuple, out_axes, sizes: dict[str, int]):
    """``fn(*args)``, on a mesh run by each rank on its own block: a
    computation independent across the logical axes it is split on (the
    attention's batch rows and heads, the SSD's).  ``in_axes``: each
    arg's logical axes (None for an arg used whole on every rank: a mask,
    a missing state); ``out_axes``: the output's, or a tuple of them for a
    tuple of outputs.  A logical axis whose size in ``sizes`` its mesh
    axes do not divide is replicated instead (llama4's 40 query heads,
    mamba2-130m's 24 SSD heads over 16 ranks; a batch of 1).  Each
    DTensor arg is redistributed to its placements first, an explicit
    redistribution; without DTensor args it is ``fn(*args)``."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rules = _rules(mesh)

    def place(logical):
        return _logical_placements(rules, logical, [sizes.get(n, 1) for n in logical], mesh)

    in_pl = tuple(place(ax) if ax is not None else
                  place((None,) * a.ndim) if isinstance(a, DTensor) else None
                  for a, ax in zip(args, in_axes))
    multi = isinstance(out_axes[0], tuple)
    out_pl = tuple(place(ax) for ax in out_axes) if multi else place(out_axes)
    # an input whole over a mesh dim the outputs are split on feeds every
    # block there: its gradient is the sum of the blocks' (the SSD's B and
    # C, read by every head)
    split = [any(not p[i].is_replicate() for p in (out_pl if multi else (out_pl,)))
             for i in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else
                    [Partial() if split[i] and p.is_replicate() else p for i, p in enumerate(pl)]
                    for pl in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def reduce_over(x: torch.Tensor, op: str, axes: tuple[str, ...]) -> torch.Tensor:
    """``x`` reduced (``"sum"``, ``"max"``) over the ranks of the mesh
    ``axes`` of the installed rules' mesh: inside a :func:`local_apply`
    function, across the blocks of a dim split over ``axes``."""
    mesh = _ACTIVATION_RULES["mesh"]
    for a in axes:
        x = funcol.all_reduce(x, op, (mesh, axis_names(mesh).index(a)))
    return x


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight about to be used, gathered over the FSDP axes (ZeRO-3: its
    ``"model"`` sharding kept), so the op that reads it runs on the
    batch-sharded activations; its gradient comes back reduce-scattered
    to the weight's own placement.  Without it DTensor's per-op choice
    moves the activations instead (the batch gathered, the weight's
    shard contracted, every rank computing every token).  The identity
    on a plain tensor."""
    if not isinstance(w, DTensor):
        return w
    fsdp = fsdp_axes(w.device_mesh)
    names = axis_names(w.device_mesh)
    place = [Replicate() if names[i] in fsdp else p for i, p in enumerate(w.placements)]
    return w if place == list(w.placements) else w.redistribute(w.device_mesh, place)


def split_last(x: torch.Tensor, lead: int, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape, lead, -1)``: the last dim split into ``lead``
    groups (a projection into its heads).  DTensor cannot split a dim
    sharded over ``m`` ranks into ``lead`` groups unless ``m`` divides
    ``lead`` (GQA's 4 or 8 K/V heads over 16, llama4's 40 query heads):
    such a mesh dim is gathered first, an explicit redistribution."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        place = [Replicate() if p.is_shard(last) and lead % x.device_mesh.size(i) else p
                 for i, p in enumerate(x.placements)]
        if place != list(x.placements):
            x = x.redistribute(x.device_mesh, place)
    return x.reshape(*shape, lead, -1)


def index_copy_(buf: torch.Tensor, dim: int, index: torch.Tensor, val: torch.Tensor) -> None:
    """``buf.index_copy_(dim, index, val)`` for a one-element ``index``
    (a decode ring's slot), with no host sync.  On a DTensor ``buf``
    sharded along ``dim`` (the KV cache's sequence axis over ``"model"``)
    each rank writes into its own shard, and only the rank that holds the
    slot changes anything: ``val`` is placed as ``buf`` with ``dim``
    replicated, and every other rank writes its slot's old value back."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(dim, index, val)
        return
    mesh, place = buf.device_mesh, list(buf.placements)
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in place]
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim, run_check=False)
    val = val.redistribute(mesh, want).to_local()
    index = index.full_tensor() if isinstance(index, DTensor) else index
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, place)
    if shape[dim] == 0:
        return
    local = buf.to_local()
    idx = index - offset[dim]
    hit = ((idx >= 0) & (idx < shape[dim])).reshape((1,) * val.ndim)
    idx = idx.clamp(0, shape[dim] - 1)
    local.index_copy_(dim, idx, torch.where(hit, val, local.index_select(dim, idx)))


@contextlib.contextmanager
def on_mesh(mesh):
    """Run a step on DTensors placed on ``mesh``: the activation rules
    installed, and a plain tensor the step makes (positions, masks, RoPE's
    frequencies, zero states) taken as replicated where it meets a
    DTensor."""
    set_activation_sharding(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        set_activation_sharding(None)


def cohort_mesh(device: str | torch.device = "cuda"):
    """A 1-D ``DeviceMesh`` named :data:`COHORT_AXIS` over the ranks of the
    default process group: where the round engines place the selected
    cohort (``shard_clients``).  The caller that starts the processes
    initialises that group and chooses its backend; without one, a
    one-rank group is made here on a ``HashStore`` (NCCL on the card, gloo
    on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return DeviceMesh(device.type, list(range(dist.get_world_size())),
                      mesh_dim_names=(COHORT_AXIS,))


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def gather_cohort(tree, group=None):
    """All-gather every rank's block of the cohort axis into cohort order.

    ``tree``: dicts, tuples and named tuples of tensors whose leading axis
    is this rank's block (the same shape on every rank); other leaves
    (``None``, ints) pass through.  The tensors travel as one byte buffer,
    so every dtype (bool masks, int8 wires) crosses bit for bit, in one
    collective.  gloo's path stages a card's tensors through host copies:
    the buffer is gathered on the host and copied back once."""
    leaves, spec = _pytree.tree_flatten(tree)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors:
        return tree
    device = tensors[0].device
    parts = [x.contiguous().reshape(-1).view(torch.uint8) for x in tensors]
    buf = torch.cat(parts)
    if dist.get_backend(group) == "gloo" and device.type != "cpu":
        buf = buf.cpu()
    out = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, buf, group=group)
    per_rank = torch.stack(out).to(device).split([p.numel() for p in parts], dim=1)
    gathered = iter(
        # each rank's bytes of a leaf, in rank order (the blocks in cohort
        # order), copied into storage of its own: a leaf never aliases the
        # buffer at an offset its dtype's kernels would not choose
        chunk.clone().view(x.dtype).reshape(len(out) * x.shape[0], *x.shape[1:])
        for chunk, x in zip(per_rank, tensors)
    )
    return _pytree.tree_unflatten(
        [next(gathered) if isinstance(x, torch.Tensor) else x for x in leaves], spec)


@dataclasses.dataclass(frozen=True)
class CohortShard:
    """One rank's block of a cohort of ``n`` real clients, padded by
    ``pad = (-n) % world`` duplicate rows of its first client."""

    n: int
    rank: int
    world: int
    group: object = None

    @classmethod
    def of(cls, mesh, n: int) -> "CohortShard":
        return cls(n=n, rank=mesh.get_local_rank(), world=mesh.size(), group=mesh.get_group())

    @property
    def pad(self) -> int:
        return (-self.n) % self.world

    @property
    def rows(self) -> int:
        """The rows of the padded cohort each rank computes."""
        return (self.n + self.pad) // self.world

    def padded(self, rows):
        """``rows`` (a list, or a tensor whose leading axis is the cohort)
        with the pad rows, copies of the first, appended."""
        if isinstance(rows, torch.Tensor):
            return torch.cat([rows, rows[:1].expand(self.pad, *rows.shape[1:])])
        return list(rows) + [rows[0]] * self.pad

    def block(self, rows):
        """This rank's rows of the padded cohort."""
        lo = self.rank * self.rows
        return rows[lo:lo + self.rows]

    def block_ks(self, ks_dev: torch.Tensor) -> torch.Tensor:
        """This rank's budgets: the pad rows transmit nothing (``k = 0``)."""
        return self.block(torch.cat([ks_dev, ks_dev.new_zeros(self.pad)]))

    def gather(self, tree):
        """Every rank's block, gathered into cohort order, the pad rows
        dropped: the real cohort's rows on every rank."""
        return _pytree.tree_map(lambda x: x[:self.n] if isinstance(x, torch.Tensor) else x,
                                gather_cohort(tree, self.group))
