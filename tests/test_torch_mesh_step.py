"""The port's train, prefill and decode steps on a 2x2 ``("data", "model")``
mesh — parameters, AdamW state, batch and cache placed as DTensors by the
spec rules, the activation rules installed — against the reference's
unsharded steps on the bridged parameters, for a dense (yi-9b), an MoE
(granite-moe-1b-a400m) and an SSM (mamba2-130m) family's smoke config.

Four gloo ranks, spawned once for the module (``tests/_torch_mesh_worker.py``,
JAX-free), compute every step; the test process runs the reference.
Tolerances (fp32 throughout; the mesh sums each contraction in blocks,
over ranks, in another order than one device): the loss within rtol 1e-5;
prefill and decode logits (of size ~1) within atol 2e-5; every updated
parameter within rtol 1e-4 in relative L2 norm per leaf (a first AdamW step
moves each element by at most lr = 3e-4 times its gradient's sign, so a
gradient wrong in sign on a tenth of a leaf's elements would show at ~1e-3
on the zero-initialised biases); the four ranks' losses equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as tmp  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_mesh_worker as w  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.serve import make_decode_step as j_decode_step  # noqa: E402
from repro.serve import make_prefill_step as j_prefill_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init  # noqa: E402

LOSS_RTOL, LOGITS_ATOL, PARAMS_RTOL = 1e-5, 2e-5, 1e-4


def reference(family: str) -> dict:
    """The reference's unsharded steps on the bridged ``init(cfg, SEED)``."""
    arch = w.FAMILIES[family]
    jc = j_smoke(arch)
    params = jax.tree.map(jnp.asarray, bridge.to_numpy_tree(init(get_smoke_config(arch),
                                                                 w.SEED, "cpu")))
    tokens = jnp.asarray(w.tokens(jc))
    opt = j_adamw_init(params, state_dtype=jc.optimizer_state_dtype)
    new_p, _, metrics = jax.jit(j_train_step(jc))(params, opt, {"tokens": tokens})
    decode = jax.jit(j_decode_step(jc))
    cache, logits = j_init_cache(jc, w.B, w.S), []
    for t in range(w.DECODE):
        step_logits, cache = decode(params, cache, tokens[:, t])
        logits.append(np.asarray(step_logits))
    return {"loss": float(metrics["loss"]),
            "params": bridge.flatten(jax.tree.map(np.asarray, new_p)),
            "prefill": np.asarray(jax.jit(j_prefill_step(jc))(params, {"tokens": tokens})),
            "decode": np.stack(logits)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    ranks = tmp.spawn(w.main, args=(str(root / "rdzv"), str(root)), nprocs=4, join=False)
    ref = {f: reference(f) for f in w.FAMILIES}  # while the ranks run
    while not ranks.join(timeout=300):
        pass
    return {"ranks": [torch.load(root / f"rank{i}.pt", weights_only=False) for i in range(4)],
            "ref": ref}


@pytest.mark.parametrize("family", list(w.FAMILIES))
def test_train_step_is_the_references(runs, family):
    got, want = runs["ranks"][0][family], runs["ref"][family]
    assert {r[family]["loss"] for r in runs["ranks"]} == {got["loss"]}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        diff = np.linalg.norm(got["params"][k].numpy() - v) / np.linalg.norm(v)
        assert diff <= PARAMS_RTOL, (k, diff)


@pytest.mark.parametrize("family", list(w.FAMILIES))
def test_prefill_is_the_references(runs, family):
    np.testing.assert_allclose(runs["ranks"][0][family]["prefill"].numpy(),
                               runs["ref"][family]["prefill"], rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("family", list(w.FAMILIES))
def test_decode_is_the_references(runs, family):
    """``DECODE`` steps from an empty cache of ``S`` slots sharded over
    ``"model"`` on its sequence axis: each rank writes a token only into
    the ring slots it holds (slots 0-7 on the first, 8-9 on the second)."""
    np.testing.assert_allclose(runs["ranks"][0][family]["decode"].numpy(),
                               runs["ref"][family]["decode"], rtol=0, atol=LOGITS_ATOL)
