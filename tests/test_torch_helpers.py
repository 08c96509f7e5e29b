"""The reference's small public helpers in the port, against the JAX
reference on the same numpy inputs, on the CPU: ``aggregate_sparse``,
``soft_labels``, ``lora_param_count`` and the wire and payload helpers of
``core/topk.py`` (``dequantize_wire``, ``wire_densify``, ``wire_support``,
``sparsify_batch``, ``payload_entries``).

Integers and bools are identical.  Floats agree within 1e-6 of the
largest reference magnitude: ``aggregate_sparse`` sums a row's clients in
one scatter where the reference loops over them, so its sums round in
another order; the rest compute the same fp32 expression.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LoRAConfig as JLoRA  # noqa: E402
from repro.configs.gpt2_paper import REDUCED_CLIENT as J_RC  # noqa: E402
from repro.core import aggregate_sparse as j_aggregate_sparse  # noqa: E402
from repro.core import soft_labels as j_soft_labels  # noqa: E402
from repro.core import topk as j_topk  # noqa: E402
from repro.lora import lora_param_count as j_lora_param_count  # noqa: E402
from repro.models import init as j_init  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import aggregate_sparse, soft_labels  # noqa: E402
from repro_torch.core import topk as t_topk  # noqa: E402
from repro_torch.lora import lora_param_count  # noqa: E402

REL = 1e-6


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * max(float(np.abs(want).max()), 1e-30))


def _payloads(seed=0, n=3, rows=(2, 5), k=6, vocab=16):
    """Each client's (values, indices) on a small vocabulary, so clients
    collide on indices, and one client repeats an index within a row."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, *rows, k)).astype(np.float32)
    indices = np.stack([rng.permutation(vocab)[:k] for _ in range(n * int(np.prod(rows)))])
    indices = indices.reshape(n, *rows, k).astype(np.int32)
    flat = indices.reshape(n, -1, k)  # a view
    flat[1, 0, 1] = flat[1, 0, 0]
    return values, indices, vocab


@pytest.mark.parametrize("mode", ["adaptive", "zeropad", "mean_nonzero"])
def test_aggregate_sparse_is_the_references(mode):
    values, indices, vocab = _payloads()
    got = aggregate_sparse(torch.as_tensor(values), torch.as_tensor(indices), vocab, mode)
    _close(got, j_aggregate_sparse(jnp.asarray(values), jnp.asarray(indices), vocab, mode))


def test_aggregate_sparse_of_one_row_axis():
    """No batch axes besides the row: ``(N, k)`` payloads."""
    values, indices, vocab = _payloads(seed=1, rows=(1,))
    values, indices = values[:, 0], indices[:, 0]
    got = aggregate_sparse(torch.as_tensor(values), torch.as_tensor(indices), vocab)
    assert tuple(got.shape) == (vocab,)
    _close(got, j_aggregate_sparse(jnp.asarray(values), jnp.asarray(indices), vocab))


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_soft_labels_are_the_references(temperature):
    logits = np.random.default_rng(2).normal(scale=4.0, size=(4, 37)).astype(np.float32)
    got = soft_labels(torch.as_tensor(logits), temperature)
    _close(got, j_soft_labels(jnp.asarray(logits), temperature))
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("targets", [("q", "v", "head"), ("q", "v", "o")])
def test_lora_param_count_is_the_references(targets):
    cfg = J_RC.with_overrides(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                              vocab_size=256, max_seq_len=32,
                              lora=JLoRA(rank=4, alpha=32.0, dropout=0.0, targets=targets))
    tree = j_init(jax.random.PRNGKey(0), cfg)
    params = bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")
    assert lora_param_count(params) == j_lora_param_count(tree) > 0


def _wires(quantize: bool):
    """The same logits sparsified into each package's wire: ks (5, 0, 2)
    at k_cap 4, so rows hold masked pad entries."""
    logits = np.random.default_rng(3).normal(size=(3, 2, 24)).astype(np.float32)
    ks = np.array([5, 0, 2], np.int32)
    t = t_topk.sparsify_wire(torch.as_tensor(logits), torch.as_tensor(ks), 4, quantize=quantize)
    j = j_topk.sparsify_wire(jnp.asarray(logits), jnp.asarray(ks), 4, quantize=quantize)
    return t, j


def test_dequantize_wire_is_the_references():
    t, j = _wires(quantize=True)
    got, want = t_topk.dequantize_wire(t), j_topk.dequantize_wire(j)
    assert isinstance(got, t_topk.SparseWire) and got.vocab == want.vocab
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_wire_densify_is_the_references(quantize):
    t, j = _wires(quantize)
    got = t_topk.wire_densify(t)
    _close(got, j_topk.wire_densify(j))
    # two rows a client: client 0 capped at 4 entries, client 1 sent nothing, client 2 two
    assert int((got != 0).sum()) == 2 * (4 + 0 + 2)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_wire_support_is_the_references(quantize):
    t, j = _wires(quantize)
    np.testing.assert_array_equal(t_topk.wire_support(t).numpy(),
                                  np.asarray(j_topk.wire_support(j)))


def test_wire_support_keeps_a_real_index_0_beside_masked_pads():
    """A real entry at index 0 (value 0.0 too) and masked pad entries at
    index 0 in the same row: index 0 stays transmitted, in both."""
    values = np.array([[[0.0, 1.5, 0.0, 0.0]], [[2.0, 0.0, 0.0, 0.0]]], np.float32)
    indices = np.array([[[0, 3, 0, 0]], [[5, 0, 0, 0]]], np.int32)
    mask = np.array([[[True, True, False, False]], [[True, False, False, False]]])
    t = t_topk.SparseWire(values=torch.as_tensor(values), indices=torch.as_tensor(indices),
                          mask=torch.as_tensor(mask), vocab=8)
    j = j_topk.SparseWire(values=jnp.asarray(values), indices=jnp.asarray(indices),
                          mask=jnp.asarray(mask), vocab=8)
    got = t_topk.wire_support(t).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_topk.wire_support(j)))
    assert got[0, 0].tolist() == [True, False, False, True, False, False, False, False]
    assert got[1, 0].tolist() == [False] * 5 + [True, False, False]


@pytest.mark.parametrize("k", [1, 5, 24])
def test_sparsify_batch_and_payload_entries_are_the_references(k):
    logits = np.random.default_rng(4).normal(size=(6, 24)).astype(np.float32)
    logits[0, :3] = logits[0, 3]  # a tie: the lower index first, in both
    got = t_topk.sparsify_batch(torch.as_tensor(logits), k)
    want = j_topk.sparsify_batch(jnp.asarray(logits), k)
    assert (got.k, got.vocab) == (want.k, want.vocab)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert t_topk.payload_entries(got) == j_topk.payload_entries(want) == 6 * k
