"""The port's kernels against the JAX reference, on the CPU.

Here the ``ops`` wrappers run their plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``.  Inputs are made with numpy
from a seed.  The wire scatters cover k = 0 client rows, wire padding at
index 0 beside a real index-0 entry, and negative values (fp32: rtol 1e-6,
atol 0), and the premise of their CUDA kernel (a client's entries in any
order, its zero entries dropped: the same sums bitwise); the bisection
top-k masks cover k = 0, 1, V and > V, ties at the threshold, an
all-negative and a constant row, rows holding a NaN or +-inf, and must
match the Pallas kernels in interpret mode and
``core.topk.topk_mask_dynamic`` exactly (every step is one rounded fp32
operation), as must a numpy model of their CUDA kernel's candidate
bisection on random (hypothesis), tied, constant, half-integer, +-inf,
NaN, tiny-spread and overflowing rows; the dense adaptive aggregation
is held at rtol 1e-6 plus 1e-6 of the output's largest magnitude (the
Pallas kernel sums the clients with ``jnp.sum``, whose order the plain
version need not share, and a sum of signed terms can cancel).
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import topk as jtopk  # noqa: E402
from repro.kernels.sparse_agg import (  # noqa: E402
    scatter_wire_sums_dequant_pallas,
    scatter_wire_sums_pallas,
    sparse_agg_pallas,
)
from repro.kernels.topk_select import topk_mask_dynamic_pallas, topk_mask_pallas  # noqa: E402
from repro_torch.core import topk as ttopk  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("adaptive", "zeropad", "mean_nonzero")


def _wire(seed, n=3, rows=5, k=8, vocab=64, ks=(8, 5, 0)):
    """A cohort wire: distinct indices per (client, row), client i transmits
    its first ks[i] entries, the rest is padding (index 0, value 0), and
    some rows carry a real index-0 entry beside that padding."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, rows, k), np.int32)
    for i in range(n):
        for r in range(rows):
            idx[i, r] = rng.permutation(np.arange(1, vocab))[:k]
    mask = np.arange(k)[None, None, :] < np.asarray(ks)[:, None, None]
    mask = np.broadcast_to(mask, (n, rows, k)).copy()
    idx[1, ::2, 0] = 0  # real index-0 entries of a client that also pads
    vals = rng.normal(size=(n, rows, k)).astype(np.float32)  # mixed signs
    vals = np.where(mask, vals, 0.0).astype(np.float32)
    idx = np.where(mask, idx, 0).astype(np.int32)
    return vals, idx, mask, vocab


def _channels(vals, mask, mode):
    v = vals * mask
    if mode == "adaptive":
        return (np.abs(v) * v).astype(np.float32), np.abs(v).astype(np.float32)
    return v.astype(np.float32), mask.astype(np.float32)


def _quantized(vals, mask):
    amax = np.abs(vals).max(axis=-1)
    scale = np.where(amax > 0, amax / 127, 1.0).astype(np.float32)
    q = np.clip(np.round(vals / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_scatter_wire_sums_matches_reference(seed, mode):
    vals, idx, mask, vocab = _wire(seed)
    a, b = _channels(vals, mask, mode)
    j_num, j_den = scatter_wire_sums_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx), vocab, interpret=True
    )
    jj_num, jj_den = jagg.scatter_wire_sums(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx), vocab)
    ta, tb, ti = (torch.as_tensor(x) for x in (a, b, idx))
    ops.reset_launches()
    for num, den in (ref.scatter_wire_sums_ref(ta, tb, ti, vocab), ops.scatter_wire_sums(ta, tb, ti, vocab)):
        for t_out, j_out in ((num, j_num), (den, j_den), (num, jj_num), (den, jj_den)):
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6, atol=0)
    assert sum(ops.LAUNCHES.values()) == 0


def test_scatter_wire_sums_folds_batch_dims():
    vals, idx, mask, vocab = _wire(2, rows=6)
    a, b = _channels(vals, mask, "adaptive")
    fold = lambda x: torch.as_tensor(x).reshape(3, 2, 3, -1)  # noqa: E731
    num, den = ops.scatter_wire_sums(fold(a), fold(b), fold(idx), vocab)
    r_num, r_den = ref.scatter_wire_sums_ref(*(torch.as_tensor(x) for x in (a, b, idx)), vocab)
    assert num.shape == (2, 3, vocab)
    assert torch.equal(num.reshape(6, vocab), r_num) and torch.equal(den.reshape(6, vocab), r_den)


def test_index_zero_entry_survives_padding():
    vals, idx, mask, vocab = _wire(3)
    a, b = _channels(vals, mask, "zeropad")
    num, den = ops.scatter_wire_sums(*(torch.as_tensor(x) for x in (a, b, idx)), vocab)
    # row 0: client 0 has no index 0, client 1 sends a real index-0 entry and
    # pads at index 0, client 2 (k = 0) pads everywhere at index 0
    assert float(num[0, 0]) == pytest.approx(float(vals[1, 0, 0]))
    assert float(den[0, 0]) == 1.0


@pytest.mark.parametrize("mode", MODES)
def test_scatter_wire_sums_dequant_matches_reference(mode):
    vals, idx, mask, vocab = _wire(4)
    q, scale = _quantized(vals, mask)
    j_num, j_den = scatter_wire_sums_dequant_pallas(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(mask.astype(np.int8)), jnp.asarray(idx),
        vocab, mode, interpret=True,
    )
    jj_num, jj_den = jagg.scatter_wire_sums_dequant(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(mask), jnp.asarray(idx), vocab, mode
    )
    tq, ts, tm, ti = (torch.as_tensor(x) for x in (q, scale, mask, idx))
    ops.reset_launches()
    outs = (
        ref.scatter_wire_sums_dequant_ref(tq, ts, tm, ti, vocab, mode),
        ops.scatter_wire_sums_dequant(tq, ts, tm, ti, vocab, mode),
        ops.scatter_wire_sums_dequant(tq, ts, tm.to(torch.int8), ti, vocab, mode),
    )
    for num, den in outs:
        for t_out, j_out in ((num, j_num), (den, j_den), (num, jj_num), (den, jj_den)):
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6, atol=0)
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("mode", MODES)
def test_scatter_sums_ignore_entry_order_and_zero_entries(mode):
    """The premise of the wire-scatter kernel, which splits a row's columns
    over blocks and adds each client's entries in any order, without
    atomics: on a wire from the port's sparsify_wire, with index-0 padding
    beside a real index-0 entry, permuting the k entries within each
    (client, row) — or dropping the entries whose two channels are both
    zero, the padding among them — leaves both plain sums bitwise equal,
    float and int8 wire alike."""
    rng = np.random.default_rng(11)
    n, rows, vocab, k_cap = 4, 6, 64, 16
    logits = rng.normal(size=(n, rows, vocab)).astype(np.float32)
    logits[1, ::2, 0] = 10.0  # index 0 in client 1's top-k on even rows
    logits[3] -= 20.0  # all negative
    wire = ttopk.sparsify_wire(torch.as_tensor(logits), [k_cap, k_cap // 2, 0, 3], k_cap)
    idx = torch.where(wire.mask, wire.indices, 0).contiguous()  # pad_wire's padding
    wire = wire._replace(indices=idx)
    assert bool(((idx[1] == 0) & wire.mask[1]).any()) and int((idx[1] == 0).sum()) > rows // 2
    perm = torch.as_tensor(np.argsort(rng.random((n, rows, k_cap)), axis=-1))
    shuf = lambda t: torch.gather(t, -1, perm)  # noqa: E731

    m = wire.mask.float()
    v = wire.values * m
    a, b = (torch.abs(v) * v, torch.abs(v)) if mode == "adaptive" else (v, m)
    want = ref.scatter_wire_sums_ref(a, b, idx, vocab)
    keep = (a != 0) | (b != 0)  # a zero contribution: dropped (index 0, +0.0) in its place
    dropped = [torch.where(keep, t, torch.zeros_like(t)) for t in (a, b)] + [torch.where(keep, idx, 0)]
    assert int((~keep).sum()) > 0
    for got in (ref.scatter_wire_sums_ref(shuf(a), shuf(b), shuf(idx), vocab),
                ref.scatter_wire_sums_ref(*dropped, vocab)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))

    qw = ttopk.quantize_wire(wire)
    want = ref.scatter_wire_sums_dequant_ref(qw.values, qw.scale, qw.mask, idx, vocab, mode)
    got = ref.scatter_wire_sums_dequant_ref(shuf(qw.values), qw.scale, shuf(qw.mask), shuf(idx),
                                            vocab, mode)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _topk_rows(seed, vocab=64):
    """(rows, V) fp32 logits and per-row budgets covering the edge cases:
    k = 0, 1, V and > V on random rows, a tie at the threshold, an
    all-negative row, a constant row, and a row of few distinct values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, vocab)).astype(np.float32)
    x[4] = rng.integers(-3, 3, size=vocab)
    x[4, 5:17] = 3.0  # the 10th largest sits inside a tie of 12
    x[5] -= 50.0  # all negative
    x[6] = 2.5  # constant
    x[7] = np.round(x[7] * 2) / 2  # many ties
    ks = np.array([0, 1, vocab, vocab + 5, 10, 7, 3, 20], np.int32)
    return x, ks


def _special_rows(special, seed, vocab):
    """Rows the bisection meets rarely: a NaN among normal values (min and
    max are NaN, nothing is kept), or +inf beside -inf (every mid is NaN)
    and +inf alone."""
    rng = np.random.default_rng(seed + 7)
    x = rng.normal(size=(2, vocab)).astype(np.float32)
    if special == "nan":
        x[0, 3] = np.nan
        x[1, -1] = np.nan
        return x, np.array([4, vocab], np.int32)
    x[0, 5], x[0, 9] = np.inf, -np.inf
    x[1, 2] = np.inf
    return x, np.array([5, 3], np.int32)


@pytest.mark.parametrize(
    "vocab, seed, special",
    [pytest.param(v, s, sp, id="-".join(map(str, (v, s) + ((sp,) if sp else ()))))
     for sp in (None, "nan", "inf") for v in (64, 300) for s in (0, 1)],
)
def test_topk_mask_dynamic_matches_reference_exactly(vocab, seed, special):
    x, ks = _topk_rows(seed, vocab)
    if special:
        sx, sk = _special_rows(special, seed, vocab)
        x, ks = np.concatenate([x, sx]), np.concatenate([ks, sk])
    rows = x.shape[0]
    j_kern = np.asarray(topk_mask_dynamic_pallas(jnp.asarray(x), jnp.asarray(ks), interpret=True))
    j_jnp = np.asarray(jtopk.topk_mask_dynamic(jnp.asarray(x), jnp.asarray(ks)))
    np.testing.assert_array_equal(j_kern, j_jnp)
    tx, tk = torch.as_tensor(x), torch.as_tensor(ks)
    ops.reset_launches()
    outs = (
        ref.topk_mask_ref(tx, torch.clamp(tk, 0, vocab), guard=True),
        ops.topk_mask_dynamic(tx, tk),
        ttopk.topk_mask_dynamic(tx, tk),
        ops.topk_mask_dynamic(tx.reshape(2, rows // 2, vocab),
                              tk.reshape(2, rows // 2)).reshape(rows, vocab),
    )
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), j_kern)
    assert sum(ops.LAUNCHES.values()) == 0
    # the edge cases really are in the data
    kept = (j_kern != 0).sum(axis=1)
    assert kept[0] == 0 and kept[1] == 1 and kept[2] == kept[3] == vocab
    assert kept[4] == 12 and kept[6] == vocab and (x[5] < 0).all()
    if special == "nan":  # the reference keeps nothing of a row that holds a NaN
        assert kept[8] == kept[9] == 0
    if special == "inf":  # +-inf: every mid is NaN, hi becomes NaN, lo stays -inf
        assert kept[8] == vocab and np.isinf(x[9]).any()


def _midpoint(lo, hi):
    with np.errstate(over="ignore", invalid="ignore"):
        return np.float32(np.float32(lo + hi) * np.float32(0.5))


def _candidate_lo(x, k, cap, warp_cap):
    """lo after the 30 steps as the CUDA kernel (``csrc/topk_select.cu``)
    finds it, in numpy: every step takes iff mid <= X_k, the k-th largest x;
    [clo, chi) holds X_k with exact counts cnt = #{x >= clo} >= k and above =
    #{x >= chi} < k, bracketed first by counts at three thresholds from the
    first eighth's mean and deviation; only a mid inside (clo, chi) is
    counted, as above +
    #{c in buffer : mid <= c < chi} once the buffer (compacted at ``cap``,
    again whenever the set halves, and at ``warp_cap``) holds [clo, chi),
    else over the whole row; at 32 candidates X_k is read off by rank."""
    f32 = np.float32
    lo, hi = x.min(), f32(x.max() + f32(1))
    if np.isnan(x).any():
        return f32(np.nan)
    if k <= 0:  # every count passes
        for _ in range(ref.BISECTION_ITERS):
            lo = _midpoint(lo, hi)
        return lo
    clo, cnt, chi, above = x.min(), x.size, hi, 0
    if not hi > x.max():  # max + 1 rounds down to max: take +inf
        chi, above = f32(np.inf), int((x >= np.inf).sum())
        if above >= k:
            clo, cnt = f32(np.inf), above
    head = x[: -(-x.size // 8)].astype(np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        mean, sd = head.mean(), np.sqrt(max((head * head).mean() - head.mean() ** 2, 0.0))
        grid = [f32(mean + a * sd) if np.isfinite(mean + a * sd) else f32(np.inf)
                for a in (1.75, 2.25, 2.75)]
    for t in grid:
        c = int((x >= t).sum())
        if c >= k and t > clo:
            clo, cnt = t, c
        if c < k and t < chi:
            chi, above = t, c
    buf = None
    for _ in range(ref.BISECTION_ITERS):
        mid = _midpoint(lo, hi)
        if mid > clo and mid < chi:
            if buf is None and cnt - above <= cap:
                buf = x[(x >= clo) & (x < chi)]
            if buf is None:
                c = int((x >= mid).sum())
            else:
                c = above + int(((buf >= mid) & (buf < chi)).sum())  # c < chi: the buffer is a superset
            assert c == int((x >= mid).sum())
            if c >= k:
                clo, cnt = mid, c
            else:
                chi, above = mid, c
            n = cnt - above
            if buf is not None and (2 * n <= buf.size or n <= warp_cap < buf.size or n <= 32):
                buf = buf[(buf >= clo) & (buf < chi)]
                assert buf.size == n
                if n <= 32:  # X_k has rank k - above among them: no count from here on
                    clo = np.sort(buf)[::-1][k - above - 1]
                    chi = np.nextafter(clo, f32(np.inf))
        take = mid <= clo  # a NaN mid: count 0 < k
        lo, hi = (mid, hi) if take else (lo, mid)
    return lo


def _model_rows(kind, vocab, rng):
    f32 = np.float32
    if kind == "tied":
        x = rng.integers(-3, 3, size=vocab).astype(f32)
        x[5:17] = 3.0
    elif kind == "constant":
        x = np.full(vocab, 2.5, f32)
    elif kind == "half_integer":
        x = (np.round(rng.normal(size=vocab) * 2) / 2).astype(f32)
    elif kind == "inf":
        x = rng.normal(size=vocab).astype(f32)
        x[7], x[9] = np.inf, -np.inf
    elif kind == "nan":
        x = rng.normal(size=vocab).astype(f32)
        x[11] = np.nan
    elif kind == "tiny_spread":
        x = (1.0 + 1e-3 * rng.normal(size=vocab)).astype(f32)
    else:  # "overflow": lo + hi overflows fp32
        x = np.full(vocab, 3e38, f32)
        x[: vocab // 6] = 3.3e38
    return x


# (V, buffer, warp take-over): small V with the thresholds scaled down so
# every path runs, and the kernel's own at V 50 257 on an H100
_MODEL_SIZES = [(300, 64, 16), (50257, 7600, 1024)]


@pytest.mark.parametrize("vocab, cap, warp_cap", _MODEL_SIZES, ids=["scaled", "kernel"])
@pytest.mark.parametrize("k", ["0", "1", "V", "V+7"])
@pytest.mark.parametrize("kind", ["random", "tied", "constant", "half_integer", "inf", "nan",
                                  "tiny_spread", "overflow"])
def test_candidate_bisection_follows_the_plain_trajectory(kind, k, vocab, cap, warp_cap):
    kk = {"0": 0, "1": 1, "V": vocab, "V+7": vocab + 7}[k]

    def check(x, budget):
        budget = min(budget, vocab)  # both kernels clamp to V
        for guard in (True, False):
            want = ref.topk_mask_ref(torch.as_tensor(x[None]), torch.tensor([budget], dtype=torch.int32),
                                     guard=guard).numpy()[0]
            lo = _candidate_lo(x, budget, cap, warp_cap)
            keep = (x >= lo) & ((budget > 0) or not guard)
            np.testing.assert_array_equal(np.where(keep, x, np.float32(0)).view(np.int32),
                                          want.view(np.int32))

    if kind != "random":
        x = _model_rows(kind, vocab, np.random.default_rng(vocab))
        check(x, kk)
        check(x, 5)  # a budget inside the row, where the candidate set shrinks
        return
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=12, deadline=None, derandomize=True)
    @hypothesis.given(seed=st.integers(0, 2**32 - 1), scale=st.sampled_from([1e-3, 0.55, 1.0, 30.0]),
                      shift=st.sampled_from([0.0, -50.0]), inner=st.integers(2, 2000))
    def random_rows(seed, scale, shift, inner):
        x = (np.random.default_rng(seed).normal(size=vocab) * scale + shift).astype(np.float32)
        check(x, kk)
        check(x, inner)

    random_rows()


def _bf16_tie_row(kind, vocab, cap, warp_cap, rng):
    """A bf16-rounded row and budgets whose k-th value sits inside a tie
    group larger than 32, than the warp's take-over size, or than the
    compacted buffer — or a row of a few distinct bf16 values."""
    x = torch.as_tensor(rng.normal(size=vocab).astype(np.float32)).to(torch.bfloat16).float().numpy()
    if kind == "few_distinct":  # 1 + 1e-3 N(0, 1) in bf16: three values, ties of thousands
        x = torch.as_tensor((1.0 + 1e-3 * rng.normal(size=vocab)).astype(np.float32)
                            ).to(torch.bfloat16).float().numpy()
        values, counts = np.unique(x, return_counts=True)
        v0, group = values[np.argmax(counts)], int(counts.max())  # the largest group
    else:
        group = {"tie_over_32": 40, "tie_over_warp_cap": warp_cap + 16,
                 "tie_over_buffer": cap + 64}[kind]
        v0 = np.float32(np.sort(x)[::-1][vocab // 20])  # a value near the top of the row
        x[rng.choice(np.flatnonzero(x != v0), size=group, replace=False)] = v0
    above = int((x > v0).sum())
    return x, [above + 1, above + group // 2, above + group]


@pytest.mark.parametrize("vocab, cap, warp_cap", _MODEL_SIZES, ids=["scaled", "kernel"])
@pytest.mark.parametrize("kind", ["tie_over_32", "tie_over_warp_cap", "tie_over_buffer",
                                  "few_distinct"])
def test_candidate_bisection_on_bf16_ties(kind, vocab, cap, warp_cap):
    """bf16 rows (8 significand bits) tie in large groups: a tie group at
    X_k never leaves the candidate interval, so the model of the kernel's
    design must stay exact when that group exceeds 32, the warp's take-over
    size and the compacted buffer."""
    x, budgets = _bf16_tie_row(kind, vocab, cap, warp_cap, np.random.default_rng(vocab + len(kind)))
    for budget in budgets:
        kk = torch.tensor([budget], dtype=torch.int32)
        want = ref.topk_mask_ref(torch.as_tensor(x[None]).to(torch.bfloat16), kk, guard=True)
        lo = _candidate_lo(x, budget, cap, warp_cap)
        got = torch.as_tensor(np.where(x >= lo, x, np.float32(0))).to(torch.bfloat16)
        assert torch.equal(got, want[0]), (kind, budget)
        tie = int((x == np.sort(x)[::-1][budget - 1]).sum())
        assert int((want != 0).sum()) >= budget and tie > 32


@pytest.mark.parametrize("k", [0, 1, 7, 64, 70])
def test_topk_mask_static_matches_reference_exactly(k):
    x, _ = _topk_rows(2)
    j_kern = np.asarray(topk_mask_pallas(jnp.asarray(x), k, interpret=True))
    tx = torch.as_tensor(x)
    ops.reset_launches()
    kk = torch.full((8,), min(k, 64), dtype=torch.int32)
    for out in (ref.topk_mask_ref(tx, kk, guard=False), ops.topk_mask(tx, k),
                ttopk.topk_mask_dense(tx, k, use_kernel=True)):
        np.testing.assert_array_equal(out.numpy(), j_kern)
    assert sum(ops.LAUNCHES.values()) == 0


def _stack(seed, n=4, rows=5, vocab=64, k=9):
    """A dense (N, rows, V) stack: each client's top-k mask of random
    logits (zeros off the support), and a fully dense random stack."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, rows, vocab)).astype(np.float32)
    sparse = np.array(jtopk.topk_mask_batch(jnp.asarray(x), [k, 1, 0, vocab]))
    return sparse, x


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_aggregate_matches_reference(seed):
    ops.reset_launches()
    for stack in _stack(seed):
        j_kern = np.asarray(sparse_agg_pallas(jnp.asarray(stack), interpret=True))
        ts = torch.as_tensor(stack)
        for out in (ref.sparse_aggregate_ref(ts), ops.sparse_aggregate(ts),
                    ops.sparse_aggregate(ts.reshape(4, 5, 1, 64)).reshape(5, 64)):
            np.testing.assert_allclose(out.numpy(), j_kern, rtol=1e-6,
                                       atol=1e-6 * np.abs(j_kern).max())
    assert sum(ops.LAUNCHES.values()) == 0


def test_wrappers_reject_bad_inputs():
    vals, idx, mask, vocab = _wire(5)
    a, b = _channels(vals, mask, "adaptive")
    ta, tb, ti = (torch.as_tensor(x) for x in (a, b, idx))
    non_contig = ta.transpose(1, 2).contiguous().transpose(1, 2)
    assert not non_contig.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.scatter_wire_sums(non_contig, tb, ti, vocab)
    with pytest.raises(TypeError, match="dtype"):
        ops.scatter_wire_sums(ta.double(), tb, ti, vocab)
    with pytest.raises(ValueError, match="shape"):
        ops.scatter_wire_sums(ta, tb[:, :, :4].contiguous(), ti, vocab)
    q, scale = _quantized(vals, mask)
    with pytest.raises(ValueError, match="mode"):
        ops.scatter_wire_sums_dequant(torch.as_tensor(q), torch.as_tensor(scale),
                                      torch.as_tensor(mask), ti, vocab, "median")
    x, ks = (torch.as_tensor(a) for a in _topk_rows(0))
    stack = torch.as_tensor(_stack(0)[1])
    for bad in (x.t().contiguous().t(), stack.transpose(1, 2).contiguous().transpose(1, 2)):
        assert not bad.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_mask_dynamic(x.t().contiguous().t(), ks)
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_mask(x.t().contiguous().t(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sparse_aggregate(stack.transpose(1, 2).contiguous().transpose(1, 2))
    # fp16 runs (the plain versions on the CPU, in fp16 out); float64 has no kernel
    for low in (torch.float16,):
        want = ref.topk_mask_ref(x.to(low), torch.clamp(ks, 0, x.shape[-1]), guard=True)
        got = ops.topk_mask_dynamic(x.to(low), ks)
        assert got.dtype == low and torch.equal(got, want)
        assert ops.topk_mask(x.to(low), 3).dtype == low
        assert ops.sparse_aggregate(stack.to(low)).dtype == low
    for bad_dtype in (torch.float64,):
        with pytest.raises(TypeError, match="dtype"):
            ops.topk_mask_dynamic(x.to(bad_dtype), ks)
        with pytest.raises(TypeError, match="dtype"):
            ops.topk_mask(x.to(bad_dtype), 3)
        with pytest.raises(TypeError, match="dtype"):
            ops.sparse_aggregate(stack.to(bad_dtype))
    with pytest.raises(TypeError, match="mix"):  # one dtype for the float inputs of a call
        ops.scatter_wire_sums(ta, tb.to(torch.bfloat16), ti, vocab)
    with pytest.raises(TypeError, match="dtype"):
        ops.topk_mask_dynamic(x, ks.long())
    with pytest.raises(ValueError, match="shape"):
        ops.topk_mask_dynamic(x, ks[:4].contiguous())


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "sparse_agg.cu").is_file()


def test_every_kernel_source_exists_and_is_built_by_name():
    assert set(build.SOURCES) == {"sparse_agg", "topk_select", "distill_kl", "flash_attention"}
    for src in build.SOURCES.values():
        assert src.is_file() and src.suffix == ".cu"
    text = {name: src.read_text() for name, src in build.SOURCES.items()}
    for suffix in ("f32", "bf16", "f16"):  # an entry point per input dtype
        assert f"int topk_mask_{suffix}(" in text["topk_select"]
        assert f"int sparse_aggregate_{suffix}(" in text["sparse_agg"]
        assert f"int scatter_wire_sums_{suffix}(" in text["sparse_agg"]
        assert f"int distill_kl_{suffix}(" in text["distill_kl"]
        assert f"int flash_attention_{suffix}(" in text["flash_attention"]
    assert "int scatter_wire_sums_dequant_i8(" in text["sparse_agg"]
    # the launches the wrappers count, one counter per wrapper and input dtype
    # (and per kernel for the attention: its D = 128 kernels and its kernel
    # for every other head dim)
    fp32 = {"topk_mask_dynamic", "topk_mask", "sparse_aggregate", "scatter_wire_sums",
            "scatter_wire_sums_dequant", "distill_kl", "flash_attention"}
    assert set(ops.LAUNCHES) == fp32 | {f"{n}{tag}" for n in fp32 - {"scatter_wire_sums_dequant"}
                                        for tag in (".bf16", ".f16")} | {
        f"flash_attention{tag}{instance}" for tag in ("", ".bf16", ".f16") for instance in (".d128", ".dany")}
