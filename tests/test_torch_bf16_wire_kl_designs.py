"""CPU models of the designs of the port's bf16 wire scatter and bf16 KL.

A CUDA kernel cannot run here; these tests pin what each design computes
against the plain versions in ``repro_torch.kernels.ref`` (themselves held
to the JAX reference in ``test_torch_bf16.py``).

Wire scatter (``csrc/sparse_agg.cu``, ``scatter_wire_bf16_kernel``).  A row
of V outputs is cut into `want` tiles of 16-byte granules, grouped into
clusters of at most 8 tiles and re-cut evenly over them (the launch takes
the most tiles whose grid the card holds at once, down to tiles of 800
granules; every cut is checked here); a tile accepts the columns of its
granules, given the row's 16-byte phase p (the row starts at element p of
its first granule), and writes them.  The row's wire reaches each CTA
chunk by chunk (1024 entries of one client, client-major), each chunk as
the 16-byte granules of idx, a and b that hold it, read past the head
bytes before its first entry.  The sums are not zero-filled: a mark a
column records a first add (onto +0), and the write takes 0 where no
column is marked.  The model copies those granules out of a byte image of
each array (a view at an offset included), adds in fp32 one chunk after
the other (zero contributions skipped, out-of-range indices dropped),
writes every granule rounded to bf16 once, and is held bitwise to
``scatter_wire_sums_ref(...).to(bf16)``; adding the clients in reverse
order fails on a column that takes 1e8, 1, -1e8, 1.

KL (``csrc/distill_kl.cu``, ``distill_kl_bf16_kernel``).  A row is split
over a cluster of C CTAs of 512 threads (C from the launch's rule); the
c-th slice of the row's granules lands in shared memory stage by stage,
512 granules of each operand a stage, and thread x takes granule x of each
stage: the granule pair's exact maxima of t/T and s/T rescale the thread's
running state only where they grow (a rescale by exactly 1 otherwise),
then its sums of exp(t~ - m_t), exp(t~ - m_t)(t~ - s~) and exp(s~ - m_s)
join the state's; the row's scalar head and tail, and rows on another
16-byte phase than their student, go four elements a thread at a time;
the lanes merge by shuffles, then each CTA's warps (lane w of warp 0
takes warp w), then the CTAs (lane c takes rank c).  The model follows
those steps in numpy fp32 and is held within ``chip_smoke.py``'s tolerance
of ``distill_kl_ref`` on bf16 rows; carrying the sums past a grown maximum
without the rescale fails where the maximum comes late.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

f32 = np.float32
BF16 = torch.bfloat16

# the scatter kernel's constants (kBf16TileGran, kMaxCluster, kChunk, the ring slots)
TILE_GRAN, MAX_CLUSTER, CHUNK, RING = 800, 8, 1024, 3
IDX_BYTES, VAL_BYTES = CHUNK * 4 + 16, CHUNK * 2 + 16
MARKS_OFFSET = 128 + RING * (IDX_BYTES + 2 * VAL_BYTES)  # after the mbarriers and the ring
OPT_IN = 232_448  # H100: the shared memory a block may opt into
# the KL kernel's constants (kThreads = kStageGran) and an H100's SMs
THREADS, SMS = 512, 132


# -- the wire scatter ----------------------------------------------------------


def cut_row(vocab: int, want: int) -> tuple[int, int, int]:
    """(cluster, tiles, granules a tile) of a row of ``vocab`` cut into
    ``want`` tiles, as ``cut_row`` in the kernel's launch cuts it."""
    gran = (vocab + 14) // 8  # a row's granules at its worst phase
    cluster = min(MAX_CLUSTER, want)
    tiles = -(-want // cluster) * cluster
    return cluster, tiles, -(-gran // tiles)


def cuts(vocab: int) -> list[tuple[int, int, int]]:
    """Every cut the launch may take: 1 tile up to tiles of TILE_GRAN."""
    return [cut_row(vocab, want) for want in range(1, -(-((vocab + 14) // 8) // TILE_GRAN) + 1)]


def tile_columns(t: int, per_tile: int, p: int, vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """The columns tile ``t``'s adds accept and those its write covers, on
    a row of 16-byte phase ``p``."""
    width = 8 * per_tile
    c0 = t * width - p
    adds = np.arange(max(c0, 0), min(c0 + width, vocab))
    row_gran = (p + vocab + 7) // 8
    g = np.arange(t * per_tile, min(row_gran, (t + 1) * per_tile))
    cols = (8 * g[:, None] - p + np.arange(8)).ravel()
    return adds, cols[(cols >= 0) & (cols < vocab)]


@pytest.mark.parametrize("vocab", [5, 37, 50_257, 152_064])
def test_tiles_cover_each_column_once_at_every_phase(vocab):
    fits = []
    for cluster, tiles, per_tile in cuts(vocab):
        assert tiles % cluster == 0 and 1 <= cluster <= MAX_CLUSTER
        fits.append(MARKS_OFFSET + -(-per_tile // 16) * 16 + per_tile * 8 * 2 * 4 <= OPT_IN)
        for p in range(8):
            seen = np.zeros(vocab, dtype=np.int64)
            for t in range(tiles):
                adds, cols = tile_columns(t, per_tile, p, vocab)
                assert np.array_equal(adds, cols), (p, t)  # a tile writes what it adds, and only that
                seen[cols] += 1
            assert np.all(seen == 1), (p, tiles, np.flatnonzero(seen != 1)[:5])
    assert fits[-1]  # the smallest tiles always fit a block
    if vocab == 50_257:  # at 64 rows: 2 tiles of 201 KB, one CTA an SM, 64 clusters of 2
        assert cuts(vocab)[1] == (2, 2, 3142) and fits[1] and not fits[0]


def span_of(at: int, e: int, length: int, size: int) -> tuple[int, int, int]:
    """The 16-byte granules holding ``length`` entries of ``size`` bytes from
    entry ``e`` of an array at byte ``at``: (first granule, bytes, head)."""
    start = at + e * size
    lo, hi = start & ~15, (start + length * size + 15) & ~15
    return lo, hi - lo, start - lo


def image(x: np.ndarray, offset: int) -> tuple[np.ndarray, int]:
    """A byte image of ``x`` as a view ``offset`` entries into a 16-byte
    aligned allocation (with the granule after it mapped): the bytes and the
    view's address."""
    at = offset * x.itemsize
    return np.concatenate([np.zeros(at, np.uint8), np.frombuffer(x.tobytes(), np.uint8),
                           np.zeros(32, np.uint8)]), at


def model_scatter(a, b, idx, vocab, offsets=(0, 0, 0), clients=None, want=0):
    """The bf16 scatter kernel's result on bf16 ``a, b`` and int32 ``idx``
    ``(N, rows, k)``, arrays placed ``offsets`` entries into their
    allocations, the row cut into ``want`` tiles (0: the smallest);
    ``clients``: the order the chunks take the clients in."""
    n, rows, k = a.shape
    bits = lambda x: x.contiguous().view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    (mem_a, at_a), (mem_b, at_b), (mem_i, at_i) = (
        image(x, o) for x, o in zip((bits(a), bits(b), idx.numpy().astype(np.int32)), offsets))
    cluster, tiles, per_tile = cuts(vocab)[want - 1 if want else -1]
    width = 8 * per_tile
    order = range(n) if clients is None else clients
    chunks = [(c, j0) for c in order for j0 in range(0, k, CHUNK)]
    num = np.full((rows, vocab), np.nan, f32)
    den = np.full((rows, vocab), np.nan, f32)
    for r in range(rows):
        p = (r * vocab) % 8  # the row's phase in a 16-byte aligned (rows, V) output
        for t in range(tiles):
            c0 = t * width - p
            # no zero-fill: an unmarked sum is never read (NaN here, so that a read shows)
            marks = np.zeros(width, bool)
            s_num, s_den = np.full(width, np.nan, f32), np.full(width, np.nan, f32)
            for c, j0 in chunks:
                length = min(CHUNK, k - j0)
                e = (c * rows + r) * k + j0
                got = []
                for mem, at, size, cap in ((mem_i, at_i, 4, IDX_BYTES), (mem_a, at_a, 2, VAL_BYTES),
                                           (mem_b, at_b, 2, VAL_BYTES)):
                    lo, nbytes, head = span_of(at, e, length, size)
                    assert lo % 16 == 0 and nbytes % 16 == 0 and nbytes <= cap and head < 16
                    slot = mem[lo: lo + nbytes]  # what the bulk copy lands in the ring slot
                    got.append(slot[head: head + length * size])
                w_idx = got[0].view(np.int32)
                va = (got[1].view(np.uint16).astype(np.uint32) << 16).view(f32)
                vb = (got[2].view(np.uint16).astype(np.uint32) << 16).view(f32)
                take = ((w_idx >= 0) & (w_idx < vocab) & (w_idx - c0 >= 0) & (w_idx - c0 < width)
                        & ((va != 0) | (vb != 0)))
                cols = w_idx[take] - c0
                assert np.unique(cols).size == cols.size  # one client's entries: distinct columns
                s_num[cols] = np.where(marks[cols], s_num[cols], f32(0)) + va[take]  # a first add onto +0
                s_den[cols] = np.where(marks[cols], s_den[cols], f32(0)) + vb[take]
                marks[cols] = True
            _, cols = tile_columns(t, per_tile, p, vocab)
            assert np.all(np.isnan(num[r, cols]))  # written once
            # from the sums where marked, else 0
            o = cols - c0
            num[r, cols] = np.where(marks[o], s_num[o], f32(0))
            den[r, cols] = np.where(marks[o], s_den[o], f32(0))
    return tuple(torch.as_tensor(x).to(BF16) for x in (num, den))


ORDER_COL = 777  # takes 1e8, 1, -1e8, 1 from clients 0-3: 1 in order, 0 reversed


def _put(row: np.ndarray, pos: int, col: int) -> None:
    """Entry ``pos`` of a row of distinct indices becomes ``col``, by a swap
    where ``col`` is in the row already."""
    at = np.flatnonzero(row == col)
    if at.size:
        row[at[0]] = row[pos]
    row[pos] = col


def make_wire(n, rows, k, vocab, seed):
    """A bf16 wire with distinct indices per (client, row): a real index-0
    entry of client 0, clients 1 and 3 padding at index 0 with zeros, ~1 %
    out-of-range entries and, for N >= 4 and k >= 3, the order-sensitive
    column.  Also the wire the plain version takes: the out-of-range
    entries made padding (what dropping them means)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.stack([rng.choice(vocab, size=k, replace=False) for _ in range(rows)])
                    for _ in range(n)]).astype(np.int32)
    a = (rng.normal(size=(n, rows, k)) * 3.0).astype(f32)
    b = np.abs(a)
    order = n >= 4 and k >= 3 and vocab > ORDER_COL
    for r in range(rows):
        _put(idx[0, r], 0, 0)
        for c in range(4 if order else 0):
            _put(idx[c, r], 1, ORDER_COL)
    a[0, :, 0] = 2.5
    if order:
        for c, v in enumerate((1e8, 1.0, -1e8, 1.0)):
            a[c, :, 1], b[c, :, 1] = v, abs(v)
    for c in (1, 3):
        if c < n and k > 2:
            idx[c, :, -1], a[c, :, -1], b[c, :, -1] = 0, 0.0, 0.0
    bad = rng.random(size=(n, rows, k)) < 0.01
    bad[:, :, :2] = False
    idx[bad] = np.where(rng.random(int(bad.sum())) < 0.5, -5, vocab + 3)
    out = (idx < 0) | (idx >= vocab)
    clean, clean_a, clean_b = idx.copy(), a.copy(), b.copy()
    clean[out], clean_a[out], clean_b[out] = 0, 0.0, 0.0
    bf = lambda x: torch.as_tensor(x).to(BF16)  # noqa: E731
    return ((bf(a), bf(b), torch.as_tensor(idx)),
            (bf(clean_a), bf(clean_b), torch.as_tensor(clean)))


def plain(wire, vocab):
    a, b, idx = wire
    return [x.to(BF16) for x in ref.scatter_wire_sums_ref(a, b, idx, vocab)]


@pytest.mark.parametrize("n,k,vocab,offsets,want", [
    (1, 1, 50_257, (0, 0, 0), 2),
    (4, 3, 50_257, (3, 1, 1), 0),
    (8, 1000, 50_257, (0, 5, 2), 2),
    (4, 1024, 50_257, (1, 7, 3), 4),
    (2, 2500, 50_257, (1, 3, 2), 2),  # three chunks a client, the last partial
    (2, 1024, 152_064, (0, 0, 0), 0),
    (4, 37, 37, (2, 0, 1), 0),
    (1, 5, 5, (0, 1, 0), 0),
])
def test_chunked_scatter_bitwise_the_plain_version(n, k, vocab, offsets, want):
    wire, clean = make_wire(n, 3, k, vocab, seed=n * 1000 + k)
    got = model_scatter(*wire, vocab, offsets, want=want)
    want = plain(clean, vocab)
    assert all(torch.equal(g.view(torch.int16), w.view(torch.int16)) for g, w in zip(got, want))
    if n >= 4 and k >= 3 and vocab > ORDER_COL:  # the order-sensitive column: the ordered sum
        assert float(want[0][0, ORDER_COL]) == 1.0


def test_scatter_model_out_of_client_order_fails():
    wire, clean = make_wire(4, 2, 1024, 50_257, seed=4)
    want = plain(clean, 50_257)
    got = model_scatter(*wire, 50_257, clients=[3, 2, 1, 0])
    assert float(got[0][0, ORDER_COL]) == 0.0 and not torch.equal(got[0], want[0])


# -- the KL ---------------------------------------------------------------------


def cluster_size(rows: int) -> int:
    """The launch's rule: the largest of 8, 4, 2, 1 with rows * C <= SMs."""
    c = MAX_CLUSTER
    while c > 1 and rows * c > SMS:
        c //= 2
    return c


def fma(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in fp64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def exp(x):
    with np.errstate(invalid="ignore", over="ignore"):
        return np.exp(np.asarray(x, f32)).astype(f32)


class State:
    """Each thread's online state (m, z) of teacher and student and U."""

    def __init__(self, shape):
        self.mt, self.ms = np.full(shape, -np.inf, f32), np.full(shape, -np.inf, f32)
        self.zt, self.zs, self.u = (np.zeros(shape, f32) for _ in range(3))

    def add(self, tt, ss, valid, rescale=True):
        """Values ``tt, ss (threads, n)`` where ``valid``: their maxima, the
        state rescaled to them (by exactly 1 where they do not grow), then
        their sums added (a thread with nothing valid is left as it is)."""
        live = valid.any(axis=1)
        mt = np.maximum(self.mt, np.where(valid, tt, -np.inf).max(axis=1))
        ms = np.maximum(self.ms, np.where(valid, ss, -np.inf).max(axis=1))
        with np.errstate(invalid="ignore"):
            w = np.where(valid, exp(tt - mt[:, None]), f32(0))
            ws = np.where(valid, exp(ss - ms[:, None]), f32(0))
            du = np.where(valid, w * (tt - ss), f32(0))
        zt, zs, u = w.sum(axis=1, dtype=f32), ws.sum(axis=1, dtype=f32), du.sum(axis=1, dtype=f32)
        with np.errstate(invalid="ignore"):  # -inf - -inf where a thread has nothing: not taken
            rt, rs = exp(self.mt - mt), exp(self.ms - ms)  # 0 on a thread's first values
        if not rescale:  # the mutation: sums carried across without the rescale
            rt, rs = np.ones_like(rt), np.ones_like(rs)
        self.zt = np.where(live, fma(self.zt, rt, zt), self.zt)
        self.zs = np.where(live, fma(self.zs, rs, zs), self.zs)
        self.u = np.where(live, fma(self.u, rt, u), self.u)
        self.mt, self.ms = np.where(live, mt, self.mt), np.where(live, ms, self.ms)


def add_scalars(st, t, s, lo, hi):
    """Elements [lo, hi), four a thread a tile (the tile's own rescale)."""
    for c in range(lo, hi, 4 * THREADS):
        e = c + np.arange(THREADS)[:, None] + THREADS * np.arange(4)[None, :]
        valid = e < hi
        e = np.minimum(e, max(hi - 1, 0))
        st.add(t[e], s[e], valid)


def warp_merge(mt, zt, u, ms, zs):
    """Each warp's 32 lanes (last axis) merged as the shuffles merge them:
    the maxima, each lane rescaled once, then xor-butterfly sums; lane 0's
    state."""
    lanes = np.arange(32)
    Mt, Ms = mt.max(axis=-1, keepdims=True), ms.max(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        rt = np.where(mt == -np.inf, f32(0), exp(mt - Mt))
        rs = np.where(ms == -np.inf, f32(0), exp(ms - Ms))
    sums = [zt * rt, u * rt, zs * rs]
    for off in (16, 8, 4, 2, 1):
        sums = [x + x[..., lanes ^ off] for x in sums]
    return Mt[..., 0], sums[0][..., 0], sums[1][..., 0], Ms[..., 0], sums[2][..., 0]


def lanes(mt, zt, u, ms, zs):
    """Up to 32 states as the 32 lanes of a warp, the rest empty (m = -inf,
    sums 0)."""
    n = 32 - len(mt)
    pad = lambda x, v: np.concatenate([np.asarray(x, f32), np.full(n, v, f32)])  # noqa: E731
    return pad(mt, -np.inf), pad(zt, 0), pad(u, 0), pad(ms, -np.inf), pad(zs, 0)


def model_kl(t, s, temp, n_ranks=None, s_phase=0, rescale=True):
    """The bf16 KL kernel's per-row result on bf16 ``t, s (rows, V)`` in
    16-byte aligned buffers, the student's ``s_phase`` elements into its
    buffer; ``n_ranks``: the CTAs a row (by default the launch's rule)."""
    t_all, s_all = (x.float().numpy() for x in (t, s))
    rows, vocab = t_all.shape
    c = cluster_size(rows) if n_ranks is None else n_ranks
    inv = f32(1.0 / temp)
    out = np.zeros(rows, f32)
    for r in range(rows):
        tt, ss = t_all[r] * inv, s_all[r] * inv
        pt, ps = (2 * r * vocab) % 16, (2 * (r * vocab + s_phase)) % 16
        parts = []
        for rank in range(c):
            st = State(THREADS)
            if pt != ps:  # all scalar, a slice a rank
                per = -(-vocab // c)
                lo = min(vocab, rank * per)
                add_scalars(st, tt, ss, lo, min(vocab, lo + per))
                parts.append(warp_merge(*(x.reshape(THREADS // 32, 32)
                                          for x in (st.mt, st.zt, st.u, st.ms, st.zs))))
                continue
            head = min(vocab, ((16 - pt) % 16) // 2)
            n8 = (vocab - head) // 8
            per = -(-n8 // c)
            b0, b1 = min(n8, rank * per), min(n8, rank * per + per)
            if rank == 0:
                add_scalars(st, tt, ss, 0, head)
            for base in range(b0, b1, THREADS):  # a stage: granule base + x to thread x
                g = base + np.arange(THREADS)
                e = head + 8 * np.minimum(g, b1 - 1)[:, None] + np.arange(8)
                st.add(tt[e], ss[e], np.repeat((g < b1)[:, None], 8, axis=1), rescale)
            if rank == c - 1:
                add_scalars(st, tt, ss, head + 8 * n8, vocab)
            parts.append(warp_merge(*(x.reshape(THREADS // 32, 32)
                                      for x in (st.mt, st.zt, st.u, st.ms, st.zs))))
        # each CTA: lane w of warp 0 takes warp w; then lane c of the first CTA's warp 0 takes rank c
        ranks = [warp_merge(*lanes(*part)) for part in parts]
        mt, zt, u, ms, zs = warp_merge(*lanes(*zip(*ranks)))
        lse_t, lse_s = f32(mt + np.log(zt, dtype=f32)), f32(ms + np.log(zs, dtype=f32))
        out[r] = f32(f32(u / zt) - lse_t) + lse_s
    return torch.as_tensor(out)


def kl_tolerance(t, s, temp, want):
    """chip_smoke.py's bound: rtol 1e-5 plus 2e-6 (1 + |lse_t| + |lse_s|)."""
    lse = lambda x: torch.logsumexp(x.double() / temp, dim=-1).float()  # noqa: E731
    return 1e-5 * want.abs() + 2e-6 * (1.0 + lse(t).abs() + lse(s).abs())


def kl_rows(rows, vocab, seed):
    """bf16 teacher and student rows of N(0, 2) with chip_smoke.py's edge
    rows (teacher == student, +-3e4, -1e30 on both and on the teacher only)
    and a row whose maximum sits in the row's last chunk."""
    rng = np.random.default_rng(seed)
    t = 2.0 * rng.normal(size=(rows, vocab)).astype(f32)
    s = 2.0 * rng.normal(size=(rows, vocab)).astype(f32)
    s[0] = t[0]
    t[1] = rng.uniform(-3e4, 3e4, size=vocab)
    s[1] = t[1] + rng.normal(size=vocab)
    t[2, ::3], s[2, ::3] = -1e30, -1e30
    t[3, 1::4] = -1e30
    if rows > 4:
        t[4, -min(9, vocab)] = 40.0
        s[4, -min(20, vocab)] = 30.0
    return (torch.as_tensor(x).to(BF16) for x in (t, s))


@pytest.mark.parametrize("rows,vocab,temp,n_ranks,s_phase", [
    (5, 50_257, 2.0, None, 0),  # 8 CTAs a row at 5 rows
    (5, 50_257, 2.0, 2, 0),  # the main path's 2 (64 rows)
    (5, 50_257, 4.0, 1, 0),  # 1 (from 67 rows): 13 stages, past the ring of 7
    (5, 50_257, 1.0, 2, 1),  # the student on another 16-byte phase: all scalar
    (6, 152_064, 1.0, None, 0),
    (5, 37, 4.0, None, 0),
    (5, 5, 2.0, None, 0),
])
def test_chunk_max_kl_within_tolerance(rows, vocab, temp, n_ranks, s_phase):
    t, s = kl_rows(rows, vocab, seed=vocab + rows + int(temp))
    got = model_kl(t, s, temp, n_ranks, s_phase)
    want = ref.distill_kl_ref(t, s, temp)
    assert bool(((got - want).abs() <= kl_tolerance(t, s, temp, want)).all()), (got - want).abs().max()
    assert float(got[0]) == 0.0  # teacher == student: exactly 0


def test_kl_grown_maxima_need_the_rescale():
    """With one CTA a row each thread takes 12 or 13 granules at V 50 257;
    a rising row grows each thread's maximum with every granule, and sums
    carried over without the rescale miss the tolerance."""
    vocab = 50_257
    ramp = np.linspace(-20.0, 20.0, vocab, dtype=f32)
    rng = np.random.default_rng(2)
    t = torch.as_tensor(np.stack([ramp, ramp + rng.normal(size=vocab).astype(f32)])).to(BF16)
    s = torch.as_tensor(np.stack([ramp[::-1].copy(), ramp])).to(BF16)
    want = ref.distill_kl_ref(t, s, 2.0)
    tol = kl_tolerance(t, s, 2.0, want)
    assert bool(((model_kl(t, s, 2.0, n_ranks=1) - want).abs() <= tol).all())
    bad = model_kl(t, s, 2.0, n_ranks=1, rescale=False)
    assert not bool(((bad - want).abs() <= tol).all()) and math.isfinite(float(bad.abs().max()))
