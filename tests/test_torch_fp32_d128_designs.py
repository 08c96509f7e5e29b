"""CPU models of the design of the port's fp32 attention kernel at head dim 128.

A CUDA kernel cannot run here; these tests pin what the design of
``flash_attention_f32_d128_kernel`` (``csrc/flash_attention.cu``) computes,
in torch and numpy on the CPU, against the plain version in
``repro_torch.kernels.ref`` (itself held to the JAX reference in
``test_torch_kernels_fwd.py``).

The kernel runs both products as TF32 warpgroup products (``wgmma ...
.tf32``), three a product (3xTF32): each fp32 operand x is split into
``big`` (x rounded to TF32, ``cvt.rna``'s rounding) and ``small = x - big``,
exact in fp32, of which the tensor core reads the top 19 bits.  The tensor
core would read a tile as TMA landed it as its own ``big``, truncated rather
than rounded (``small`` then up to 2^-10 |x|, not 2^-11); that misses the
bound at the 96-row x4 case below where rounding holds, so K and V are
rounded into tiles of their own (one landing buffer takes K's and V's
tiles in turn).  S = Q K^T is summed as ``Qb Kb + (Qs Kb + Qb Ks)``, the small terms
in an accumulator of their own, and O += ``(Ps Vb + Pb Vs) + Pb Vb`` a
64-key tile at a time; the scale
enters the exponent, ``2^(s c - m c)`` with ``c = scale · log2(e)``; the
diagonal tile is masked with -inf before the max.  A block of the
persistent grid walks (head-batch, 128 query rows) items longest first; its
two consumer warpgroups of 64 rows each take key tiles 0 .. their diagonal.

The models: that arithmetic over the kernel's tiles and items, held within
``S · 2^-24 · max|v|`` (the bound ``chip_smoke.py`` holds the kernel to) at q,
k scales 1 and 4, causal bitwise, with a late maximum; one TF32 product a
product misses the bound.  Byte-level models of the 128-byte-swizzled tiles
in shared memory (a 512-byte fp32 row is four swizzle spans, so a tile is
four TMA boxes): Q's A fragment as each thread loads it, K's big and small
tiles as the producer splits them out of the landing buffer and their
K-major descriptors, V^T as the producer transposes it out of the landing
buffer, P's A fragment taken from the
accumulators, each read back exactly and their products exact in float64; a
descriptor that does not step across the spans misreads.  The loads and
stores hit distinct banks; the tiles fit one block an SM; the item schedule
takes each item once, longest first.
"""

import itertools
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

KEYS = 64  # keys a K/V tile
ROWS = 64  # query rows a consumer warpgroup
ITEM_ROWS = 128  # query rows an item (two consumer warpgroups)
D = 128
SPAN = 128  # bytes of one span of the 128-byte swizzle: 32 fp32 columns
BLOCK = KEYS * SPAN  # a column block of a 64-row tile: 8 KB
VT_BLOCK = D * SPAN  # a column block (32 keys) of V^T's 128 rows: 16 KB
LOG2E = np.float32(1.4426950408889634)
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


# -- the arithmetic -----------------------------------------------------------


def truncated(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of an fp32 operand, as the tensor core reads it."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits (ties away from zero)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, big=rounded):
    """``big`` (x rounded to TF32 unless said) and ``small = x - big``, exact."""
    b = big(x)
    return b, x - b


def prod3(a: torch.Tensor, b: torch.Tensor, big=rounded, small=truncated) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: the small terms summed apart, then
    added to big·big; the tensor core reads each operand's top 19 bits
    (``big``: how big is formed; ``small``: how small's last bits go)."""
    ab, as_ = split(a, big)
    bb, bs = split(b, big)
    return truncated(ab) @ truncated(bb) + (small(as_) @ truncated(bb) + truncated(ab) @ small(bs))


def prod3_truncated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 with big taken as the tensor core reads x itself: truncated."""
    return prod3(a, b, big=truncated)


def prod1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product a product."""
    return truncated(a) @ truncated(b)


def d128_model(q, k, v, prod=prod3, prescale=False):
    """The kernel's arithmetic over fused head-batches ``(B, S, 128)``: items
    of 128 query rows, each consumer's 64 rows over 64-key tiles 0 .. its
    diagonal, the online softmax with the scale in the exponent (``prescale``:
    q scaled by 128^-0.5 first instead, which rounds)."""
    _, seq, d = q.shape
    scale = np.float32(d**-0.5)
    qs = q * float(scale) if prescale else q
    c = LOG2E if prescale else scale * LOG2E
    out = torch.empty_like(q)
    for q0 in range(0, seq, ITEM_ROWS):
        for wg in range(2):
            r0 = q0 + ROWS * wg
            if r0 >= seq:  # a warpgroup whose rows lie past the sequence
                continue
            qt = qs[:, r0:r0 + ROWS]
            rows = torch.arange(r0, r0 + qt.shape[1])[:, None]
            m = torch.full(qt.shape[:2], -math.inf)
            l = torch.zeros(qt.shape[:2])
            o = torch.zeros_like(qt)
            for j in range(r0 // KEYS + 1):
                kt, vt = k[:, KEYS * j:KEYS * (j + 1)], v[:, KEYS * j:KEYS * (j + 1)]
                s = prod(qt, kt.transpose(1, 2))
                if j == r0 // KEYS:  # the diagonal tile: keys after the query are -inf
                    keys = torch.arange(KEYS * j, KEYS * j + kt.shape[1])[None, :]
                    s = torch.where(keys > rows, -math.inf, s)
                m_new = torch.maximum(m, s.amax(dim=-1))
                r = torch.exp2((m - m_new) * c)
                p = torch.exp2(s * c - (m_new * c)[..., None])
                l = l * r + p.sum(dim=-1)
                o = o * r[..., None] + prod(p, vt)
                m = m_new
            out[:, r0:r0 + ROWS] = o * (1.0 / l)[..., None]
    return out


def qkv(seed, shape, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return torch.as_tensor(q * qk_scale), torch.as_tensor(k * qk_scale), torch.as_tensor(v)


def bound(seq, v):
    return seq * 2.0**-24 * float(v.abs().max())


@pytest.mark.parametrize("big", ["rounded", "truncated"])
def test_split_is_exact(big):
    """big = x rounded to TF32 (or truncated, as the tensor core reads x)
    and small = x - big: exact in fp32, small within 2^-11 |x| rounded and
    below 2^-10 |x| truncated (twice as large), and the tensor core's read
    of small (its own top 19 bits) within 2^-10 |small| of it."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=1 << 14).astype(np.float32))
    b, small = split(x, rounded if big == "rounded" else truncated)
    assert torch.equal(b + small, x)
    assert bool(((b.view(torch.int32) & 0x1FFF) == 0).all())
    if big == "rounded":
        assert bool((small.abs() <= 2.0**-11 * x.abs()).all())
    else:
        assert bool((small.abs() < 2.0**-10 * x.abs()).all())
        assert float((small.abs() / x.abs()).max()) > 2.0**-11
    assert bool(((truncated(small) - small).abs() <= 2.0**-10 * small.abs()).all())


@pytest.mark.parametrize("shape,qk_scale", [((2, 256, 128), 1.0), ((2, 256, 128), 4.0), ((1, 384, 128), 1.0),
                                            ((1, 384, 128), 4.0), ((3, 96, 128), 1.0), ((2, 64, 128), 1.0)])
def test_d128_model_within_the_bound(shape, qk_scale):
    """The card's kinds of case: q, k ~ N(0, 1) at every length, x4 from S
    256 on (the card's x4 case is at S 1 024; shorter x4 rows: below)."""
    q, k, v = qkv(sum(shape) + int(qk_scale), shape, qk_scale)
    got = d128_model(q, k, v)
    err, tol = float((got - ref.flash_attention_ref(q, k, v)).abs().max()), bound(shape[1], v)
    assert err <= tol, (err, tol)


def test_short_rows_at_x4_outgrow_the_bound():
    """The bound S · 2^-24 · max|v| shrinks with S, 3xTF32's score error does
    not: at S 64 with q and k at x4 (scores of deviation ~16) the kernel's
    arithmetic exceeds it on some of eight inputs (as the kernel it replaced
    did: the same split), where exact fp32 products stay within a fifth of
    it.  No card case is that short at x4."""
    worst = {"3xTF32": 0.0, "exact": 0.0}
    for seed in range(8):
        q, k, v = qkv(11 * seed + 64, (3, 64, 128), 4.0)
        want, tol = ref.flash_attention_ref(q, k, v), bound(64, v)
        for name, prod in (("3xTF32", prod3), ("exact", lambda a, b: a @ b)):
            worst[name] = max(worst[name], float((d128_model(q, k, v, prod) - want).abs().max()) / tol)
    assert worst["exact"] < 0.25 and 1.0 < worst["3xTF32"] < 3.0, worst


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 384, 128), (1, 1024, 128)])
def test_truncated_big_within_the_bound_from_256_rows(shape, qk_scale):
    """Big taken by truncation (the landed tiles as the tensor core reads
    them) holds the bound from S 256 on, the card's x4 case (S 1 024)
    among them."""
    q, k, v = qkv(sum(shape) + 3 * int(qk_scale), shape, qk_scale)
    got = d128_model(q, k, v, prod3_truncated)
    err, tol = float((got - ref.flash_attention_ref(q, k, v)).abs().max()), bound(shape[1], v)
    assert err <= tol, (err, tol)


def test_truncated_big_misses_the_bound_at_96_rows_x4():
    """Why the kernel rounds big: at the 96-row case with q and k at x4
    (``test_torch_kernel_designs``' inputs), big by truncation misses the
    bound (small up to 2^-10 |x|: the dropped small·small terms and small's
    own truncation are twice and four times as large), where rounding holds."""
    shape = (3, 96, 128)
    rng = np.random.default_rng(sum(shape) + 4)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32)) for _ in range(3))
    q, k = q * 4.0, k * 4.0
    want, tol = ref.flash_attention_ref(q, k, v), bound(96, v)
    truncated_err = float((d128_model(q, k, v, prod3_truncated) - want).abs().max())
    rounded_err = float((d128_model(q, k, v) - want).abs().max())
    assert rounded_err <= tol < truncated_err, (rounded_err, truncated_err, tol)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_d128_one_tf32_product_misses_the_bound(qk_scale):
    """Why the kernel runs three products a product: one leaves score errors
    of ~2^-10 |q||k|, far beyond the fp32-grade bound."""
    q, k, v = qkv(21 + int(qk_scale), (2, 256, 128), qk_scale)
    want, tol = ref.flash_attention_ref(q, k, v), bound(256, v)
    one = float((d128_model(q, k, v, prod1) - want).abs().max())
    three = float((d128_model(q, k, v) - want).abs().max())
    assert one > 5 * tol and three <= tol, (one, three, tol)
    assert one > 20 * three


def test_d128_model_is_causal_bitwise():
    """k and v from position 150 on never reach rows 0..149: the diagonal's
    keys after each row are -inf before the max, their weight an exact 0."""
    q, k, v = qkv(3, (2, 256, 128))
    base = d128_model(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 150:] = 99.0
    v2[:, 150:] = -99.0
    pert = d128_model(q, k2, v2)
    assert torch.equal(base[:, :150], pert[:, :150])
    assert not torch.equal(base[:, 150:], pert[:, 150:])


def test_d128_model_late_maximum():
    """Row 250's largest score at key 200, in the 64-key tile before its
    own: the earlier tiles' sums are rescaled, and the row lands on v[200]."""
    q, k, v = qkv(5, (1, 256, 128))
    k[0, 200] = 2.0 * q[0, 250]
    got, want = d128_model(q, k, v), ref.flash_attention_ref(q, k, v)
    assert float((got - want).abs().max()) <= bound(256, v)
    assert float((got[0, 250] - v[0, 200]).abs().max()) < 0.05 * float(v.abs().max())


# -- the tiles in shared memory -----------------------------------------------


def swizzled(addr: int) -> int:
    """The 128-byte swizzle on a shared-memory address (1024-byte aligned
    atoms): bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_tile(x: np.ndarray) -> np.ndarray:
    """The 32-bit words a tile of ``x`` (rows, 128) fp32 takes in shared
    memory as four TMA boxes write it: column block c (columns 32c ..) at
    c · rows · 128 bytes, row r at r · 128, 16-byte chunk j at j ^ (r % 8)."""
    rows, d = x.shape
    buf = np.zeros(rows * d, np.uint32)
    for cb, r, j in itertools.product(range(d // 32), range(rows), range(8)):
        at = (cb * rows * SPAN + r * SPAN + 16 * (j ^ (r % 8))) // 4
        buf[at:at + 4] = x[r, 32 * cb + 4 * j:32 * cb + 4 * j + 4]
    return buf


def k_major_operand(buf: np.ndarray, start: int, rows: int) -> np.ndarray:
    """What a K-major TF32 wgmma operand of ``rows`` x 8 reads from a
    descriptor at byte ``start``: row r's two 16-byte chunks at start + (r /
    8) · 1024 (the stride byte offset) + (r % 8) · 128, swizzled."""
    out = np.zeros((rows, 8), np.uint32)
    for r, c in itertools.product(range(rows), range(2)):
        at = swizzled(start + (r // 8) * 1024 + (r % 8) * SPAN + 16 * c) // 4
        out[r, 4 * c:4 * c + 4] = buf[at:at + 4]
    return out


def desc_start(kk: int, block: int) -> int:
    """The kernel's descriptor start for k-step kk: column block kk / 4, 32
    bytes a k-step inside it."""
    return (kk // 4) * block + 32 * (kk % 4)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def test_k_descriptors_step_across_the_four_spans():
    """Q K^T's k-step kk (columns 8kk .. 8kk + 7) reads all 64 keys of K and
    of K's small part as K-major B operands from ``(kk / 4) · 8192 + 32 (kk %
    4)``: four k-steps a span, four spans a row.  A start that steps 32
    bytes a k-step without crossing to the next block misreads k-steps 4-15."""
    rng = np.random.default_rng(1)
    k = words(rng, (KEYS, D))
    kb = tma_tile(k)
    for kk in range(D // 8):
        cols = slice(8 * kk, 8 * kk + 8)
        np.testing.assert_array_equal(k_major_operand(kb, desc_start(kk, BLOCK), KEYS), k[:, cols])
        if kk >= 4:
            assert not np.array_equal(k_major_operand(kb, 32 * kk, KEYS), k[:, cols])


def split_k(landed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K's big and small tiles as the producer writes them: float4 x of the
    landed tile split, big and small each at float4 x of its own tile."""
    big, small = (t.numpy().view(np.uint32) for t in split(torch.as_tensor(landed.view(np.float32))))
    return big, small


def test_k_splits_into_the_descriptors_layout():
    """The producer splits the landed K tile float4 by float4 into K's big and
    small tiles at the offsets it read: both lie in the landed tile's layout,
    and every k-step's descriptors read back K's big and small parts."""
    rng = np.random.default_rng(2)
    k = rng.normal(size=(KEYS, D)).astype(np.float32)
    big, small = split_k(tma_tile(k.view(np.uint32)))
    want_big, want_small = (x.numpy() for x in split(torch.as_tensor(k)))
    np.testing.assert_array_equal(big, tma_tile(want_big.view(np.uint32)))
    for kk in range(D // 8):
        for tile, want in ((big, want_big), (small, want_small)):
            got = k_major_operand(tile, desc_start(kk, BLOCK), KEYS).view(np.float32)
            np.testing.assert_array_equal(got, want[:, 8 * kk:8 * kk + 8])


def q_fragment(qbuf: np.ndarray, wg: int, warp: int, lane: int, kk: int) -> np.ndarray:
    """The four words thread (warp, lane) of consumer ``wg`` loads for
    k-step kk, at the kernel's offsets: row wrow = 16 warp + g of the
    warpgroup's Q half (wg · 32 KB), chunk (2 (kk % 4) + h) ^ g of column
    block kk / 4, word t; a1 and a3 eight rows on."""
    g, t = divmod(lane, 4)
    wrow = 16 * warp + g
    at = (wg * 4 * BLOCK + wrow * SPAN) // 4 + t + (kk // 4) * (BLOCK // 4)
    c0, c1 = ((2 * (kk % 4)) ^ g) << 2, ((2 * (kk % 4) + 1) ^ g) << 2
    row8 = 8 * SPAN // 4
    return np.array([qbuf[at + c0], qbuf[at + c0 + row8], qbuf[at + c1], qbuf[at + c1 + row8]])


def test_q_fragments_read_the_landed_tile():
    """Each thread's A fragment of k-step kk is a0 (row g, column 8kk + t),
    a1 (g + 8, ·), a2 (g, 8kk + t + 4), a3 (g + 8, ·) of its warp's 16 rows,
    read from Q's halves as TMA landed them (each consumer's 64 rows as four
    boxes)."""
    rng = np.random.default_rng(3)
    q = words(rng, (ITEM_ROWS, D))
    qbuf = np.concatenate([tma_tile(q[:ROWS]), tma_tile(q[ROWS:])])
    for wg, warp, lane, kk in itertools.product(range(2), range(4), range(32), range(D // 8)):
        g, t = divmod(lane, 4)
        r = ROWS * wg + 16 * warp + g
        want = [q[r, 8 * kk + t], q[r + 8, 8 * kk + t], q[r, 8 * kk + t + 4], q[r + 8, 8 * kk + t + 4]]
        np.testing.assert_array_equal(q_fragment(qbuf, wg, warp, lane, kk), want)


def transposed(vbuf: np.ndarray) -> np.ndarray:
    """V^T as the producer writes it from V's tile in the landing buffer
    ``vbuf``: thread pt (row d = pt) reads, for k-step kk and position half
    h, keys 8kk + 2e + h (e < 4) at row key, chunk ((d % 32) / 4) ^ (key % 8)
    of column block d / 32, word d % 4, and stores them as one float4 at
    column block kk / 4 of V^T, row d, chunk (2 (kk % 4) + h) ^ (d % 8)."""
    out = np.zeros(2 * VT_BLOCK // 4, np.uint32)
    for pt in range(D):
        v_in = ((pt >> 5) * BLOCK + (pt & 3) * 4) // 4
        dc = (pt >> 2) & 7
        for kk, h in itertools.product(range(KEYS // 8), range(2)):
            x = [vbuf[v_in + (key * SPAN + ((dc ^ (key & 7)) << 4)) // 4]
                 for key in (8 * kk + 2 * e + h for e in range(4))]
            at = ((kk // 4) * VT_BLOCK + pt * SPAN + (((2 * (kk % 4) + h) ^ (pt & 7)) << 4)) // 4
            out[at:at + 4] = x
    return out


# the k positions of a k-step: position p holds key 2p (p < 4) or 2(p - 4) + 1
KEY_OF_POSITION = [0, 2, 4, 6, 1, 3, 5, 7]


def test_vt_descriptors_read_the_transposed_tile():
    """P V's k-step kk reads V^T's 128 rows (one a column of V) as a K-major
    B from ``(kk / 4) · 16384 + 32 (kk % 4)``: row d holds V[8kk + key of
    position p, d] at position p, the order in which P's fragment takes the
    keys.  Without the step to the second block it misreads k-steps 4-7."""
    rng = np.random.default_rng(4)
    v = words(rng, (KEYS, D))
    vt = transposed(tma_tile(v))
    for kk in range(KEYS // 8):
        want = v[[8 * kk + p for p in KEY_OF_POSITION]].T
        np.testing.assert_array_equal(k_major_operand(vt, desc_start(kk, VT_BLOCK), D), want)
        if kk >= 4:
            assert not np.array_equal(k_major_operand(vt, 32 * kk, D), want)


def fragment_matrix(regs) -> np.ndarray:
    """The 64 x 8 A operand of a TF32 wgmma from its warpgroup's registers
    ``regs[warp][lane]`` = (a0, a1, a2, a3): a0 (row g, column t), a1 (g + 8,
    t), a2 (g, t + 4), a3 (g + 8, t + 4) of warp w's rows 16w ..; each
    element held once."""
    a = np.full((ROWS, 8), np.nan)
    for warp, lane in itertools.product(range(4), range(32)):
        g, t = divmod(lane, 4)
        r = 16 * warp + g
        for (dr, dc), x in zip(((0, 0), (8, 0), (0, 4), (8, 4)), regs[warp][lane]):
            assert np.isnan(a[r + dr, t + dc])
            a[r + dr, t + dc] = x
    return a


def test_warpgroup_fragments_give_the_products():
    """One consumer warpgroup against one 64-key tile, in float64: S = Q K^T
    summed over 16 k-steps of each thread's Q fragments against K's
    descriptors, laid out as the accumulator fragment (d[4i + e]: row 16 warp
    + g + 8 (e / 2), key 8i + 2t + (e % 2)); then O = P V with P's A fragment
    of k-step kk taken from those accumulators in place (a0 = d[4kk], a1 =
    d[4kk + 2], a2 = d[4kk + 1], a3 = d[4kk + 3]) against V^T's descriptors.
    Exact: the layouts and the key permutation agree."""
    rng = np.random.default_rng(5)
    q = rng.integers(-8, 8, (ITEM_ROWS, D)).astype(np.float32)
    k = rng.integers(-8, 8, (KEYS, D)).astype(np.float32)
    v = rng.integers(-8, 8, (KEYS, D)).astype(np.float32)
    qbuf = np.concatenate([tma_tile(q[:ROWS].view(np.uint32)), tma_tile(q[ROWS:].view(np.uint32))])
    kbuf, vt = tma_tile(k.view(np.uint32)), transposed(tma_tile(v.view(np.uint32)))
    for wg in range(2):
        s = np.zeros((ROWS, KEYS))
        for kk in range(D // 8):
            a = fragment_matrix([[q_fragment(qbuf, wg, warp, lane, kk).view(np.float32) for lane in range(32)]
                                 for warp in range(4)])
            b = k_major_operand(kbuf, desc_start(kk, BLOCK), KEYS).view(np.float32)
            s += a @ b.T.astype(np.float64)
        np.testing.assert_array_equal(s, q[ROWS * wg:ROWS * wg + ROWS].astype(np.float64) @ k.T)
        # each thread's accumulators
        acc = [[[s[16 * warp + (lane >> 2) + 8 * ((x & 3) >> 1), 8 * (x >> 2) + 2 * (lane & 3) + (x & 1)]
                 for x in range(32)] for lane in range(32)] for warp in range(4)]
        o = np.zeros((ROWS, D))
        for kk in range(KEYS // 8):
            regs = [[[d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]] for d in w] for w in acc]
            b = k_major_operand(vt, desc_start(kk, VT_BLOCK), D).view(np.float32)
            o += fragment_matrix(regs) @ b.T.astype(np.float64)
        np.testing.assert_array_equal(o, s @ v.astype(np.float64))


def test_loads_and_stores_hit_distinct_banks():
    """Each warp's shared-memory accesses: a Q fragment word (a0..a3) over
    32 distinct banks; the producer's reads of V's landing buffer (lanes on
    32 consecutive columns of one key) over 32 banks; its float4 stores into
    V^T (8 lanes a phase) over 8 distinct 16-byte chunks, all 32 banks; K's
    small part float4 by float4 at consecutive offsets."""
    qbuf_words = np.arange(2 * 4 * BLOCK // 4)  # word addresses
    for warp, kk in itertools.product(range(4), range(D // 8)):
        frag = np.array([q_fragment(qbuf_words, 0, warp, lane, kk) for lane in range(32)])
        for reg in range(4):
            assert len({int(w) % 32 for w in frag[:, reg]}) == 32, (warp, kk, reg)
    for w, key in itertools.product(range(4), range(KEYS)):
        banks = set()
        for lane in range(32):
            pt = 32 * w + lane
            at = ((pt >> 5) * BLOCK + (pt & 3) * 4 + key * SPAN + ((((pt >> 2) & 7) ^ (key & 7)) << 4)) // 4
            banks.add(at % 32)
        assert len(banks) == 32, (w, key)
    for w, kk, h, phase in itertools.product(range(4), range(KEYS // 8), range(2), range(4)):
        chunks = set()
        for lane in range(8 * phase, 8 * phase + 8):
            pt = 32 * w + lane
            at = (kk // 4) * VT_BLOCK + pt * SPAN + (((2 * (kk % 4) + h) ^ (pt & 7)) << 4)
            chunks.add((at // 16) % 8)
        assert len(chunks) == 8, (w, kk, h, phase)


def test_d128_tiles_fit_one_block_an_sm():
    """Q's two halves, K's big and small parts, the landing buffer, V^T's big
    and small parts: 7 x 32 KB and 1 KB of alignment, within a block's 227 KB
    with the barriers; a second stage of K or of V^T (64 KB more) would not
    fit.  The registers: 128 producer threads at 56 and 256 consumer
    threads at 224, within the SM's 65 536."""
    src = (CSRC / "flash_attention.cu").read_text()
    assert "constexpr int kF32Smem = 1024 + 7 * kF32Tile;" in src
    assert "constexpr int kF32ProducerRegs = 56, kF32ConsumerRegs = 224;" in src
    tile, limit = KEYS * D * 4, 232_448
    assert tile == 4 * BLOCK == 2 * VT_BLOCK == 32 * 1024
    smem = 1024 + 7 * tile
    assert smem + 256 <= limit < smem + 2 * tile
    assert 128 * 56 + 256 * 224 <= 65_536


def item_schedule(n_bh: int, seq: int, sms: int) -> list[list[tuple[int, int]]]:
    """Each block's (head-batch, first query row) items in the order it takes
    them: G = min(SMs, items) blocks; block b takes item ``r G + (r odd ? G -
    1 - b : b)`` in round r while that is below the item count; item i is
    the 128 rows from 128 (n_qt - 1 - i / n_bh) of head-batch i % n_bh."""
    n_qt = -(-seq // ITEM_ROWS)
    items = n_bh * n_qt
    grid = min(sms, items)
    slots = [[r * grid + (grid - 1 - b if r & 1 else b) for r in range(-(-items // grid))] for b in range(grid)]
    return [[(i % n_bh, ITEM_ROWS * (n_qt - 1 - i // n_bh)) for i in mine if i < items] for mine in slots]


@pytest.mark.parametrize("n_bh,seq", [(96, 1024), (20, 128), (20, 64), (12, 96), (24, 1024), (8, 1024),
                                      (12, 256), (32, 32768)])
def test_item_schedule_takes_each_item_once_longest_first(n_bh, seq):
    """At the card cases' shapes, on 132 SMs (an H100) and on fewer: every
    item is taken exactly once; each block takes its items longest first;
    the blocks' key tiles differ by at most one item's; and the kernel's
    producer and consumers walk the same items and key tiles."""
    src = (CSRC / "flash_attention.cu").read_text()
    assert "return r * G + ((r & 1) ? G - 1 - b : b);" in src
    assert src.count("const int bh = i % n_bh, q0 = kBlockRows * (n_qt - 1 - i / n_bh);") == 2
    assert src.count("const int n_item = max(f32_tiles(q0, 0, seq), f32_tiles(q0, 1, seq));") == 2
    n_qt = -(-seq // ITEM_ROWS)
    for sms in (132, 7, 1):
        blocks = item_schedule(n_bh, seq, sms)
        taken = sorted(item for mine in blocks for item in mine)
        assert taken == sorted(itertools.product(range(n_bh), range(0, ITEM_ROWS * n_qt, ITEM_ROWS)))
        assert all(a[1] >= b[1] for mine in blocks for a, b in zip(mine, mine[1:]))
        tiles = [sum(min(-(-seq // KEYS), (q0 + ITEM_ROWS) // KEYS) for _, q0 in mine) for mine in blocks]
        assert max(tiles) - min(tiles) <= 2 * n_qt, (sms, min(tiles), max(tiles))
