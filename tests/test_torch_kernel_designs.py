"""CPU models of the arithmetic of the port's attention and KL kernels.

A CUDA kernel cannot run here; these tests pin what its design computes, in
torch on the CPU, against the plain versions in ``repro_torch.kernels.ref``
(themselves held to the JAX reference in ``test_torch_kernels_fwd.py``).

Attention (``csrc/flash_attention.cu``).  The kernel runs both products on
the tensor cores in TF32, three products per product (3xTF32): an fp32 x
is split into ``big = tf32(x)`` (``cvt.rna``: round to nearest, ties away,
to the top 19 bits, done with two integer operations) and ``small = x -
big`` (exact), of which the tensor core reads the top 19 bits, and a
product is ``small·big + big·small + big·big``.  The model rounds on the bits, walks
64-key tiles in order with the online softmax, masks the diagonal tile
with -inf, and is held within ``S · 2^-24 · max|v|`` (the bound
``chip_smoke.py`` holds the kernel to); a model with one TF32 product per
product misses that bound, which is why the kernel splits.  A register-level
model of one warp's ``mma.sync.m16n8k8`` fragments follows the kernel's
index expressions and is held exactly to the plain products.  At head dim
128 a kernel of its own (``flash_attention_f32_d128_kernel``, modelled in
``test_torch_fp32_d128_designs.py``) runs TF32 warpgroup products on 64-key
tiles with the same split, the small terms summed apart, and does not scale
q (128^-0.5 = 2^-3.5 would round): the scale enters the exponent,
``2^(s c - m c)`` with ``c = scale · log2(e)``.  The D = 128 cases here run
that model and its warp fragments.

KL (``csrc/distill_kl.cu``).  The model follows the kernel's indexing: a
row split over C CTAs of 512 threads, each thread's strided 16-byte
granules each one 4-element tile (tile max, one rescale, then the sums),
the scalar head and tail of masked 4-element tiles, the all-scalar walk of
rows on different 16-byte phases, then the merges in the kernel's order:
each warp's lanes (maxima first), then lane l of one warp over the
cluster's warp states l, l + 32, ..., then that warp's lanes again.  Its
exps are the kernel's ``__expf`` (2 to the power of the rounded x · log2 e;
the hardware's ex2 is within a few ulps of torch's).  Each element is
shown to be added exactly once; the model is held within the per-row
tolerance ``chip_smoke.py`` uses and gives exactly 0 for a teacher equal
to its student, for C in {1, 3, 8}, on rows at every phase and on rows
narrower than C slices.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

import test_torch_fp32_d128_designs as d128  # noqa: E402  (the D = 128 kernel's models)

KEYS = 64  # the attention kernel's query tile, and its key tile at D = 64
LOG2E = np.float32(1.4426950408889634)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits: add half of the 13 dropped bits to
    the magnitude, then clear them (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of an fp32 operand, as the tensor core reads it."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, truncated(x - big)


def prod3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: small terms first, then big·big."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def prod1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def prod3_rna(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32 with the small parts rounded too (``cvt.rna`` on both)."""
    ab, bb = tf32(a), tf32(b)
    return (tf32(a - ab) @ bb + ab @ tf32(b - bb)) + ab @ bb


def attention_model(q, k, v, prod=None, prescale=None):
    """The kernels' tiles and online softmax over fused head-batches
    ``(B, S, D)`` fp32.  D = 64: q scaled by 2^-3 first (exact), 64-key
    tiles, ``prod`` (3xTF32 with big rounded unless said).  D = 128: the
    D = 128 kernel's model (``d128.d128_model``: big by truncation unless
    ``prod`` says otherwise, q unscaled and the scale in the exponent unless
    ``prescale``)."""
    _, seq, d = q.shape
    if d == 128:
        return d128.d128_model(q, k, v, prod or d128.prod3, bool(prescale))
    prod = prod or prod3
    qs = q * d**-0.5 if prescale in (None, True) else q  # 2^-3 at D = 64: exact
    c = LOG2E if prescale in (None, True) else np.float32(d**-0.5) * LOG2E
    out = torch.empty_like(q)
    for q0 in range(0, seq, KEYS):
        qt = qs[:, q0:q0 + KEYS]
        rows = torch.arange(q0, q0 + qt.shape[1])[:, None]
        m = torch.full(qt.shape[:2], -math.inf)
        l = torch.zeros(qt.shape[:2])
        o = torch.zeros_like(qt)
        for k0 in range(0, q0 + KEYS, KEYS):
            kt, vt = k[:, k0:k0 + KEYS], v[:, k0:k0 + KEYS]
            s = prod(qt, kt.transpose(1, 2))
            if k0 == q0:  # the diagonal tile: keys after the query are -inf
                keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
                s = torch.where(keys > rows, -math.inf, s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            r = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - (m_new * c)[..., None])
            l = l * r + p.sum(dim=-1)
            o = o * r[..., None] + prod(p, vt)
            m = m_new
        out[:, q0:q0 + KEYS] = o * (1.0 / l)[..., None]
    return out


def _qkv(seed, shape, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return (torch.as_tensor(q * qk_scale), torch.as_tensor(k * qk_scale), torch.as_tensor(v))


def _bound(seq, v):
    return seq * 2.0**-24 * float(v.abs().max())


def test_tf32_rounding_on_the_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11), 1.0 + 3 * 2**-12,
                      3.0e38, -7.5e-39, 0.0], dtype=torch.float32)
    got = tf32(x)
    # 10 fraction bits: ties at 2^-11 go away from zero, 1 + 3·2^-12 rounds up
    want = torch.tensor([1.0 + 2**-10, 1.0 + 2**-10, 1.0, -(1.0 + 2**-10), 1.0 + 2**-10],
                        dtype=torch.float32)
    assert torch.equal(got[:5], want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    y = torch.as_tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    big, small = split(y)
    assert bool(((big - y).abs() <= 2.0**-11 * y.abs()).all())
    assert torch.equal(y - big + big, y)  # x - big is exact in fp32
    assert bool(((big + small - y).abs() <= 2.0**-21 * y.abs()).all())
    # the integer rounding is cvt.rna's: the same as numpy's round-half-away on the
    # 10 fraction bits, checked in float64
    z = y.double().numpy()
    e = np.floor(np.log2(np.abs(z)))
    want = np.sign(z) * np.floor(np.abs(z) / 2.0 ** (e - 10) + 0.5) * 2.0 ** (e - 10)
    np.testing.assert_array_equal(big.double().numpy(), want)


# the small part as the tensor core reads it (truncated) or rounded first;
# at D = 128 the D = 128 kernel's arithmetic (the small terms summed apart)
PRODS = {("truncated small", 64): prod3, ("rounded small", 64): prod3_rna,
         ("truncated small", 128): d128.prod3,
         ("rounded small", 128): lambda a, b: d128.prod3(a, b, small=d128.rounded)}


@pytest.mark.parametrize("prod", ["truncated small", "rounded small"])
@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
@pytest.mark.parametrize("shape", [(2, 256, 64), (3, 96, 64), (2, 256, 128), (3, 96, 128)])
def test_3xtf32_attention_model_within_the_bound(shape, qk_scale, prod):
    q, k, v = _qkv(sum(shape) + int(qk_scale), shape, qk_scale)
    got = attention_model(q, k, v, PRODS[prod, shape[2]])
    want = ref.flash_attention_ref(q, k, v)
    err, tol = float((got - want).abs().max()), _bound(shape[1], v)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_one_tf32_product_misses_the_bound(qk_scale):
    """Why the kernel splits: one TF32 product per product leaves score
    errors of ~2^-11 |q||k|, beyond the fp32-grade bound."""
    q, k, v = _qkv(11, (2, 256, 64), qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    tol = _bound(256, v)
    one = float((attention_model(q, k, v, prod1) - want).abs().max())
    three = float((attention_model(q, k, v, prod3) - want).abs().max())
    assert one > 5 * tol and three <= tol, (one, three, tol)
    assert one > 20 * three


def _check_causal(d):
    q, k, v = _qkv(3, (2, 256, d))
    base = attention_model(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 150:] = 99.0
    v2[:, 150:] = -99.0
    pert = attention_model(q, k2, v2)
    assert torch.equal(base[:, :150], pert[:, :150])
    assert not torch.equal(base[:, 150:], pert[:, 150:])


def _check_late_maximum(d):
    q, k, v = _qkv(5, (1, 256, d))
    k[0, 200] = 2.0 * q[0, 250]  # row 250's largest score, in a late key tile
    got, want = attention_model(q, k, v), ref.flash_attention_ref(q, k, v)
    assert float((got - want).abs().max()) <= _bound(256, v)
    assert float((got[0, 250] - v[0, 200]).abs().max()) < 0.05 * float(v.abs().max())


def test_attention_model_is_causal_bitwise():
    _check_causal(64)


def test_attention_model_late_maximum():
    """A row whose largest score arrives in a late key tile rescales what
    the earlier tiles summed."""
    _check_late_maximum(64)


def test_attention_model_at_d128_is_causal_bitwise():
    """At D = 128 too, where an item's two warpgroups of 64 rows end on
    different 64-key tiles."""
    _check_causal(128)


def test_attention_model_at_d128_late_maximum():
    _check_late_maximum(128)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_d128_scale_in_the_exponent_within_the_bound(qk_scale):
    """At D = 128 the scale 2^-3.5 is not exact in fp32: q scaled by it
    rounds, where the plain version rounds only the scores times the scale.
    The D = 128 kernel leaves q whole and puts the scale into the exponent;
    that model is within the bound at both q, k scales (and so is the
    rounded pre-scaling at these sizes: the exponent route is the one with
    no extra rounding of q)."""
    scale = np.float32(128**-0.5)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=4096).astype(np.float32))
    assert not torch.equal((x * float(scale)) / float(scale), x)  # pre-scaling rounds q
    q, k, v = _qkv(40 + int(qk_scale), (2, 256, 128), qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    for prescale in (False, True):
        got = attention_model(q, k, v, prescale=prescale)
        assert float((got - want).abs().max()) <= _bound(256, v), prescale


def test_one_tf32_product_misses_the_bound_at_d128():
    """One TF32 product per product misses the bound at D = 128 as well,
    where the D = 128 kernel's three are within it."""
    q, k, v = _qkv(12, (2, 256, 128), 4.0)
    want = ref.flash_attention_ref(q, k, v)
    one = float((attention_model(q, k, v, d128.prod1) - want).abs().max())
    three = float((attention_model(q, k, v) - want).abs().max())
    assert one > 5 * _bound(256, v) and three <= _bound(256, v), (one, three)


# -- one warp's fragments -----------------------------------------------------


def _mma_m16n8k8(c, a, b):
    """``mma.sync.aligned.m16n8k8.row.col`` over one warp's registers, laid
    out as the PTX ISA gives them (g = lane / 4, t = lane % 4): A (16 x 8)
    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8)
    b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
    c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  ``a (32, 4)``, ``b (32, 2)``,
    ``c (32, 4)`` float64 -> the new ``c``."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c[lane]
    D = C + A @ B
    out = np.empty_like(c)
    for lane in range(32):
        g, t = divmod(lane, 4)
        out[lane] = D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]
    return out


def test_warp_fragments_follow_the_kernels_indexing():
    """One warp's 16 query rows against one 64-key tile, the registers
    indexed as ``flash_attention.cu`` indexes them: in k-step 2m + h the q
    A fragments and K's B fragments take d = 16m + 4t + 2h (column t) and
    the next d (column t + 4), so a lane reads K's four values of a step
    pair as one float4 ``ks[(8j + g)·stride + 16m + 4t]``; then P's A
    fragments taken from the S accumulators without a shuffle (a0 = c0,
    a1 = c2, a2 = c1, a3 = c3) against V's B fragments from rows 2t and
    2t + 1.  Exact in float64: S = q k^T, O = P V."""
    _warp_fragments(64, KEYS)


def test_warp_fragments_at_d128():
    """The D = 128 kernel's fragments, one warp's 16 rows of its warpgroup:
    a TF32 wgmma's A and accumulator fragments are, warp by warp, the
    m16n8k8 ones, N / 8 of them side by side.  Q's A fragment of k-step kk
    in the natural order (a0 (g, 8kk + t), a2 (g, 8kk + t + 4): the K-major
    descriptor reads K's columns 8kk .. 8kk + 7 in order) over 16 k-steps
    into a 64-key tile's 8 n-tiles; then P's A fragment from the
    accumulators as at D = 64 against V^T's positions (t: key 2t, t + 4:
    key 2t + 1), 16 output n-tiles."""
    _warp_fragments(128, d128.KEYS, natural=True)


def _warp_fragments(d, keys, natural=False):
    rng = np.random.default_rng(1)
    qt, ks, vs = rng.normal(size=(16, d)), rng.normal(size=(keys, d)), rng.normal(size=(keys, d))
    lanes = [divmod(lane, 4) for lane in range(32)]
    if natural:  # k-step kk: columns 8kk + t and 8kk + t + 4
        cols = [[(8 * kk + t, 8 * kk + t + 4) for _, t in lanes] for kk in range(d // 8)]
    else:  # k-step 2m + h: columns 16m + 4t + 2h and the next
        cols = [[(16 * m + 4 * t + 2 * h, 16 * m + 4 * t + 2 * h + 1) for _, t in lanes]
                for m in range(d // 16) for h in range(2)]
    qa = [np.array([[qt[g, c0], qt[g + 8, c0], qt[g, c1], qt[g + 8, c1]]
                    for (g, _), (c0, c1) in zip(lanes, step)]) for step in cols]
    s = []
    for j in range(keys // 8):
        c = np.zeros((32, 4))
        for kk, step in enumerate(cols):
            b = np.array([[ks[8 * j + g, c0], ks[8 * j + g, c1]] for (g, _), (c0, c1) in zip(lanes, step)])
            c = _mma_m16n8k8(c, qa[kk], b)
        s.append(c)
    S = np.empty((16, keys))
    for j in range(keys // 8):
        for lane, (g, t) in enumerate(lanes):
            S[g, 8 * j + 2 * t: 8 * j + 2 * t + 2] = s[j][lane, :2]
            S[g + 8, 8 * j + 2 * t: 8 * j + 2 * t + 2] = s[j][lane, 2:]
    np.testing.assert_allclose(S, qt @ ks.T, rtol=0, atol=1e-12)
    P = np.exp(S - S.max(axis=1, keepdims=True))
    p = [np.array([[P[g, 8 * j + 2 * t], P[g, 8 * j + 2 * t + 1], P[g + 8, 8 * j + 2 * t],
                    P[g + 8, 8 * j + 2 * t + 1]] for g, t in lanes]) for j in range(keys // 8)]
    O = np.empty((16, d))
    for nd in range(d // 8):
        c = np.zeros((32, 4))
        for j in range(keys // 8):
            a = p[j][:, [0, 2, 1, 3]]
            b = np.array([[vs[8 * j + 2 * t, 8 * nd + g], vs[8 * j + 2 * t + 1, 8 * nd + g]]
                          for g, t in lanes])
            c = _mma_m16n8k8(c, a, b)
        for lane, (g, t) in enumerate(lanes):
            O[g, 8 * nd + 2 * t: 8 * nd + 2 * t + 2] = c[lane, :2]
            O[g + 8, 8 * nd + 2 * t: 8 * nd + 2 * t + 2] = c[lane, 2:]
    np.testing.assert_allclose(O, P @ vs, rtol=0, atol=1e-12)


def test_padded_rows_spread_fragment_loads_over_the_banks():
    """K's rows padded to 80 floats: a 16-byte load of each lane (row g,
    columns 4t..4t+3) runs in quarter-warp phases of 8 lanes, each over 32
    distinct banks.  V's rows padded to 68 floats: a 4-byte load (rows 2t
    and 2t + 1, column g) touches 32 distinct banks.  Unpadded rows of 64
    collide."""
    lanes = [divmod(lane, 4) for lane in range(32)]

    def k_phases(stride):  # fewest distinct banks of a phase's 8 x 4 words
        return min(len({(g * stride + 4 * t + w) % 32 for g, t in lanes[p:p + 8] for w in range(4)})
                   for p in range(0, 32, 8))

    def v_banks(stride):
        v0 = {(2 * t * stride + g) % 32 for g, t in lanes}
        v1 = {((2 * t + 1) * stride + g) % 32 for g, t in lanes}
        return min(len(v0), len(v1))

    assert k_phases(80) == 32 and k_phases(64) <= 16
    assert v_banks(68) == 32 and v_banks(64) <= 8


# -- the split-row KL ---------------------------------------------------------


KL_THREADS = 512  # distill_kl.cu's kThreads
KL_WARPS = KL_THREADS // 32
LOG2E = np.float32(1.4426950408889634)


def kl_thread_tiles(vocab, ranks, phase_t=0, phase_s=0):
    """The element indices each thread of a row's cluster adds, tile by
    tile, in ``distill_kl_kernel``'s order: int64 ``(ranks, threads, tiles,
    4)``, -1 where an element is masked or a thread has no such tile.
    ``phase_*`` is the row's first element's offset from a 16-byte boundary,
    in floats.

    Rows on one phase: rank 0 first adds the scalar head up to the 16-byte
    boundary, then every rank walks its contiguous slice of the granules
    [b0, b1): thread ``x`` takes granules ``b0 + x, b0 + x + threads, ...``,
    each a tile of its 4 elements; rank C - 1 last adds the scalar tail.  A
    scalar tile of ``[lo, hi)`` is elements ``c + j·threads``, j < 4, for
    ``c = lo + x, lo + x + 4·threads, ...``, masked past ``hi``.  Rows on
    different phases: each rank adds its contiguous slice of the elements in
    scalar tiles."""
    x = np.arange(KL_THREADS)[:, None]
    j = np.arange(4)[None, :]

    def scalars(lo, hi):
        tiles = []
        for c0 in range(lo, hi, 4 * KL_THREADS):
            e = c0 + x + KL_THREADS * j
            tiles.append(np.where((e < hi) & (c0 + x < hi), e, -1))
        return tiles

    per_rank = []
    for rank in range(ranks):
        tiles = []
        if phase_t % 4 == phase_s % 4:
            head = min(vocab, (4 - phase_t % 4) % 4)
            n4 = (vocab - head) // 4
            chunk = -(-n4 // ranks)
            b0 = min(n4, rank * chunk)
            b1 = min(n4, b0 + chunk)
            if rank == 0:
                tiles += scalars(0, head)
            for i0 in range(b0, b1, KL_THREADS):
                g = i0 + x  # each thread's granule
                tiles.append(np.where(g < b1, head + 4 * g + j, -1))
            if rank == ranks - 1:
                tiles += scalars(head + 4 * n4, vocab)
        else:
            chunk = -(-vocab // ranks)
            lo = min(vocab, rank * chunk)
            tiles += scalars(lo, min(vocab, lo + chunk))
        per_rank.append(tiles)
    n = max(1, max(len(t) for t in per_rank))
    out = np.full((ranks, KL_THREADS, n, 4), -1)
    for rank, tiles in enumerate(per_rank):
        for k, tile in enumerate(tiles):
            out[rank, :, k] = tile
    return out


def _exp(x):
    """``__expf``: 2 to the power of the fp32 product x · log2(e)."""
    return torch.exp2(x * LOG2E)


def _fma(a, b, c):
    """``fmaf`` in float64: the product of two floats is exact there, and
    the sum rounds once before the rounding to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _empty(shape):
    ninf, zero = torch.full(shape, -math.inf), torch.zeros(shape)
    return {"mt": ninf, "zt": zero, "u": zero, "ms": ninf, "zs": zero}


def _add_tile(st, tt, ss, valid):
    """``add_tile``: the tile's maxima, one rescale, then the sums in
    element order; a tile with no valid element leaves the state as it is."""
    ninf = torch.tensor(-math.inf)
    mt = torch.maximum(st["mt"], torch.where(valid, tt, ninf).amax(-1))
    ms = torch.maximum(st["ms"], torch.where(valid, ss, ninf).amax(-1))
    zt = zs = u = torch.zeros(mt.shape)
    for i in range(tt.shape[-1]):
        w = torch.where(valid[..., i], _exp(tt[..., i] - mt), 0.0)
        zt = zt + w
        u = _fma(w, torch.where(valid[..., i], tt[..., i] - ss[..., i], 0.0), u)
        zs = zs + torch.where(valid[..., i], _exp(ss[..., i] - ms), 0.0)
    rt, rs = _exp(st["mt"] - mt), _exp(st["ms"] - ms)
    new = {"mt": mt, "zt": _fma(st["zt"], rt, zt), "u": _fma(st["u"], rt, u), "ms": ms,
           "zs": _fma(st["zs"], rs, zs)}
    some = valid.any(-1)
    return {key: torch.where(some, new[key], st[key]) for key in st}


def _warp_merge(st):
    """``warp_merge`` over the last axis (32 lanes): the maxima, each lane's
    sums rescaled to them once, then the xor-butterfly sums."""
    lanes = torch.arange(32)
    mt, ms = st["mt"].amax(-1, keepdim=True), st["ms"].amax(-1, keepdim=True)
    rt = torch.where(st["mt"] == -math.inf, 0.0, _exp(st["mt"] - mt))
    rs = torch.where(st["ms"] == -math.inf, 0.0, _exp(st["ms"] - ms))
    sums = {"zt": st["zt"] * rt, "u": st["u"] * rt, "zs": st["zs"] * rs}
    for off in (16, 8, 4, 2, 1):
        sums = {key: x + x[..., lanes ^ off] for key, x in sums.items()}
    return {"mt": mt.expand_as(st["mt"]), "ms": ms.expand_as(st["ms"]), **sums}


def _lse_merge(am, az, bm, bz):
    """``lse_merge``: the merged (m, z) and the rescales of a's and b's sums."""
    m = torch.maximum(am, bm)
    ra = torch.where(bm == -math.inf, 1.0, torch.where(am == -math.inf, 0.0, _exp(am - m)))
    rb = torch.where(bm == -math.inf, 0.0, torch.where(am == -math.inf, 1.0, _exp(bm - m)))
    both = (am > -math.inf) & (bm > -math.inf)
    z = torch.where(both, _fma(az, ra, bz * rb), torch.where(bm == -math.inf, az, bz))
    return m, z, ra, rb


def kl_model(t, s, temp, ranks, offset_t=0, offset_s=0):
    """Per-row KL as ``distill_kl.cu`` forms it: each thread of the row's
    cluster walks its tiles (``kl_thread_tiles``) into its own state; each
    warp merges its lanes (``_warp_merge``); lane l of rank 0's warp 0
    merges the cluster's ``ranks · 16`` warp states l, l + 32, ... in turn
    (state i is warp i % 16 of rank i / 16), and warp 0 merges its lanes
    again.  ``offset_*``: the tensors' first elements' offsets from a
    16-byte boundary, in floats."""
    rows, vocab = t.shape
    inv = np.float32(1.0 / temp)
    got = torch.empty(rows)
    for r in range(rows):
        tiles = torch.as_tensor(kl_thread_tiles(vocab, ranks, (offset_t + r * vocab) % 4,
                                                (offset_s + r * vocab) % 4))
        tr, sr = t[r].float() * inv, s[r].float() * inv
        st = _empty((ranks, KL_THREADS))
        for j in range(tiles.shape[2]):
            idx = tiles[:, :, j]
            st = _add_tile(st, tr[idx.clamp(min=0)], sr[idx.clamp(min=0)], idx >= 0)
        st = _warp_merge({key: x.reshape(ranks, KL_WARPS, 32) for key, x in st.items()})
        parts = {key: x[:, :, 0].reshape(-1) for key, x in st.items()}  # i = rank · 16 + warp
        steps = -(-ranks * KL_WARPS // 32)
        pad = {key: torch.cat([x, _empty((steps * 32 - x.numel(),))[key]]) for key, x in parts.items()}
        a = _empty((32,))
        for step in range(steps):
            b = {key: x[32 * step: 32 * step + 32] for key, x in pad.items()}
            a["mt"], a["zt"], ra, rb = _lse_merge(a["mt"], a["zt"], b["mt"], b["zt"])
            a["u"] = _fma(a["u"], ra, b["u"] * rb)
            a["ms"], a["zs"], _, _ = _lse_merge(a["ms"], a["zs"], b["ms"], b["zs"])
        a = {key: x[0] for key, x in _warp_merge(a).items()}
        lse_t, lse_s = a["mt"] + torch.log(a["zt"]), a["ms"] + torch.log(a["zs"])
        got[r] = a["u"] / a["zt"] - lse_t + lse_s
    return got


def _kl_logits(seed, rows=6, vocab=300, scale=3.0):
    """The edge rows of ``test_torch_kernels_fwd._logits``: teacher ==
    student, ±3e4 logits, -1e30 on both sides, -1e30 on the teacher only."""
    rng = np.random.default_rng(seed)
    t = (scale * rng.normal(size=(rows, vocab))).astype(np.float32)
    s = (scale * rng.normal(size=(rows, vocab))).astype(np.float32)
    s[0] = t[0]
    t[1] = rng.uniform(-3e4, 3e4, size=vocab)
    s[1] = t[1] + rng.normal(size=vocab).astype(np.float32)
    t[2, ::3] = s[2, ::3] = -1e30
    t[3, 1::4] = -1e30
    return torch.as_tensor(t), torch.as_tensor(s)


def _kl_tolerance(t, s, temp, want):
    lse = lambda x: torch.logsumexp(x.double() / temp, dim=-1).float()  # noqa: E731
    return 1e-5 * want.abs() + 2e-6 * (1.0 + lse(t).abs() + lse(s).abs())


@pytest.mark.parametrize("ranks", [1, 3, 8])
@pytest.mark.parametrize("temp", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("vocab", [300, 2048 + 17, 50_257])
def test_split_row_kl_model_matches_plain(vocab, temp, ranks):
    t, s = _kl_logits(vocab + ranks, vocab=vocab)
    got = kl_model(t, s, temp, ranks)
    want = ref.distill_kl_ref(t, s, temp)
    assert bool(((got - want).abs() <= _kl_tolerance(t, s, temp, want)).all()), (got, want)
    assert float(got[0]) == 0.0  # teacher == student, whatever the split
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("ranks", [1, 3, 8])
def test_split_row_kl_model_on_rows_narrower_than_the_split(ranks):
    """A vocab smaller than C slices of one tile: some ranks hold nothing,
    and their empty states must merge as nothing."""
    t, s = _kl_logits(2, rows=4, vocab=5)
    got = kl_model(t, s, 2.0, ranks)
    want = ref.distill_kl_ref(t, s, 2.0)
    assert bool(((got - want).abs() <= _kl_tolerance(t, s, 2.0, want)).all()), (got, want)
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (0, 1), (2, 3)])
@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("vocab", [5, 37, 2048 + 17, 4 * 4096 + 3])
def test_kl_thread_walk_covers_each_element_once(vocab, ranks, offsets):
    """Every element of a row lies in exactly one thread's tiles, on every
    phase; a 16-byte tile is 4 consecutive elements on a 16-byte boundary,
    and rows on different phases are walked in scalar tiles only."""
    for r in range(4):  # rows of an odd vocab start at every phase
        pt, ps = ((o + r * vocab) % 4 for o in offsets)
        tiles = kl_thread_tiles(vocab, ranks, pt, ps)
        seen = tiles[tiles >= 0]
        assert np.array_equal(np.sort(seen), np.arange(vocab)), (r, pt, ps)
        full = tiles[(tiles >= 0).all(axis=-1)]
        granule = (full[:, 1:] - full[:, :1] == np.arange(1, 4)).all(axis=1)
        if pt != ps:
            assert not granule.any()
        else:
            assert bool(((full[granule, 0] + pt) % 4 == 0).all())
            assert granule.sum() == (vocab - min(vocab, (4 - pt) % 4)) // 4


@pytest.mark.parametrize("offsets", [(1, 1), (2, 2), (0, 1), (3, 0)])
@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_split_row_kl_model_on_rows_at_other_phases(ranks, offsets):
    """Rows starting off a 16-byte boundary: a scalar head on rank 0, and,
    when teacher and student sit on different phases (a student one float
    into its buffer, as ``chip_smoke.py`` also checks), the all-scalar walk."""
    t, s = _kl_logits(ranks + sum(offsets), vocab=2048 + 17)
    got = kl_model(t, s, 2.0, ranks, *offsets)
    want = ref.distill_kl_ref(t, s, 2.0)
    assert bool(((got - want).abs() <= _kl_tolerance(t, s, 2.0, want)).all()), (got, want)
    assert float(got[0]) == 0.0
