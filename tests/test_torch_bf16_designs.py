"""CPU models of the designs of the port's two bf16 kernels.

A CUDA kernel cannot run here; these tests pin what each design computes
against the plain versions in ``repro_torch.kernels.ref`` (themselves held
to the JAX reference in ``test_torch_bf16.py``).

Top-k (``csrc/topk_select.cu``, ``topk_radix_bf16_kernel``).  A bf16 row
has only 65 536 possible values, so the kernel finds X_k, the k-th largest
value, exactly before any bisection step: a radix select on the 16-bit key
that orders bf16 values (a negative value's bits all flipped, a positive
value's top bit set), over two digits of 11 and 5 bits — the high digit's
histogram, a scan from the top to the bin holding rank k, the low digit's
histogram among that bin's values, a second scan.  min and max come from the keys (a
NaN's key lies beyond +-inf's).  One thread then replays the 30 steps of
the plain version with no count: ``count(x >= mid) >= k`` holds iff
``mid <= X_k`` for k >= 1 on a row without NaN, so ``take = mid <= X_k``
(the static k <= 0 takes every step).  The model below follows those
steps in numpy and is held bitwise to ``topk_mask_ref`` on bf16 rows: normal
and constant rows, tie groups of 40, 1040 and 7664 values at X_k, rows
mixing -0 and +0, +-inf and NaN, rows of one exponent bin, k in
{0, 1, V, V + 7} static and per row, and rows drawn by hypothesis.  A
replay with ``mid < X_k`` fails it.

Attention (``csrc/flash_attention.cu``, ``flash_attention_bf16_kernel``).
The kernel runs Q K^T as one bf16 product (each bf16 x bf16 product exact
in fp32, summed in fp32) and P V with P in two bf16 pieces, ``hi =
bf16(P)``, ``lo = bf16(P - hi)``, over 64-key tiles with the online
softmax, the diagonal tile masked with -inf before the max, and rounds the
output to bf16 once.  The model is held within ``S * 2^-24 * max|v|`` plus
one bf16 ulp of the plain version (the check ``chip_smoke.py`` holds the
kernel to) at q, k scales 1 and 4; with P in one piece, as bf16 SDPA
rounds it, it misses that check; and it is causal bitwise.  The kernel is a
template on the head dim (``flash_attention_16_kernel<E, D>``, D 64 or
128); the model runs at both, and also sums Q K^T k-step by k-step in
the kernel's order.  At D = 128 a 256-byte row is two spans of TMA's 128-byte
swizzle: each tile lies in shared memory as two column blocks, and Q K^T's
descriptors step to the second block at k-step 4; a byte-level model of
the swizzled tiles and of the descriptors' start addresses reads every
k-step's operands back (and a descriptor that does not step across
misreads them), and reads V's MN-major k-steps block by block.
"""

import itertools
import math
import operator
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

f32 = np.float32
ITERS = ref.BISECTION_ITERS
LOW_BITS = 5  # the top-k kernel's low digit (kLowBits); the high digit has 16 - 5
KEYS = 64  # the attention kernel's key tile (the D = 128 16-bit kernel's: 128)
D128_KEYS = 128
SPAN = 128  # bytes of one span of the 128-byte swizzle: 64 16-bit columns


# -- top-k: the radix select and the replayed bisection ------------------------


def bf16_bits(x: torch.Tensor) -> np.ndarray:
    """The raw 16 bits of a bf16 tensor."""
    return x.contiguous().view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def keys_of(bits: np.ndarray) -> np.ndarray:
    """bf16 bits -> the 16-bit key in value order (the kernel's ``keys2``)."""
    return np.where(bits & 0x8000, bits ^ 0xFFFF, bits ^ 0x8000)


def key_value(key: int) -> np.float32:
    """The value of a key, exact in fp32 (the kernel's ``key_value``)."""
    raw = key ^ (0x8000 if key & 0x8000 else 0xFFFF)
    return np.array([raw << 16], dtype=np.uint32).view(f32)[0]


def select_digit(hist: np.ndarray, kk: int) -> tuple[int, int]:
    """The bin d holding rank kk from the top, and the count above it:
    above < kk <= above + hist[d] (the kernel's ``select_digit``)."""
    incl = np.cumsum(hist[::-1])[::-1]  # values in bins >= d
    above = incl - hist
    hit = np.flatnonzero((above < kk) & (kk <= incl))
    assert hit.size == 1, (kk, int(incl[0]))
    return int(hit[0]), int(above[hit[0]])


def radix_lo(bits: np.ndarray, k: int, take=operator.le) -> np.float32:
    """The bisection's final lo for one bf16 row as the kernel finds it:
    min and max from the keys, X_k by its two digits, then the 30 steps
    replayed with ``take(mid, X_k)``."""
    keys = keys_of(bits)
    kmin, kmax = int(keys.min()), int(keys.max())
    if kmax > 0xFF80 or kmin < 0x007F:  # a NaN: min and max are NaN, so is lo
        return f32(np.nan)
    xk = f32(0)
    if k > 0:
        high, above = select_digit(np.bincount(keys >> LOW_BITS, minlength=1 << (16 - LOW_BITS)), k)
        in_bin = keys[keys >> LOW_BITS == high] & ((1 << LOW_BITS) - 1)
        low, _ = select_digit(np.bincount(in_bin, minlength=1 << LOW_BITS), k - above)
        xk = key_value(high << LOW_BITS | low)
    lo, hi = key_value(kmin), key_value(kmax) + f32(1)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(ITERS):
            mid = (lo + hi) * f32(0.5)
            if k <= 0 or take(mid, xk):  # a NaN mid never takes for k >= 1
                lo = mid
            else:
                hi = mid
    return lo


def model_mask(x: torch.Tensor, budget: int, guard: bool, take=operator.le) -> torch.Tensor:
    """The kernel's masked row: a per-row budget is clamped to [0, V] and
    its k = 0 zeroes the row (guard); the static k is min(k, V), with no
    guard.  Kept values keep their bits, the rest are +0."""
    vocab = x.shape[-1]
    k = min(max(budget, 0), vocab) if guard else min(budget, vocab)
    if guard and k == 0:
        return torch.zeros_like(x)
    lo = radix_lo(bf16_bits(x), k, take)
    with np.errstate(invalid="ignore"):
        keep = torch.as_tensor(x.float().numpy() >= lo)
    return torch.where(keep, x, torch.zeros_like(x))


def check_row(x: torch.Tensor, budgets, take=operator.le) -> None:
    for budget in budgets:
        for guard in (True, False):
            kk = min(max(budget, 0), x.shape[-1]) if guard else min(budget, x.shape[-1])
            want = ref.topk_mask_ref(x[None], torch.tensor([kk], dtype=torch.int32), guard=guard)[0]
            got = model_mask(x, budget, guard, take)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (budget, guard)


VOCAB = 20_000  # past the largest tie group the kernel's earlier design had to spill


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=f32)).to(torch.bfloat16)


def _tie_row(group: int, rng) -> tuple[torch.Tensor, list[int]]:
    """A bf16-rounded normal row with ``group`` more values set to one value
    near its top (which bf16 already ties with a few others), and budgets
    at the tie group's first, middle and last rank."""
    x = _bf16(rng.normal(size=VOCAB)).float().numpy()
    v0 = f32(np.sort(x)[::-1][VOCAB // 50])
    x[rng.choice(np.flatnonzero(x != v0), size=group, replace=False)] = v0
    above, tie = int((x > v0).sum()), int((x == v0).sum())
    return _bf16(x), [above + 1, above + tie // 2, above + tie]


def _special_row(kind: str, rng) -> torch.Tensor:
    x = rng.normal(size=VOCAB).astype(f32)
    if kind == "signed_zeros":  # -0 and +0 around X_k: two keys, one value
        x[: VOCAB // 4] = 0.0
        x[VOCAB // 8: VOCAB // 4] = -0.0
    elif kind == "infinities":  # every mid is NaN after the first step
        x[7], x[9] = np.inf, -np.inf
    elif kind == "plus_inf":
        x[: 30] = np.inf
    elif kind == "minus_inf":
        x[: 30] = -np.inf
    elif kind == "nan":
        x[11] = np.nan
    elif kind == "negative_nan":
        x[11] = -np.nan
    elif kind == "constant":
        x[:] = 2.5
    elif kind == "one_bin":  # one exponent: 4 high-digit bins of the kernel, one 8-bit bin
        x = (1.0 + rng.integers(0, 128, size=VOCAB) / 128).astype(f32)
    elif kind == "all_negative":
        x -= 50.0
    elif kind == "near_max":  # lo + hi overflows fp32
        x[:] = 3e38
        x[: VOCAB // 6] = 3.3e38
    elif kind == "mid_at_xk":  # the first mid, (-2 + 1 + 1) / 2 = 0, is X_k at xk_budget's k
        x = rng.uniform(-2.0, 1.0, size=VOCAB).astype(f32)
        x[0], x[1] = -2.0, 1.0
        x[2:200] = 0.0
        x[200] = -1e-30  # within 2^-27 below X_k: kept only by a replay that misses the tie
    return _bf16(x)


def xk_budget(x: torch.Tensor) -> int:
    """The budget whose k-th value is 0 in a ``mid_at_xk`` row."""
    return int((x.float() >= 0).sum())


_SPECIAL = ["normal", "signed_zeros", "infinities", "plus_inf", "minus_inf", "nan", "negative_nan",
            "constant", "one_bin", "all_negative", "near_max", "mid_at_xk"]


def test_keys_order_bf16_values():
    """The key orders every non-NaN bf16 value, -0 just below +0, and a
    NaN's key lies beyond +-inf's; key_value inverts it."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    keys = keys_of(bits)
    assert np.array_equal(np.sort(keys), bits)  # a bijection on 16 bits
    vals = torch.as_tensor(bits.astype(np.uint16).view(np.int16)).view(torch.bfloat16).float().numpy()
    finite = ~np.isnan(vals)
    order = np.argsort(keys[finite], kind="stable")
    assert np.all(np.diff(vals[finite][order]) >= 0)
    nan_keys = keys[~finite]
    assert np.all((nan_keys > 0xFF80) | (nan_keys < 0x007F))
    assert keys_of(np.array([0x7F80, 0xFF80]))[0] == 0xFF80 and keys_of(np.array([0xFF80]))[0] == 0x007F
    for key in (0, 0x7F, 0x7FFF, 0x8000, 0xBF80, 0xFF80, 0xFFFF):
        assert keys_of(np.array([int(np.array([key_value(key)]).view(np.uint32)[0]) >> 16]))[0] == key


@pytest.mark.parametrize("k", ["0", "1", "V", "V+7", "inner"])
@pytest.mark.parametrize("kind", _SPECIAL)
def test_radix_select_replay_matches_plain_bitwise(kind, k):
    rng = np.random.default_rng(len(kind) * 7 + len(k))
    x = _special_row(kind, rng)
    budget = {"0": 0, "1": 1, "V": VOCAB, "V+7": VOCAB + 7,
              "inner": xk_budget(x) if kind == "mid_at_xk" else 333}[k]
    check_row(x, [budget])


@pytest.mark.parametrize("group", [40, 1040, 7664])
def test_radix_select_replay_on_tie_groups(group):
    """Ties at X_k cost the radix select nothing: the groups of 40, 1040 and
    7664 values that the fp32 design's stages had to fall back on."""
    x, budgets = _tie_row(group, np.random.default_rng(group))
    check_row(x, budgets)
    tie = int((x.float() == x.float().sort(descending=True).values[budgets[0] - 1]).sum())
    assert tie == budgets[2] - budgets[0] + 1 >= group


def test_radix_select_replay_on_random_rows():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=25, deadline=None, derandomize=True)
    @hypothesis.given(seed=st.integers(0, 2**32 - 1), vocab=st.integers(1, 3000),
                      scale=st.sampled_from([1e-3, 0.55, 1.0, 30.0, 1e30]),
                      shift=st.sampled_from([0.0, -50.0, 1.0]), budget=st.integers(-3, 3100),
                      levels=st.sampled_from([0, 3, 100]))
    def rows(seed, vocab, scale, shift, budget, levels):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=vocab) * scale + shift
        if levels:  # few distinct values: large tie groups
            x = np.round(x * levels) / levels
        check_row(_bf16(x), [budget, 1, vocab])

    rows()


def test_replay_with_a_strict_comparison_fails():
    """The mutation ``mid < X_k`` breaks the replay where a mid equals X_k:
    the first mid of a ``mid_at_xk`` row is its k-th value, 0, and the
    mutated replay then keeps -1e-30 as well."""
    x = _special_row("mid_at_xk", np.random.default_rng(3))
    check_row(x, [xk_budget(x)])
    with pytest.raises(AssertionError):
        check_row(x, [xk_budget(x)], take=operator.lt)


# -- attention: Q K^T in bf16, P V with P in two bf16 pieces -------------------


def attention_model(q, k, v, pieces: int = 2) -> torch.Tensor:
    """Causal attention over (B, S, D) bf16 q, k, v as the kernel computes
    it: 64-key tiles in order with the online softmax, scores from exact
    bf16 products summed in fp32, exp as 2^(s c - m c) with c = scale *
    log2(e), P in ``pieces`` bf16 pieces, the output rounded to bf16 once."""
    return online_attention(q, k, v, pieces, torch.bfloat16)


def kstep_scores(qf: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """Q K^T (``kt``: K transposed) as the kernel's wgmma chain takes it:
    fp32 sums of 16-wide k-steps over D, in order (D / 16 of them: 4 at
    D = 64, 8 at D = 128)."""
    sc = torch.zeros(qf.shape[:-1] + kt.shape[-1:])
    for kk in range(qf.shape[-1] // 16):
        sc = sc + qf[..., 16 * kk:16 * kk + 16] @ kt[..., 16 * kk:16 * kk + 16, :]
    return sc


def online_attention(q, k, v, pieces: int, dtype: torch.dtype, ksteps: bool = False,
                     keys_per_tile: int = KEYS) -> torch.Tensor:
    """The 16-bit kernel's arithmetic over (B, S, D) q, k, v of ``dtype``
    (bf16 or fp16): see :func:`attention_model`.  Q K^T's fp32 sums run in
    the plain version's order, or with ``ksteps`` in the kernel's
    (:func:`kstep_scores`).  ``keys_per_tile``: the key tile (64; the D =
    128 kernel's 128)."""
    b, s, d = q.shape
    c = f32(d**-0.5) * f32(math.log2(math.e))
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(s)
    m = torch.full((b, s), -math.inf)
    lsum = torch.zeros((b, s))
    o = torch.zeros((b, s, d))
    for j in range(0, s, keys_per_tile):
        keys = torch.arange(j, min(j + keys_per_tile, s))
        sc = (kstep_scores if ksteps else torch.matmul)(qf, kf[:, keys].transpose(1, 2))
        sc = torch.where(keys[None, None, :] > rows[None, :, None], -math.inf, sc)  # diagonal tile
        live = (rows // keys_per_tile >= j // keys_per_tile)[None, :]  # tiles above the diagonal: skipped
        new_m = torch.maximum(m, sc.amax(dim=-1))
        r = torch.exp2((m - new_m) * c)
        p = torch.exp2(sc * c - (new_m * c)[..., None])
        acc = torch.zeros_like(o)
        rest = p
        for _ in range(pieces):  # the small piece enters first in the kernel; fp32 sums here
            piece = rest.to(dtype).float()
            acc = acc + piece @ vf[:, keys]
            rest = rest - piece
        o = torch.where(live[..., None], o * r[..., None] + acc, o)
        lsum = torch.where(live, lsum * r + p.sum(dim=-1), lsum)
        m = torch.where(live, new_m, m)
    return (o / lsum[..., None]).to(dtype)


def bf16_ulp(*xs):
    """One bf16 ulp of the larger magnitude, elementwise (as chip_smoke.py)."""
    a = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-38))) - 7),
                       torch.zeros_like(a))


def excess(got, want, seq, v) -> float:
    """The largest error over the check ``S * 2^-24 * max|v|`` plus one bf16
    ulp, as a multiple of it (<= 1 passes)."""
    tol = seq * 2.0**-24 * float(v.float().abs().max()) + bf16_ulp(got, want)
    return float(((got.float() - want.float()).abs() / tol).max())


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(f32) for _ in range(3))
    return _bf16(q * scale), _bf16(k * scale), _bf16(v)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
@pytest.mark.parametrize("shape", [(2, 256, 64), (3, 96, 64), (2, 256, 128), (3, 96, 128)])
def test_two_piece_attention_model_within_the_check(shape, qk_scale):
    q, k, v = _qkv(int(qk_scale) + shape[1], shape, qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    assert excess(attention_model(q, k, v), want, shape[1], v) <= 1.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_kstep_order_within_the_check(d, qk_scale):
    """Q K^T summed k-step by k-step, the kernel's order over D (across the
    two column blocks at D = 128), at the q, k scales the card checks
    use."""
    q, k, v = _qkv(int(qk_scale) + d, (2, 256, d), qk_scale)
    got = online_attention(q, k, v, 2, torch.bfloat16, ksteps=True)
    assert excess(got, ref.flash_attention_ref(q, k, v), 256, v) <= 1.0


def test_one_bf16_piece_misses_the_check():
    """P rounded once to bf16 (as bf16 SDPA does) leaves errors of ~2^-9 of
    the weights: far past the check, where two pieces (~2^-17) pass."""
    q, k, v = _qkv(9, (2, 256, 64), 4.0)
    want = ref.flash_attention_ref(q, k, v)
    one, two = (excess(attention_model(q, k, v, n), want, 256, v) for n in (1, 2))
    assert one > 4.0 and two <= 1.0, (one, two)


def check_causal(model, qkv, d):
    q, k, v = qkv(5, (2, 256, d))
    base = model(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 150:], v2[:, 150:] = 99.0, -99.0
    pert = model(q, k2, v2)
    assert torch.equal(base[:, :150], pert[:, :150]) and not torch.equal(base[:, 150:], pert[:, 150:])


def check_late_maximum(model, qkv, excess_of, d):
    q, k, v = qkv(6, (1, 256, d))
    k[:, 200] = (2.0 * q[:, 230].float()).to(q.dtype)
    got = model(q, k, v)
    assert excess_of(got, ref.flash_attention_ref(q, k, v), 256, v) <= 1.0
    assert float((got[0, 230].float() - v[0, 200].float()).abs().max()) < 0.05 * float(v.float().abs().max())


def test_attention_model_is_causal_bitwise():
    check_causal(attention_model, _qkv, 64)


def test_attention_model_late_maximum():
    """A row whose largest score arrives in a late key tile rescales its
    earlier sums: the model stays within the check and lands on that key's v."""
    check_late_maximum(attention_model, _qkv, excess, 64)


def test_attention_model_at_d128_is_causal_bitwise():
    check_causal(attention_model, _qkv, 128)


def test_attention_model_at_d128_late_maximum():
    check_late_maximum(attention_model, _qkv, excess, 128)


# -- the tiles in shared memory and the wgmma descriptors at D = 64 and 128 ----


def tma_tile(x: np.ndarray) -> np.ndarray:
    """The bytes a tile of ``x`` (rows, D) 16-bit values takes in shared
    memory as the kernel's TMA boxes write it: D / 64 column blocks of rows
    x 128 bytes, block c at c * rows * 128, each in the 128-byte swizzle
    (16-byte chunk j of row r at chunk j ^ (r % 8))."""
    rows, d = x.shape
    raw = np.ascontiguousarray(x.astype(np.uint16)).view(np.uint8).reshape(rows, d * 2)
    buf = np.zeros(rows * d * 2, np.uint8)
    for cb in range(d // 64):
        for r in range(rows):
            for j in range(8):
                at = cb * rows * SPAN + r * SPAN + 16 * (j ^ (r % 8))
                buf[at:at + 16] = raw[r, cb * SPAN + 16 * j: cb * SPAN + 16 * j + 16]
    return buf


def swizzled(addr: int) -> int:
    """The 128-byte swizzle on a shared-memory address (1024-byte aligned
    atoms): bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def k_major_operand(buf: np.ndarray, start: int, rows: int) -> np.ndarray:
    """What a K-major wgmma operand of ``rows`` x 16 (Q's or K's k-step)
    reads from a descriptor at byte ``start``: row r's two 16-byte chunks
    at start + (r / 8) * 1024 (the stride byte offset) + (r % 8) * 128."""
    out = np.zeros((rows, 16), np.uint16)
    for r in range(rows):
        for c in range(2):
            at = swizzled(start + (r // 8) * 1024 + (r % 8) * SPAN + 16 * c)
            out[r, 8 * c:8 * c + 8] = buf[at:at + 16].view(np.uint16)
    return out


def mn_major_operand(buf: np.ndarray, start: int) -> np.ndarray:
    """What V's MN-major k-step (16 keys x 64 columns) reads from a
    descriptor at ``start``: key r's 128-byte row at start + (r / 8) * 1024
    + (r % 8) * 128, swizzled."""
    out = np.zeros((16, 64), np.uint16)
    for r in range(16):
        for j in range(8):
            at = swizzled(start + (r // 8) * 1024 + (r % 8) * SPAN + 16 * j)
            out[r, 8 * j:8 * j + 8] = buf[at:at + 16].view(np.uint16)
    return out


@pytest.mark.parametrize("d", [64, 128])
def test_descriptors_step_across_the_swizzle_spans(d):
    """Q K^T's k-step kk reads columns 16 kk .. 16 kk + 15 of Q (128 rows:
    a warpgroup's 64 at wg * 64 * 128) and of K (64 rows) from the
    kernel's descriptor start ``(kk / 4) * block + 32 * (kk % 4)``, block the
    bytes of one column block; P V's k-step kk of column block cb reads V's
    keys 16 kk .. and columns 64 cb .. at ``cb * 8192 + 2048 kk``.  A start
    that steps 32 bytes a k-step without crossing to the next block
    misreads k-steps 4-7 at D = 128."""
    rng = np.random.default_rng(d)
    q = rng.integers(0, 1 << 16, (128, d))
    k, v = (rng.integers(0, 1 << 16, (64, d)) for _ in range(2))
    qb, kb, vb = tma_tile(q), tma_tile(k), tma_tile(v)
    for kk in range(d // 16):
        cols = slice(16 * kk, 16 * kk + 16)
        for wg in range(2):
            start = (kk // 4) * 128 * SPAN + wg * 64 * SPAN + 32 * (kk % 4)
            np.testing.assert_array_equal(k_major_operand(qb, start, 64), q[64 * wg:64 * wg + 64, cols])
        np.testing.assert_array_equal(k_major_operand(kb, (kk // 4) * 64 * SPAN + 32 * (kk % 4), 64),
                                      k[:, cols])
        if kk >= 4:  # the D = 64 stepping carried on past the span
            assert not np.array_equal(k_major_operand(kb, 32 * kk, 64), k[:, cols])
    for cb in range(d // 64):
        for kk in range(4):
            np.testing.assert_array_equal(mn_major_operand(vb, cb * 64 * SPAN + 2048 * kk),
                                          v[16 * kk:16 * kk + 16, 64 * cb:64 * cb + 64])


# -- the D = 128 kernel (flash_attention_16_d128_kernel<E>) --------------------
#
# 128-key tiles (Q K^T one m64n128k16 chain, each P piece one m64n128k16 over
# both column blocks of V), a persistent grid walking (head-batch, query
# tile) items longest first, and O written through the item's Q buffer for
# one TMA store.

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def d128_model(q, k, v, pieces: int = 2, dtype=torch.bfloat16) -> torch.Tensor:
    """The D = 128 kernel's arithmetic: 128-key tiles, Q K^T summed in its
    k-step order."""
    return online_attention(q, k, v, pieces, dtype, ksteps=True, keys_per_tile=D128_KEYS)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
@pytest.mark.parametrize("shape", [(2, 256, 128), (3, 96, 128), (2, 64, 128)])
def test_d128_model_within_the_check(shape, qk_scale):
    q, k, v = _qkv(int(qk_scale) + shape[1], shape, qk_scale)
    assert excess(d128_model(q, k, v), ref.flash_attention_ref(q, k, v), shape[1], v) <= 1.0


def test_d128_model_is_causal_bitwise():
    check_causal(d128_model, _qkv, 128)


def test_d128_model_late_maximum():
    """Row 230's largest score at key 200, in the 128-key tile before its own."""
    check_late_maximum(d128_model, _qkv, excess, 128)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_d128_one_piece_misses_the_check(qk_scale):
    """At D 128, on 128-key tiles, P rounded once to bf16 misses the check
    the card's x1 and x4 cases hold the kernel to, where two pieces pass.
    (At x12 the bound adds ``score_order_term``, which one piece stays
    within: that case checks the order of the sums, not the pieces.)"""
    q, k, v = _qkv(int(qk_scale) + 128, (2, 256, 128), qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    one, two = (excess(d128_model(q, k, v, n), want, 256, v) for n in (1, 2))
    assert one > 4.0 and two <= 1.0, (one, two)


def mn_major_wide_operand(buf: np.ndarray, start: int, lbo: int) -> np.ndarray:
    """What an MN-major B of 16 keys x 128 columns (m64n128k16's P V) reads
    from a descriptor at ``start`` with leading byte offset ``lbo``:
    columns 64 nb .. 64 nb + 63 as :func:`mn_major_operand` reads them from
    ``start + nb * lbo``."""
    return np.concatenate([mn_major_operand(buf, start + nb * lbo) for nb in range(2)], axis=1)


def test_d128_descriptors_read_128_key_tiles():
    """A 128-key K or V tile lies as two column blocks of 128 rows (block c
    at c * 16 384).  Q K^T's k-step kk reads all 128 keys of K as one
    K-major B from ``(kk / 4) * 16384 + 32 (kk % 4)``; P V's k-step kk reads
    keys 16 kk .. of V across both column blocks as one MN-major B from
    ``2048 kk`` with leading byte offset 16 384, the distance to block 1.
    With the offset of one span (the n64 products' unused field) it
    misreads columns 64-127."""
    rng = np.random.default_rng(128)
    k, v = (rng.integers(0, 1 << 16, (D128_KEYS, 128)) for _ in range(2))
    kb, vb = tma_tile(k), tma_tile(v)
    block = D128_KEYS * SPAN
    for kk in range(8):
        np.testing.assert_array_equal(k_major_operand(kb, (kk // 4) * block + 32 * (kk % 4), D128_KEYS),
                                      k[:, 16 * kk:16 * kk + 16])
        np.testing.assert_array_equal(mn_major_wide_operand(vb, 2048 * kk, block), v[16 * kk:16 * kk + 16])
        assert not np.array_equal(mn_major_wide_operand(vb, 2048 * kk, 16), v[16 * kk:16 * kk + 16])


def test_d128_epilogue_writes_o_as_the_tma_store_reads_it():
    """Each consumer thread writes its O fragment (rows wrow and wrow + 8,
    columns 8x + 2t and 8x + 2t + 1 as one 4-byte word) over its
    warpgroup's rows of the item's Q buffer at ``(x / 8) * 16384 + row *
    128 + ((x % 8) ^ gr) * 16 + 4t``: the buffer then holds O in the tiles'
    layout (``tma_tile``), which the TMA store reads, each warpgroup's rows
    at 64 wg * 128 of each column block; each store of a warp hits 32
    distinct banks."""
    rng = np.random.default_rng(5)
    o = rng.integers(0, 1 << 16, (128, 128)).astype(np.uint16)
    buf = np.zeros(128 * 128 * 2, np.uint8)
    for wg, warp in itertools.product(range(2), range(4)):
        banks: dict[tuple[int, int], set[int]] = {}
        for lane, x, half in itertools.product(range(32), range(16), range(2)):
            gr, t = lane >> 2, lane & 3
            row = 64 * wg + 16 * warp + gr + 8 * half
            at = (x // 8) * 128 * SPAN + row * SPAN + (((x % 8) ^ gr) << 4) + 4 * t
            buf[at:at + 4] = o[row, 8 * x + 2 * t:8 * x + 2 * t + 2].view(np.uint8)
            banks.setdefault((x, half), set()).add(at // 4 % 32)
        assert all(len(b) == 32 for b in banks.values())
    np.testing.assert_array_equal(buf, tma_tile(o))


def d128_schedule(n_bh: int, seq: int, sms: int) -> list[list[tuple[int, int]]]:
    """Each block's (head-batch, query tile) items in the order it takes
    them, as the kernel's source states the schedule: G = min(SMs, items)
    blocks; block b takes item ``r G + (r odd ? G - 1 - b : b)`` in round r
    while that is below the item count; item i is query tile n_qt - 1 - i /
    n_bh of head-batch i % n_bh."""
    n_qt = -(-seq // 128)
    items = n_bh * n_qt
    grid = min(sms, items)
    slots = [[r * grid + (grid - 1 - b if r & 1 else b) for r in range(-(-items // grid))] for b in range(grid)]
    return [[(i % n_bh, n_qt - 1 - i // n_bh) for i in mine if i < items] for mine in slots]


@pytest.mark.parametrize("n_bh,seq", [(96, 1024), (20, 128), (20, 64), (12, 96), (24, 1024), (8, 1024),
                                      (12, 256), (32, 32768)])
def test_d128_schedule_takes_each_item_once_longest_first(n_bh, seq):
    """At the card cases' shapes, on 132 SMs (an H100) and on fewer: every
    item is taken exactly once; each block takes its items longest first;
    and the blocks' key tiles differ by at most one item's."""
    src = (CSRC / "flash_attention.cu").read_text()
    assert "return r * G + ((r & 1) ? G - 1 - b : b);" in src
    # the K/V loader, the Q loader and the consumers walk the same items
    assert src.count("const int bh = i % n_bh, qt = n_qt - 1 - i / n_bh") == 3
    n_qt = -(-seq // 128)
    for sms in (132, 7, 1):
        blocks = d128_schedule(n_bh, seq, sms)
        taken = sorted(item for mine in blocks for item in mine)
        assert taken == sorted(itertools.product(range(n_bh), range(n_qt)))
        assert all(a[1] >= b[1] for mine in blocks for a, b in zip(mine, mine[1:]))
        loads = [sum(qt + 1 for _, qt in mine) for mine in blocks]
        assert max(loads) - min(loads) <= n_qt, (sms, min(loads), max(loads))
