"""CPU models of the designs of the port's fp16 top-k and attention kernels.

A CUDA kernel cannot run here; these tests pin what each design computes
against the plain versions in ``repro_torch.kernels.ref`` (themselves held
to the JAX reference in ``test_torch_fp16.py``), as
``test_torch_bf16_designs.py`` does for bf16.

Top-k (``csrc/topk_select.cu``, ``topk_radix_16_kernel<__half>``, entry
point ``topk_mask_f16``).  The kernel is bf16's on fp16's 16-bit key: the
same map (a negative value's bits all flipped, a positive value's top bit
set) orders fp16 values too, so X_k, the k-th largest value, is found
exactly by the same two digits of 11 and 5 bits (in fp16 the high digit is
sign, 5 exponent bits and 5 mantissa bits).  min and max come from the
keys (a NaN's key lies beyond +-inf's), every fp16 value is exact in fp32
(subnormals included, which are normal there), and so is hi = max + 1 up
to 65 504.  One thread replays the 30 fp32 steps with ``take = mid <=
X_k``; the row is then kept where x >= lo rounded up to fp16 (one packed
compare in the kernel), which for an fp16 x is x >= lo, also where lo lies
above 65 504 and rounds up to +inf.  The model follows those steps in
numpy and is held bitwise to ``topk_mask_ref`` on fp16 rows: normal and
constant rows, tie groups, -0 beside +0, +-inf and NaN, subnormals of both
signs, values near +-65 504, rows of one high-digit bin, k in {0, 1, V,
V + 7} static and per row, and rows drawn by hypothesis.  A replay with
``mid < X_k`` fails it, and so does a keep test with lo rounded to nearest.

Attention (``csrc/flash_attention.cu``, ``flash_attention_16_kernel<F16>``,
entry point ``flash_attention_f16``).  The kernel runs Q K^T as one fp16
product (each fp16 x fp16 product exact in fp32, summed in fp32) and P V
with P in two fp16 pieces, ``hi = fp16(P)``, ``lo = fp16(P - hi)``, over
64-key tiles with the online softmax, the diagonal tile masked with -inf
before the max, and rounds the output to fp16 once.  fp16 keeps 11
significant bits (bf16 8) but only 5 exponent bits: a weight below 2^-24
is lost to both pieces, at most 2^-25 of max|v| a key.  The model is held
within ``S * 2^-24 * max|v|`` plus one fp16 ulp of the plain version (the
check ``chip_smoke.py`` holds the kernel to) at q, k scales 1 and 4 and on
rows whose weights spread far below 2^-24; with P in one piece, as fp16
SDPA rounds it, it misses that check; and it is causal bitwise.  As in
``test_torch_bf16_designs.py`` the model runs at head dims 64 and 128, and
also sums Q K^T k-step by k-step in the kernel's order (the tiles' layout
and descriptors are the bf16 kernel's, modelled there).  The scores' fp32
sums in the kernel's order rather than the plain version's already move
the model past the check at q, k x 12 (1.08x at D 64, 1.8-1.9x at D 128):
the check has no term for the scores' rounding, and the card checks go
only to x4.  So that order is held to the check at x1 and x4, and at x12
(D 128) to the check plus the most that scores moved as far as they moved
can move the output (``score_order_term``).
"""

import math
import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_bf16_designs import (  # noqa: E402
    D128_KEYS,
    ITERS,
    LOW_BITS,
    check_causal,
    check_late_maximum,
    kstep_scores,
    online_attention,
    select_digit,
)

from repro_torch.kernels import ref  # noqa: E402

f32 = np.float32
VOCAB = 20_000
POS_INF_KEY, NEG_INF_KEY = 0xFC00, 0x03FF  # the keys of fp16's +inf (0x7c00) and -inf (0xfc00)


# -- top-k: the radix select and the replayed bisection ------------------------


def f16_bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def keys_of(bits: np.ndarray) -> np.ndarray:
    """fp16 bits -> the 16-bit key in value order (the kernel's ``keys2``)."""
    return np.where(bits & 0x8000, bits ^ 0xFFFF, bits ^ 0x8000)


def key_value(key: int) -> np.float32:
    """The value of a key, exact in fp32 (the kernel's ``key_value<__half>``)."""
    raw = key ^ (0x8000 if key & 0x8000 else 0xFFFF)
    return f32(np.array([raw], dtype=np.uint16).view(np.float16)[0])


def round_up_f16(lo: np.float32) -> np.float16:
    """lo rounded toward +inf to fp16 (``__float2half_ru``): +inf above
    65 504, NaN for NaN."""
    with np.errstate(over="ignore", invalid="ignore"):
        h = np.float16(lo)
        if not np.isnan(lo) and f32(h) < lo:
            h = np.nextafter(h, np.float16(np.inf))
    return h


def radix_lo(bits: np.ndarray, k: int, take=operator.le) -> np.float32:
    """The bisection's final lo for one fp16 row as the kernel finds it."""
    keys = keys_of(bits)
    kmin, kmax = int(keys.min()), int(keys.max())
    if kmax > POS_INF_KEY or kmin < NEG_INF_KEY:  # a NaN: min and max are NaN, so is lo
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


def model_mask(x: torch.Tensor, budget: int, guard: bool, take=operator.le, keep_at=round_up_f16):
    """The kernel's masked row: kept where the fp16 x >= lo rounded up to
    fp16 (``keep_at``), with its own bits; the rest +0."""
    vocab = x.shape[-1]
    k = min(max(budget, 0), vocab) if guard else min(budget, vocab)
    if guard and k == 0:
        return torch.zeros_like(x)
    lo16 = keep_at(radix_lo(f16_bits(x), k, take))
    with np.errstate(invalid="ignore"):
        keep = torch.as_tensor(x.numpy() >= lo16)
    return torch.where(keep, x, torch.zeros_like(x))


def check_row(x: torch.Tensor, budgets, **model) -> None:
    for budget in budgets:
        for guard in (True, False):
            kk = min(max(budget, 0), x.shape[-1]) if guard else min(budget, x.shape[-1])
            want = ref.topk_mask_ref(x[None], torch.tensor([kk], dtype=torch.int32), guard=guard)[0]
            got = model_mask(x, budget, guard, **model)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (budget, guard)


def _f16(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=f32)).to(torch.float16)


def _special_row(kind: str, rng) -> torch.Tensor:
    x = rng.normal(size=VOCAB).astype(f32)
    sub = rng.integers(1, 1024, size=VOCAB).astype(f32) * f32(2.0**-24)  # fp16 subnormals
    if kind == "signed_zeros":  # -0 and +0 around X_k: two keys, one value
        x[: VOCAB // 4] = 0.0
        x[VOCAB // 8: VOCAB // 4] = -0.0
    elif kind == "infinities":  # every mid is NaN after the first step
        x[7], x[9] = np.inf, -np.inf
    elif kind == "plus_inf":
        x[:30] = np.inf
    elif kind == "minus_inf":
        x[:30] = -np.inf
    elif kind == "nan":
        x[11] = np.nan
    elif kind == "negative_nan":
        x[11] = -np.nan
    elif kind == "constant":
        x[:] = 2.5
    elif kind == "one_bin":  # sign, exponent and the top 5 mantissa bits shared: one high-digit bin
        x = (1.0 + rng.integers(0, 32, size=VOCAB) / 1024).astype(f32)
    elif kind == "all_negative":
        x -= 50.0
    elif kind == "subnormal":  # 2^-24 .. 2^-14, +0 beside them
        x = sub
        x[:40] = 0.0
    elif kind == "subnormal_signed":
        x = np.where(rng.uniform(size=VOCAB) < 0.5, -sub, sub)
    elif kind == "near_max":  # within 64 ulps of 65 504: lo + hi stays exact, hi = 65 505
        x = (65504.0 - 32.0 * rng.integers(0, 64, size=VOCAB)).astype(f32)
    elif kind == "near_max_signed":
        x = (65504.0 - 32.0 * rng.integers(0, 64, size=VOCAB)).astype(f32)
        x[::3] *= -1.0
    elif kind == "near_max_inf":  # +inf beside them: every mid past the first is +inf
        x = (65504.0 - 32.0 * rng.integers(0, 64, size=VOCAB)).astype(f32)
        x[:9] = np.inf
    elif kind == "overflow":  # fp32 logits past 65 504: +-inf in fp16
        x *= 4e4
    elif kind == "mid_at_xk":  # the first mid, (-2048 + 2047 + 1) / 2 = 0, is X_k at xk_budget's k
        x = rng.uniform(-2048.0, 2047.0, size=VOCAB).astype(f32)
        x[0], x[1] = -2048.0, 2047.0
        x[2:200] = 0.0
        x[200] = -(2.0**-24)  # fp16's least negative: kept only by a replay that misses the tie
    return _f16(x)


_SPECIAL = ["normal", "signed_zeros", "infinities", "plus_inf", "minus_inf", "nan", "negative_nan",
            "constant", "one_bin", "all_negative", "subnormal", "subnormal_signed", "near_max",
            "near_max_signed", "near_max_inf", "overflow", "mid_at_xk"]


def xk_budget(x: torch.Tensor) -> int:
    """The budget whose k-th value is 0 in a ``mid_at_xk`` row."""
    return int((x.float() >= 0).sum())


def test_keys_order_fp16_values():
    """The key orders every non-NaN fp16 value (subnormals and +-inf
    included), -0 just below +0, and a NaN's key lies beyond +-inf's;
    key_value inverts it."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    keys = keys_of(bits)
    assert np.array_equal(np.sort(keys), bits)  # a bijection on 16 bits
    vals = bits.astype(np.uint16).view(np.float16).astype(f32)
    finite = ~np.isnan(vals)
    order = np.argsort(keys[finite], kind="stable")
    assert np.all(np.diff(vals[finite][order]) >= 0)
    nan_keys = keys[~finite]
    assert np.all((nan_keys > POS_INF_KEY) | (nan_keys < NEG_INF_KEY))
    assert keys_of(np.array([0x7C00]))[0] == POS_INF_KEY and keys_of(np.array([0xFC00]))[0] == NEG_INF_KEY
    for key in range(0, 1 << 16, 97):
        raw = key ^ (0x8000 if key & 0x8000 else 0xFFFF)
        v = key_value(key)
        assert np.isnan(v) or np.float16(v).view(np.uint16) == raw


def test_round_up_matches_the_keep_test():
    """For every fp16 x and lo, x >= lo holds iff x >= lo rounded up to fp16:
    the kernel's packed compare keeps what the plain fp32 compare keeps."""
    xs = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    xs = xs[~np.isnan(xs)]
    rng = np.random.default_rng(0)
    los = np.concatenate([rng.normal(size=300) * 10.0 ** rng.integers(-9, 5, size=300),
                          [65504.5, 65519.9, 65520.0, 7e4, -65504.5, 2.0**-25, -(2.0**-25), 3e-9, 0.0,
                           -0.0, np.inf, -np.inf, np.nan]]).astype(f32)
    x32 = xs.astype(f32)
    for lo in los:
        with np.errstate(invalid="ignore"):
            assert np.array_equal(x32 >= lo, xs >= round_up_f16(lo)), lo


@pytest.mark.parametrize("k", ["0", "1", "V", "V+7", "inner"])
@pytest.mark.parametrize("kind", _SPECIAL)
def test_radix_select_replay_matches_plain_bitwise(kind, k):
    rng = np.random.default_rng(len(kind) * 7 + len(k))
    x = _special_row(kind, rng)
    budget = {"0": 0, "1": 1, "V": VOCAB, "V+7": VOCAB + 7,
              "inner": xk_budget(x) if kind == "mid_at_xk" else 333}[k]
    check_row(x, [budget])


def test_radix_select_replay_on_random_rows():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=25, deadline=None, derandomize=True)
    @hypothesis.given(seed=st.integers(0, 2**32 - 1), vocab=st.integers(1, 3000),
                      scale=st.sampled_from([1e-6, 1e-3, 0.55, 1.0, 30.0, 6e4]),
                      shift=st.sampled_from([0.0, -50.0, 1.0]), budget=st.integers(-3, 3100),
                      levels=st.sampled_from([0, 3, 100]))
    def rows(seed, vocab, scale, shift, budget, levels):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=vocab) * scale + shift
        if levels:  # few distinct values: large tie groups
            x = np.round(x * levels) / levels
        check_row(_f16(x), [budget, 1, vocab])

    rows()


def test_mutations_fail():
    """A replay with ``mid < X_k`` keeps fp16's least negative value where
    the first mid equals X_k; a keep test at lo rounded to nearest keeps
    65 504 where the static k = 0 takes lo to just under 65 505 (rounded up:
    +inf, nothing kept, as in the plain version)."""
    x = _special_row("mid_at_xk", np.random.default_rng(3))
    check_row(x, [xk_budget(x)])
    with pytest.raises(AssertionError):
        check_row(x, [xk_budget(x)], take=operator.lt)
    y = _special_row("near_max", np.random.default_rng(4))
    check_row(y, [0])
    assert not bool(ref.topk_mask_ref(y[None], torch.tensor([0], dtype=torch.int32), guard=False).any())
    with pytest.raises(AssertionError):
        check_row(y, [0], keep_at=np.float16)


# -- attention: Q K^T in fp16, P V with P in two fp16 pieces -------------------


def attention_model(q, k, v, pieces: int = 2) -> torch.Tensor:
    """Causal attention over (B, S, D) fp16 q, k, v as the kernel computes
    it: 64-key tiles in order with the online softmax, scores from exact
    fp16 products summed in fp32, exp as 2^(s c - m c) with c = scale *
    log2(e), P in ``pieces`` fp16 pieces, the output rounded to fp16 once."""
    return online_attention(q, k, v, pieces, torch.float16)


def f16_ulp(*xs):
    """One fp16 ulp of the larger magnitude, elementwise (as chip_smoke.py):
    2^(e - 10), and 2^-24 below 2^-14."""
    a = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(2.0**-14))) - 10),
                       torch.zeros_like(a))


def excess(got, want, seq, v, extra: float = 0.0) -> float:
    """The largest error over the check ``S * 2^-24 * max|v|`` plus one fp16
    ulp (plus ``extra``), as a multiple of it (<= 1 passes)."""
    tol = seq * 2.0**-24 * float(v.float().abs().max()) + f16_ulp(got, want) + extra
    return float(((got.float() - want.float()).abs() / tol).max())


def score_order_term(q, k, v) -> float:
    """The most that Q K^T summed in the kernel's k-step order can move the
    output from the plain version's: with every score within Delta of the
    plain one (measured here), each softmax weight moves by a factor within
    e^(+-2 Delta D^-0.5), so each output by at most (e^(2 Delta D^-0.5) - 1)
    max|v|."""
    qf, kt = q.float(), k.float().transpose(1, 2)
    delta = float((kstep_scores(qf, kt) - qf @ kt).abs().max())
    return math.expm1(2.0 * q.shape[-1] ** -0.5 * delta) * float(v.float().abs().max())


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(f32) for _ in range(3))
    return _f16(q * scale), _f16(k * scale), _f16(v)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0, 12.0])
@pytest.mark.parametrize("shape", [(2, 256, 64), (3, 96, 64), (2, 256, 128), (3, 96, 128)])
def test_two_piece_attention_model_within_the_check(shape, qk_scale):
    """At q, k scales 4 and 12 most causal weights (93 % and 75 % at S 256)
    fall below fp16's 2^-24 and are dropped, within the check.  At D 128 the
    model sums Q K^T in the kernel's k-step order; at x12 that order moves
    the scores by up to 3.4e-3 and the output past the check (1.8-1.9x), so
    there the bound adds ``score_order_term``."""
    q, k, v = _qkv(int(qk_scale) + shape[1], shape, qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    ksteps = shape[2] == 128
    extra = score_order_term(q, k, v) if ksteps and qk_scale > 4 else 0.0
    got = online_attention(q, k, v, 2, torch.float16, ksteps=ksteps)
    assert excess(got, want, shape[1], v, extra) <= 1.0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_kstep_order_within_the_check(d, qk_scale):
    """Q K^T summed k-step by k-step, the kernel's order over D, at the q,
    k scales the card checks use."""
    q, k, v = _qkv(int(qk_scale) + d, (2, 256, d), qk_scale)
    got = online_attention(q, k, v, 2, torch.float16, ksteps=True)
    assert excess(got, ref.flash_attention_ref(q, k, v), 256, v) <= 1.0


def test_one_fp16_piece_misses_the_check():
    """P rounded once to fp16 (as fp16 SDPA does) leaves errors of ~2^-12 of
    the weights: past the check, where two pieces pass."""
    q, k, v = _qkv(9, (2, 256, 64), 4.0)
    want = ref.flash_attention_ref(q, k, v)
    one, two = (excess(attention_model(q, k, v, n), want, 256, v) for n in (1, 2))
    assert one > 2.0 and two <= 1.0, (one, two)


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


# -- the D = 128 kernel (flash_attention_16_d128_kernel<F16>) ------------------


def d128_model(q, k, v, pieces: int = 2) -> torch.Tensor:
    """The D = 128 fp16 kernel's arithmetic: 128-key tiles, Q K^T in its
    k-step order (``test_torch_bf16_designs.d128_model`` in fp16)."""
    return online_attention(q, k, v, pieces, torch.float16, ksteps=True, keys_per_tile=D128_KEYS)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0, 12.0])
@pytest.mark.parametrize("shape", [(2, 256, 128), (3, 96, 128)])
def test_d128_model_within_the_check(shape, qk_scale):
    """Within the check at x1 and x4; at x12 within it plus
    ``score_order_term``, the bound the card's x12 case uses."""
    q, k, v = _qkv(int(qk_scale) + shape[1], shape, qk_scale)
    extra = score_order_term(q, k, v) if qk_scale > 4 else 0.0
    assert excess(d128_model(q, k, v), ref.flash_attention_ref(q, k, v), shape[1], v, extra) <= 1.0


def test_d128_model_is_causal_bitwise():
    check_causal(d128_model, _qkv, 128)


def test_d128_model_late_maximum():
    check_late_maximum(d128_model, _qkv, excess, 128)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_d128_one_piece_misses_the_check(qk_scale):
    """As in bf16: at D 128, on 128-key tiles, P rounded once to fp16
    misses the check of the card's x1 and x4 cases, where two pieces pass
    (at x12 one piece stays within the bound plus ``score_order_term``)."""
    q, k, v = _qkv(int(qk_scale) + 128, (2, 256, 128), qk_scale)
    want = ref.flash_attention_ref(q, k, v)
    one, two = (excess(d128_model(q, k, v, n), want, 256, v) for n in (1, 2))
    assert one > 2.0 and two <= 1.0, (one, two)
