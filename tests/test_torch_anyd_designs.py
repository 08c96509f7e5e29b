"""CPU models of the design of the port's attention kernel for head dims
other than 64 and 128.

A CUDA kernel cannot run here; these tests pin what the design of
``flash_attention_anyd_kernel<E, DP, kChunked>`` (``csrc/flash_attention.cu``)
computes and how it lays out its tiles, in torch and numpy on the CPU,
against the plain version in ``repro_torch.kernels.ref`` (itself held to the
JAX reference in ``test_torch_attention_head_dims.py``).

The design.  D is padded to DP, D rounded up to a multiple of 32 (one
instance a width up to 256); a D past 256 takes the DP = 256 instance with
``kChunked``: output columns in chunks of 256 on the grid's third axis, each
chunk's block summing the scores over all of D in pieces of 256.  A block
owns 64 query rows, 4 warps of 16; K and V come in tiles of 64 keys, or 32
where 64 would leave one block an SM; each warp takes key tiles 0 .. its
own diagonal.  fp32 runs 3xTF32 ``mma.sync`` m16n8k8 (each operand split
into ``big``, rounded to TF32, and ``small = x - big``, of which the tensor
core reads the top 19 bits; small·big, big·small, then big·big into one
accumulator, k-step by k-step, in the fp32 kernel's order at D = 64: in
each pair of k-steps a lane's four columns are one 16-byte load); bf16 and
fp16 run m16n8k16 (16-bit products exact in fp32) with P in two 16-bit
pieces, the small one first, and the output rounded once.  The scale is in
the exponent, ``2^(s c - m c)`` with ``c = D^-0.5 · log2(e)``.

The models: that arithmetic, k-step by k-step (each k-step's products
summed exactly, then added to the fp32 accumulator), within the bound
``chip_smoke.py`` holds the kernel to (``S · 2^-24 · max|v|``, plus one ulp
of a 16-bit output) at q, k x1 and x4, and for 16 bits at x12 with the
scores' order term; causal bitwise.  Padding Q and K to DP gives the
unpadded scores bitwise; the chunks of a D past 256 share their scores, so
their running max m and normaliser l, bitwise, and give the unchunked
output bitwise.  Byte models: each instance's shared memory, the load width
for each D's row alignment and the staged tile's coverage, the fragments
that the lanes' ldmatrix addresses and 16-byte loads gather (each the
layout its mma reads), every fragment load on distinct banks, and each
warp's key tiles.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
ROWS = 64  # query rows a block: 4 warps of 16
WIDEST = 256  # the widest padded head dim; past it, chunks of output columns
SMEM_MAX = 227 * 1024  # shared memory a block can take
SMEM_SM = 228 * 1024  # an SM's, each block's 1 KB reserve included
LOG2E = 1.4426950408889634
SIZE = {"f32": 4, "bf16": 2, "f16": 2}
LOW = {"bf16": torch.bfloat16, "f16": torch.float16}


# -- the instances: tiles, shared memory, loads ---------------------------------


def padded(d: int) -> tuple[int, bool]:
    """The instance a head dim takes: (DP, chunked)."""
    return (32 * math.ceil(d / 32), False) if d <= WIDEST else (WIDEST, True)


def tiles(kind: str, dp: int, chunked: bool, keys: int | None = None) -> dict:
    """``AnyTiles<E, DP, kChunked>``: keys a K/V tile (64 where two blocks
    still fit an SM, else 32; ``keys`` to price another), row strides in
    elements, shared-memory bytes and blocks an SM."""
    f32 = kind == "f32"
    sqk, sv = (dp + 16, dp + 4) if f32 else (dp + 8, dp + 8)
    per_key = (1 if chunked else 2) * (sqk + sv)
    smem_at = lambda n: (ROWS * sqk + n * per_key) * SIZE[kind]  # noqa: E731
    if keys is None:
        keys = 64 if 2 * (smem_at(64) + 1024) <= SMEM_SM else 32
    return {"keys": keys, "sqk": sqk, "sv": sv, "smem": smem_at(keys),
            "blocks": SMEM_SM // (smem_at(keys) + 1024)}


INSTANCES = [(kind, dp, False) for kind in SIZE for dp in range(32, WIDEST + 1, 32)] + [
    (kind, WIDEST, True) for kind in SIZE]


def test_tiles_mirror_the_source():
    """The model's tiles are ``AnyTiles``'s, as the source states them, and
    so is the choice of instance by D."""
    src = (CSRC / "flash_attention.cu").read_text()
    for line in ("kStrideQK = kF32 ? DP + 16 : DP + 8;", "kStrideV = kF32 ? DP + 4 : DP + 8;",
                 "kStages = kChunked ? 1 : 2;", "kPerKey = kStages * (kStrideQK + kStrideV);",
                 "kKeys = 2 * ((kQ + 64 * kPerKey) * (int)sizeof(T) + 1024) <= 228 * 1024 ? 64 : 32;",
                 "kSmemBytes = (kQ + kKeys * kPerKey) * (int)sizeof(T);", "constexpr int kAnyWidest = 256;"):
        assert line in src, line
    cases = re.findall(r"case (\d): return launch_anyd<E, (\d+), false>", src)
    assert [(int(c), int(dp)) for c, dp in cases] == [(i, 32 * i) for i in range(1, 9)]
    assert "default: return launch_anyd<E, kAnyWidest, true>" in src
    assert [padded(d) for d in (1, 32, 33, 80, 96, 200, 256, 257, 320, 4096)] == [
        (32, False), (32, False), (64, False), (96, False), (96, False), (224, False), (256, False),
        (256, True), (256, True), (256, True)]


@pytest.mark.parametrize("kind,dp,chunked", INSTANCES)
def test_instance_fits_shared_memory(kind, dp, chunked):
    """Every instance fits one block's 227 KB and two blocks an SM, except
    fp32 at DP 160 and wider (one: its Q tile alone is 45-70 KB); 32-key
    tiles only where 64 would leave one block an SM (fp32 from DP 96 on,
    16-bit from DP 192 on, unchunked)."""
    t = tiles(kind, dp, chunked)
    assert t["smem"] <= SMEM_MAX, t
    assert t["blocks"] >= (1 if kind == "f32" and dp >= 160 else 2), t
    assert (t["keys"] == 32) == (tiles(kind, dp, chunked, keys=64)["blocks"] < 2)
    assert (t["keys"] == 32) == (not chunked and dp >= (96 if kind == "f32" else 192)
                                 or chunked and kind == "f32")


def load_width(d: int, size: int) -> int:
    """The launch's choice: the widest of 16, 8, 4 and 2 bytes dividing a row's bytes."""
    row = d * size
    return next(v for v in (16, 8, 4, 2) if row % v == 0)


@pytest.mark.parametrize("size", [4, 2])
def test_load_width_follows_each_rows_alignment(size):
    """For every D to 640: the width divides a row's bytes, so every row
    start (from a 16-byte-aligned base) and every piece's start (a multiple
    of 256 columns) is aligned to it, and no wider load would be; a row
    start is 16-byte aligned only where the row's bytes are a multiple of
    16; fp32 never needs the 2-byte loads, a 16-bit row of odd D always."""
    for d in range(1, 641):
        vec = load_width(d, size)
        assert (d * size) % vec == 0 and (WIDEST * size) % vec == 0
        assert all((r * d * size) % vec == 0 for r in range(64))
        assert vec == 16 or (d * size) % (2 * vec)
        assert (d * size % 16 == 0) == all((r * d * size) % 16 == 0 for r in range(1, 9))
        assert (vec == 2) == (size == 2 and d % 2 == 1)


def staged(rows: int, stride: int, dp: int, row0: int, seq: int, d: int, col0: int, width: int,
           vec: int, size: int, threads: int = 128) -> np.ndarray:
    """``stage_any``'s tile as element ids ``1 + row * d + col`` of the
    source (0: a zero written or filled), every copy and pad store of every
    thread's loop replayed; a cell written twice fails."""
    tile = np.full((rows, stride), -1, np.int64)
    per = vec // size
    n = width // per
    for tid in range(threads):
        for i in range(tid, rows * n, threads):
            r, col = divmod(i, n)
            col *= per
            for e in range(per):
                assert tile[r, col + e] == -1
                tile[r, col + e] = 1 + (row0 + r) * d + col0 + col + e if row0 + r < seq else 0
        pad = dp - width
        for i in range(tid, rows * pad, threads):
            r, c = divmod(i, pad)
            assert tile[r, width + c] == -1
            tile[r, width + c] = 0
    return tile


@pytest.mark.parametrize("kind,d,row0,seq,col0", [("f32", 33, 0, 96, 0), ("bf16", 33, 64, 96, 0),
                                                  ("f16", 80, 32, 1024, 0), ("bf16", 321, 0, 64, 256),
                                                  ("f32", 320, 32, 48, 256), ("f16", 1, 0, 33, 0)])
def test_staged_tile_holds_each_element_once(kind, d, row0, seq, col0):
    """The staged rows hold columns col0 .. col0 + width of the source rows
    (zeros past the sequence), each once, and zeros up to DP."""
    dp, _ = padded(d)
    t = tiles(kind, dp, d > WIDEST)
    width = min(dp, d - col0)
    vec = load_width(d, SIZE[kind])
    got = staged(t["keys"], t["sqk"], dp, row0, seq, d, col0, width, vec, SIZE[kind])
    rows = np.arange(row0, row0 + t["keys"])[:, None]
    want = np.where(rows < seq, 1 + rows * d + col0 + np.arange(width)[None, :], 0)
    assert np.array_equal(got[:, :width], want)
    assert not got[:, width:dp].any() and (got[:, dp:] == -1).all()


# -- the fragments: ldmatrix and the 16-byte loads ------------------------------


def ldmatrix_x4(tile: np.ndarray, addr, trans: bool = False):
    """PTX ldmatrix .x4 over element ids: lane l gives the row (8 elements
    from ``addr(l)``) of row l % 8 of matrix l // 8; register i of lane l
    holds elements (l // 4, 2 (l % 4) + 0/1) of matrix i, transposed
    ((2 (l % 4) + 0/1, l // 4)) with .trans."""
    mats = [np.stack([tile[r, c:c + 8] for r, c in (addr(l) for l in range(8 * i, 8 * i + 8))])
            for i in range(4)]
    out = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out.append([(m[g, 2 * t], m[g, 2 * t + 1]) if not trans else (m[2 * t, g], m[2 * t + 1, g])
                    for m in mats])
    return out


def ids(rows: int, cols: int) -> np.ndarray:
    return 1000 * np.arange(rows)[:, None] + np.arange(cols)[None, :]


def test_ldmatrix_addresses_gather_the_m16n8k16_fragments():
    """The lanes' row addresses in ``qk_any`` and ``pv_any`` (lane & 7 a row,
    lane & 8 the second 8 rows or columns, lane >> 4 the other) gather Q's A
    fragment, K's B fragments of two key n-tiles and V's transposed B
    fragments of two column n-tiles, each as m16n8k16 reads it: A reg 0
    (row g, k 2t..), 1 (g + 8, 2t), 2 (g, 2t + 8), 3 (g + 8, 2t + 8); B reg 0
    (k 2t.., n g), 1 (k 2t + 8.., n g)."""
    wrow, kk, jj, np_ = 32, 3, 1, 2
    q, k, v = ids(64, 136), ids(64, 136), ids(64, 136)
    a = ldmatrix_x4(q, lambda l: (wrow + (l & 7) + (l & 8), 16 * kk + ((l >> 4) << 3)))
    b = ldmatrix_x4(k, lambda l: ((l & 7) + ((l >> 4) << 3) + 16 * jj, (l & 8) + 16 * kk))
    vb = ldmatrix_x4(v, lambda l: ((l & 7) + (l & 8) + 16 * kk, ((l >> 4) << 3) + 16 * np_), trans=True)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            assert a[lane][reg] == (q[wrow + g + dr, 16 * kk + 2 * t + dc], q[wrow + g + dr, 16 * kk + 2 * t + dc + 1])
        for half in range(2):  # key n-tiles 2 jj + half: B[k][n] = K[key n][column k]
            key = 16 * jj + 8 * half + g
            assert b[lane][2 * half] == (k[key, 16 * kk + 2 * t], k[key, 16 * kk + 2 * t + 1])
            assert b[lane][2 * half + 1] == (k[key, 16 * kk + 2 * t + 8], k[key, 16 * kk + 2 * t + 9])
            col = 16 * np_ + 8 * half + g  # column n-tiles 2 np + half: B[k][n] = V[key k][column n]
            assert vb[lane][2 * half] == (v[16 * kk + 2 * t, col], v[16 * kk + 2 * t + 1, col])
            assert vb[lane][2 * half + 1] == (v[16 * kk + 2 * t + 8, col], v[16 * kk + 2 * t + 9, col])


def test_p_pieces_take_the_accumulators_as_the_a_fragment():
    """P's A fragment of k-step kk from the score accumulators in place:
    s[j][e] holds (row g + 8 (e >> 1), key 8 j + 2t + (e & 1)), and packed
    pairs (s[2kk][0..1], s[2kk][2..3], s[2kk+1][0..1], s[2kk+1][2..3]) are A
    registers 0-3: (row g, keys 16kk + 2t..), (g + 8, ..), (g, 16kk + 8 + 2t..), (g + 8, ..)."""
    for lane in range(32):
        g, t = lane // 4, lane % 4
        s = {(j, e): (g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)) for j in range(8) for e in range(4)}
        for kk in range(4):
            x = [s[2 * kk, e] for e in range(4)] + [s[2 * kk + 1, e] for e in range(4)]
            for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                assert (x[2 * reg], x[2 * reg + 1]) == ((g + dr, 16 * kk + 2 * t + dc),
                                                        (g + dr, 16 * kk + 2 * t + dc + 1))


def test_fp32_fragments_pair_the_same_columns():
    """fp32: a lane's float4 of Q (rows g, g + 8) and of K (key 8j + g) at
    columns 16m + 4t .. + 3 give k-step 2m + h its A registers a0 (column
    t) and a2 (t + 4) and its B registers b0 (k t) and b1 (k t + 4) from the
    float4's values 2h and 2h + 1: at every k index of the m16n8k8 product
    A's column and B's column are one column of D, and the two k-steps take
    the 16 columns 16m .. 16m + 15 once.  P V: A columns t and t + 4 are the
    accumulators of keys 2t and 2t + 1 (s[j][0] / s[j][1]), and the B
    fragment reads V rows 8j + 2t (k t) and 8j + 2t + 1 (k t + 4)."""
    m = 2
    taken = []
    for h in range(2):
        col_a, col_b = {}, {}
        for lane in range(32):
            t = lane % 4
            x = [16 * m + 4 * t + i for i in range(4)]  # the float4's columns
            for kc, col in ((t, x[2 * h]), (t + 4, x[2 * h + 1])):
                assert col_a.setdefault(kc, col) == col and col_b.setdefault(kc, col) == col
        assert col_a == col_b and sorted(col_a) == list(range(8))
        taken += col_a.values()
    assert sorted(taken) == list(range(16 * m, 16 * m + 16))
    for lane in range(32):
        t = lane % 4
        key_a = {t: 8 * 3 + 2 * t, t + 4: 8 * 3 + 2 * t + 1}  # s[3][0], s[3][1]: keys 8j + 2t (+ 1)
        row_b = {t: 8 * 3 + 2 * t, t + 4: 8 * 3 + 2 * t + 1}  # vr[8nd], vr[kStride + 8nd]
        assert key_a == row_b


def banks(byte_addrs) -> list[int]:
    return [(a // 4) % 32 for a in byte_addrs]


@pytest.mark.parametrize("kind,dp,chunked", INSTANCES)
def test_fragment_loads_hit_distinct_banks(kind, dp, chunked):
    """Every fragment load of a warp is conflict-free: 16-bit ldmatrix
    (each matrix's eight 16-byte rows on distinct 16-byte slots of 128
    bytes), fp32 16-byte loads of Q and K (each quarter-warp's eight on
    distinct slots), fp32 4-byte loads of V (32 distinct banks)."""
    t = tiles(kind, dp, chunked)
    size = SIZE[kind]
    if kind != "f32":
        for stride in (t["sqk"], t["sv"]):
            for col in (0, 8, 16 * 3):
                slots = {((r * stride + col) * size // 16) % 8 for r in range(8)}
                assert len(slots) == 8, (stride, col)
        return
    for m in range(dp // 16):
        for rows in (lambda g: g, lambda g: g + 8, lambda g: 8 * 3 + g):  # Q rows g, g + 8; K key 8j + g
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                slots = {((rows(l // 4) * t["sqk"] + 16 * m + 4 * (l % 4)) * 4 // 16) % 8 for l in lanes}
                assert len(slots) == 8
    for j in range(t["keys"] // 8):
        for nd in range(dp // 8):
            for dr in (0, 1):
                addrs = [((8 * j + 2 * (l % 4) + dr) * t["sv"] + 8 * nd + l // 4) * 4 for l in range(32)]
                assert len(set(banks(addrs))) == 32


@pytest.mark.parametrize("seq", [1, 16, 33, 64, 96, 127, 128, 256, 1024])
@pytest.mark.parametrize("keys", [32, 64])
def test_each_warp_takes_its_key_tiles(seq, keys):
    """A block loads key tiles 0 .. min(its last row's, the sequence's
    last); each warp with a row in the sequence takes tiles 0 .. its
    diagonal, all loaded, which cover every key up to each of its rows;
    the diagonal tile's first key is at or before every row of the warp
    (so each row's running max is finite), and a tile before it lies wholly
    before the warp's rows (no mask)."""
    n_qt = -(-seq // ROWS)
    for by in range(n_qt):
        q0 = (n_qt - 1 - by) * ROWS
        n_kt = min((q0 + ROWS - 1) // keys + 1, -(-seq // keys))
        for w in range(4):
            first = q0 + 16 * w
            if first >= seq:
                continue
            last = first // keys
            assert last < n_kt
            assert keys * last <= first and (last + 1) * keys > min(first + 15, seq - 1)
            assert all(keys * (j + 1) - 1 < first for j in range(last))


# -- the arithmetic -----------------------------------------------------------


def truncated(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of an fp32 operand, as the tensor core reads it."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """``split``'s big: x rounded to TF32 on the bits (ties away from zero)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def fp32_order(d: int) -> torch.Tensor:
    """The fp32 kernel's columns k-step by k-step (8 a k-step): in each pair
    of k-steps from 16m, k-step 2m + h takes 16m + 4t + 2h and + 1, t = 0..3."""
    return torch.tensor([16 * m + 4 * t + 2 * h + u for m in range(d // 16) for h in range(2)
                         for t in range(4) for u in range(2)])


def kstep_sum(acc: torch.Tensor, parts) -> torch.Tensor:
    """``acc`` (fp32) plus each part in turn, a part being one mma's k-step
    products (float64, summed exactly, last axis), rounded into fp32 once."""
    for part in parts:
        acc = (acc.double() + part.sum(dim=-1)).float()
    return acc


def scores(kind: str, q: torch.Tensor, k: torch.Tensor, acc: torch.Tensor | None = None) -> torch.Tensor:
    """Q K^T of (B, S, W) q and (B, T, W) k (W a multiple of 16, zeros past
    D), as the kernel's products sum it into ``acc`` (zeros unless given)."""
    b, s, w = q.shape
    acc = torch.zeros((b, s, k.shape[1])) if acc is None else acc
    qd, kd = q.double()[:, :, None, :], k.double()[:, None, :, :]
    if kind != "f32":  # 16-bit: each 16-wide k-step's exact products, in order
        return kstep_sum(acc, (qd[..., c:c + 16] * kd[..., c:c + 16] for c in range(0, w, 16)))
    order = fp32_order(w)
    qb, kb = rounded(q), rounded(k)
    qs, ks = truncated(q - qb).double()[:, :, None, :], truncated(k - kb).double()[:, None, :, :]
    qb, kb = qb.double()[:, :, None, :], kb.double()[:, None, :, :]
    parts = []
    for c in range(0, w, 8):  # small·big, big·small, big·big: the three mma of a k-step
        idx = order[c:c + 8]
        parts += [qs[..., idx] * kb[..., idx], qb[..., idx] * ks[..., idx], qb[..., idx] * kb[..., idx]]
    return kstep_sum(acc, parts)


def pv(kind: str, p: torch.Tensor, v: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc += P V over one key tile as the kernel's products sum it: fp32,
    per 8 keys small·big, big·small, big·big; 16-bit, per 16 keys P's small
    piece then its large one."""
    keys = p.shape[-1]
    vd = v.double()[:, None, :, :]
    if kind != "f32":
        hi = p.to(LOW[kind]).float()
        lo = (p - hi).to(LOW[kind]).float()
        parts = []
        for c in range(0, keys, 16):
            for piece in (lo, hi):
                parts.append((piece.double()[..., c:c + 16, None] * vd[..., c:c + 16, :]).transpose(-1, -2))
        return kstep_sum(acc, parts)
    pb, vb = rounded(p), rounded(v)
    ps, vs = truncated(p - pb).double(), truncated(v - vb).double()[:, None, :, :]
    pb, vb = pb.double(), vb.double()[:, None, :, :]
    parts = []
    for c in range(0, keys, 8):
        for a, bb in ((ps, vb), (pb, vs), (pb, vb)):
            parts.append((a[..., c:c + 8, None] * bb[..., c:c + 8, :]).transpose(-1, -2))
    return kstep_sum(acc, parts)


def anyd_model(kind: str, q, k, v, chunk: int | None = None, stats: list | None = None):
    """The kernel's output over (B, S, D) q, k, v (fp32, or 16-bit of
    ``kind``): Q and K zero-padded to D rounded up to 16 (a chunked block's
    pieces of 256 summed in turn into one accumulator), each warp's 16 rows
    over key tiles 0 .. its diagonal, the online softmax with the scale in
    the exponent, O over the output columns of chunk ``chunk`` (all unless
    given); ``stats`` collects (m, l)."""
    b, seq, d = q.shape
    dp, chunked = padded(d)
    t = tiles(kind, dp, chunked)
    keys = t["keys"]
    c = np.float32(np.float32(d**-0.5) * np.float32(LOG2E))
    w16 = 16 * math.ceil(d / 16)
    qf, kf = (torch.nn.functional.pad(x.float(), (0, w16 - d)) for x in (q, k))
    cols = slice(None) if chunk is None else slice(WIDEST * chunk, min(d, WIDEST * (chunk + 1)))
    vf = v.float()[..., cols]
    rows = torch.arange(seq)
    last = (16 * (rows // 16)) // keys  # each row's warp's diagonal tile
    m = torch.full((b, seq), -math.inf)
    l = torch.zeros((b, seq))
    o = torch.zeros((b, seq, vf.shape[-1]))
    for j in range(math.ceil(seq / keys)):
        ks = slice(keys * j, min(seq, keys * (j + 1)))
        sc = torch.zeros((b, seq, ks.stop - ks.start))
        for p0 in range(0, w16, WIDEST):  # the pieces of D (one when unchunked)
            sc = scores(kind, qf[..., p0:p0 + WIDEST], kf[:, ks, p0:p0 + WIDEST], sc)
        sc = torch.where(torch.arange(ks.start, ks.stop)[None, None, :] > rows[None, :, None], -math.inf, sc)
        live = (j <= last)[None, :]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        r = torch.exp2(((m - m_new) * c).double()).float()
        p = torch.exp2((sc.double() * float(c) - (m_new * c)[..., None].double()).float().double()).float()
        acc = pv(kind, p, vf[:, ks], o * r[..., None])
        o = torch.where(live[..., None], acc, o)
        l = torch.where(live, l * r + p.sum(dim=-1), l)
        m = torch.where(live, m_new, m)
    if stats is not None:
        stats.append((m, l))
    out = o * (1.0 / l)[..., None]
    return out if kind == "f32" else out.to(LOW[kind])


def qkv(seed: int, shape, kind: str, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    x = [torch.as_tensor(rng.normal(size=shape).astype(np.float32)) for _ in range(3)]
    x[0], x[1] = x[0] * scale, x[1] * scale
    return tuple(t if kind == "f32" else t.to(LOW[kind]) for t in x)


def ulp(kind: str, *xs) -> torch.Tensor:
    bits = 8 if kind == "bf16" else 11
    a = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(2.0**-14))) - (bits - 1)),
                       torch.zeros_like(a))


def excess(kind: str, got, want, seq: int, v, extra: float = 0.0) -> float:
    """The largest error over the card's check (``S · 2^-24 · max|v|``, plus
    ``extra`` and one ulp of a 16-bit output), as a multiple of it."""
    tol = seq * 2.0**-24 * float(v.float().abs().max()) + extra
    tol = tol + (ulp(kind, got, want) if kind != "f32" else 0.0)
    return float(((got.float() - want.float()).abs() / tol).max())


def score_order_term(q, k, v) -> float:
    """``chip_smoke.score_order_term``: the most that Q K^T summed 16
    columns a k-step can move the output from the plain version's."""
    qf, kt = q.float(), k.float().transpose(1, 2)
    kstep = torch.zeros(qf.shape[:-1] + kt.shape[-1:])
    for c in range(0, qf.shape[-1], 16):
        kstep = kstep + qf[..., c:c + 16] @ kt[..., c:c + 16, :]
    delta = float((kstep - qf @ kt).abs().max())
    return math.expm1(2.0 * q.shape[-1] ** -0.5 * delta) * float(v.float().abs().max())


@pytest.mark.parametrize("kind", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [33, 80, 200, 320])
def test_padding_gives_the_unpadded_scores_bitwise(kind, d):
    """Q and K zero-padded to DP (the kernel's tiles) give the scores of
    the unpadded columns, summed k-step by k-step, bitwise: a padded
    column's products are exact zeros."""
    q, k, _ = qkv(d, (1, 64, d), kind)
    dp, chunked = padded(d)
    dp = WIDEST * math.ceil(d / WIDEST) if chunked else dp  # a chunked block's pieces
    pq, pk = (torch.nn.functional.pad(x.float(), (0, dp - d)) for x in (q, k))
    w16 = 16 * math.ceil(d / 16)
    tight = torch.zeros((1, 64, 64))
    for p0 in range(0, w16, WIDEST):
        tight = scores(kind, torch.nn.functional.pad(q.float(), (0, w16 - d))[..., p0:p0 + WIDEST],
                       torch.nn.functional.pad(k.float(), (0, w16 - d))[..., p0:p0 + WIDEST], tight)
    full = torch.zeros((1, 64, 64))
    for p0 in range(0, dp, WIDEST):
        full = scores(kind, pq[..., p0:p0 + WIDEST], pk[..., p0:p0 + WIDEST], full)
    assert torch.equal(tight, full)
    exact = q.double() @ k.double().transpose(1, 2)
    assert float((tight.double() - exact).abs().max()) < 1e-4 * float(exact.abs().max())


@pytest.mark.parametrize("kind", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape,qk_scale", [
    *(((1 + (d < 64), 256, d), x) for d in (33, 80, 200, 320) for x in (1.0, 4.0)),
    ((2, 96, 96), 1.0), ((2, 64, 1), 1.0)])
def test_model_within_the_check(kind, shape, qk_scale):
    """The card's kinds of case: the kernel's arithmetic within
    ``S · 2^-24 · max|v|`` (plus one ulp in 16 bits) at q, k x1, and x4
    from S 256 on (3xTF32's score error does not shrink with S; the card's
    x4 case runs at S 1 024)."""
    q, k, v = qkv(sum(shape) + int(qk_scale), shape, kind, qk_scale)
    got = anyd_model(kind, q, k, v)
    assert excess(kind, got, ref.flash_attention_ref(q, k, v), shape[1], v) <= 1.0


@pytest.mark.parametrize("kind", ["bf16", "f16"])
@pytest.mark.parametrize("d", [80, 256])
def test_16bit_model_at_x12_within_the_check_and_the_order_term(kind, d):
    """At q, k x12 the scores' fp32 sums in k-step order move the output
    past the plain version's rounding, which the check has no term for:
    within the check plus ``score_order_term``."""
    q, k, v = qkv(d + 12, (1, 256, d), kind, 12.0)
    got = anyd_model(kind, q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    assert excess(kind, got, want, 256, v, score_order_term(q, k, v)) <= 1.0


def test_one_tf32_product_misses_the_check():
    """One TF32 product a product (the splits' small parts dropped) misses
    the check by far at x4, where 3xTF32 holds it."""
    q, k, v = qkv(7, (1, 256, 80), "f32", 4.0)
    want = ref.flash_attention_ref(q, k, v)
    one = torch.softmax(torch.where(torch.ones(256, 256, dtype=torch.bool).tril(),
                                    (truncated(q) @ truncated(k).transpose(1, 2)) * 80**-0.5, -1e30), -1)
    assert excess("f32", one @ v, want, 256, v) > 10.0
    assert excess("f32", anyd_model("f32", q, k, v), want, 256, v) <= 1.0


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("d", [80, 320])
def test_model_is_causal_bitwise(kind, d):
    q, k, v = qkv(5, (1, 128, d), kind)
    base = anyd_model(kind, q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 70:], v2[:, 70:] = 99.0, -99.0
    pert = anyd_model(kind, q, k2, v2)
    assert torch.equal(base[:, :70], pert[:, :70]) and not torch.equal(base[:, 70:], pert[:, 70:])


@pytest.mark.parametrize("kind", ["f32", "f16"])
@pytest.mark.parametrize("d", [300, 520])
def test_chunks_share_m_and_l_bitwise(kind, d):
    """A D past 256 in chunks of 256 output columns: every chunk's block
    sums the same scores in the same order, so its running max and
    normaliser are every other chunk's, bitwise, and the chunks' columns
    together are the unchunked output, bitwise."""
    q, k, v = qkv(d, (1, 128, d), kind)
    stats = []
    parts = [anyd_model(kind, q, k, v, chunk=c, stats=stats) for c in range(math.ceil(d / WIDEST))]
    for m, l in stats[1:]:
        assert torch.equal(m, stats[0][0]) and torch.equal(l, stats[0][1])
    whole = anyd_model(kind, q, k, v)
    assert torch.equal(torch.cat(parts, dim=-1), whole)
    assert excess(kind, whole, ref.flash_attention_ref(q, k, v), 128, v) <= 1.0
