"""The split-TF32 arithmetic of the Hopper flash kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``) on the CPU, and the
kernel itself on the card.

On the CPU: a bit-level emulation of ``cvt.rna.tf32.f32`` and of the
three-product dot (lo*hi + hi*lo + hi*hi), with its error bound; a
lane-by-lane emulation of the m16n8k8 TF32 fragment layouts the kernel
loads by hand (QK^T in the permuted k order from q's lane-private
fragments and K's swizzled rows, P x V from the score accumulator), with
the bank-conflict claims of its shared-memory layout; and the kernel's
algorithm (64-row blocks, kv tiles of its own width, split dots, the
reference's float steps) held against the plain version and against the
reference's Pallas kernel in interpret mode.  The gpu-marked tests hold
the CUDA kernel against the plain version on the card."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_single as jflash
from repro_torch.kernels import flash_attention as FA
from _torch_threads import one_thread  # noqa: F401

# f32 on both sides, as in test_torch_flash_attention.py: exp, the order of
# the sums and the split dots' rounding differ by a few ulps.
TOL = 2e-5
NEG_INF = -1e30


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite f32, bit for bit: the 13 low mantissa
    bits rounded away, to nearest with ties away from zero (2^12 added to
    the magnitude's bits, then cleared), as an f32 whose 13 low bits are
    zero.  The kernel computes hi this way."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """An f32 operand as the TF32 MMA reads it: its 19 high bits."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernel's split of an f32 operand into the two values its MMAs
    read: hi = tf32_rna(x), and lo = x - hi (exact in f32) as the MMA reads
    it, truncated to TF32."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x.float() - hi)


def split_dot_parts(a: torch.Tensor, b: torch.Tensor):
    """The three products of a split dot over the last axis, each exact in
    float64 (11-bit significands): lo*hi, hi*lo, hi*hi elementwise."""
    ah, al = (x.double() for x in split(a))
    bh, bl = (x.double() for x in split(b))
    return al * bh, ah * bl, ah * bh


def split_matmul(a: torch.Tensor, b: torch.Tensor, c=None) -> torch.Tensor:
    """c + a @ b the kernel's way: both operands split, the three products
    summed (in float64 here) and added to the f32 accumulator c, rounded to
    f32 once."""
    ah, al = (x.double() for x in split(a))
    bh, bl = (x.double() for x in split(b))
    s = al @ bh + ah @ bl + ah @ bh
    if c is not None:
        s = s + c.double()
    return s.float()


# --- cvt.rna.tf32.f32 and the split dot -------------------------------------

def test_tf32_rna_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits (13 low bits zero), lies within half a TF32
    ulp (2^-11 |x|) of x, equals the nearest such value (ties away from
    zero) for either sign, and hi + lo (lo as the MMA reads it) recovers x
    within 2^-21 |x|."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-8, 9,
                                                                  4000),
                        [1.0, -1.0, 3.0, 65504.0, 1e-30, -2.5e-20]])
    x = torch.as_tensor(x.astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((xd - hd - ld).abs() <= 2.0 ** -21 * xd.abs()).all())
    # nearest with ties away from zero, against float64 arithmetic
    e = torch.floor(torch.log2(xd.abs()))
    q = xd.abs() * 2.0 ** (10 - e)
    want = torch.sign(xd) * torch.floor(q + 0.5) * 2.0 ** (e - 10)
    assert torch.equal(hd, want)
    # exact ties: 1 + 2^-11 (half way between 1 and 1 + 2^-10) goes up
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11],
                       dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                      1 + 2 * 2 ** -10]


def test_split_carries_nan_and_inf():
    """Non-finite operands do not vanish in the split: the three products of
    a NaN or an infinity with a finite value are not finite (the NaN the
    card makes, 0x7fffffff, rounds hi to -0 and lo keeps it; an infinity
    gives lo = inf - inf), so the kernel's output is not finite where the
    plain version's is not."""
    bits = torch.tensor([0x7FFFFFFF, 0x7FC00000, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    hi, lo = split(bits.view(torch.float32))
    bh, bl = split(torch.tensor(1.5))
    prod = lo * bh + hi * bl + hi * bh
    assert not bool(prod.isfinite().any())


@pytest.mark.parametrize("d", [16, 64, 128, 160])
@pytest.mark.parametrize("scale", [1.0, 8.0, 64.0])
def test_split_dot_error_bound(d, scale):
    """The three-product dot against a float64 dot: with the products summed
    exactly, within 1.25 (1 + 2^-10) 2^-20 sum|a||b| (the dropped lo*lo,
    2^-22, and lo truncated to TF32 on both sides, 2^-21 each, relative to
    |a b|); summed into f32 the kernel's way (each 16-wide d pair's six
    MMAs, 8 products each, into a fresh f32 accumulator that is then added
    to the score), within a further 7d/256 2^-20 sum|a||b| (one f32
    rounding, 2^-24 relative, for each of the 7d/16 additions).  Inputs
    reach |x| = 64."""
    rng = np.random.default_rng(d)
    a = torch.as_tensor(rng.uniform(-scale, scale, (512, d))
                        .astype(np.float32))
    b = torch.as_tensor(rng.uniform(-scale, scale, (512, d))
                        .astype(np.float32))
    a[0] = scale                      # the extremes
    b[0] = -scale
    exact = (a.double() * b.double()).sum(-1)
    mag = (a.double() * b.double()).abs().sum(-1)
    lh, hl, hh = split_dot_parts(a, b)
    err = ((lh + hl + hh).sum(-1) - exact).abs()
    assert bool((err <= 1.25 * (1 + 2 ** -10) * 2.0 ** -20 * mag).all())
    s = torch.zeros(a.shape[0], dtype=torch.float32)
    for p0 in range(0, d, 16):
        t = torch.zeros(a.shape[0], dtype=torch.float32)
        for k0 in (p0, p0 + 8):
            for part in (lh, hl, hh):
                t = (t.double() + part[:, k0:k0 + 8].sum(-1)).float()
        s = s + t
    err = (s.double() - exact).abs()
    bound = (1.25 * (1 + 2 ** -10) + 7 * d / 256) * 2.0 ** -20 * mag
    assert bool((err <= bound).all())
    # one TF32 product alone is 2^9 times worse: why the split is needed
    one = (tf32_rna(a).double() * tf32_rna(b).double()).sum(-1)
    assert float(((one - exact).abs() / mag).max()) > 2.0 ** -17


# --- the fragment layouts the kernel loads by hand --------------------------

def _mma_tf32(a_regs, b_regs):
    """mma.sync.m16n8k8 with TF32 operands, from per-lane registers in the
    PTX ISA's fragment layout: A (16 x 8, row) a[lane][4] at rows g, g + 8,
    g, g + 8 and columns t, t, t + 4, t + 4; B (8 x 8, col) b[lane][2] at
    rows t, t + 4 and column g; C (16 x 8) c[lane][4] at rows g, g, g + 8,
    g + 8 and columns 2t, 2t + 1, 2t, 2t + 1 (g = lane / 4, t = lane % 4).
    Sums in float64."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            A[g + 8 * (i & 1), t + 4 * (i >> 1)] = a_regs[lane][i]
        for i in range(2):
            B[t + 4 * i, g] = b_regs[lane][i]
    C = A @ B
    return np.array([[C[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)]
                      for i in range(4)] for lane in range(32)])


def _k_ring_row(krow, r, Dp):
    """Row r of a K tile as the kernel stores it: 16-byte chunks (4 words),
    chunk c at c ^ 4 on odd rows when a row has a multiple of 8 chunks, and
    the columns past D zero."""
    swz = 4 if (Dp // 16) % 2 == 0 else 0
    out = np.zeros(Dp)
    for d in range(Dp):
        phys = (((d >> 2) ^ (swz if r & 1 else 0)) << 2) | (d & 3)
        out[phys] = krow[d] if d < len(krow) else 0.0
    return out


@pytest.mark.parametrize("d", [16, 18, 40, 64, 128, 160])
def test_qk_fragments_give_the_dot(d):
    """QK^T emulated lane by lane: lane (g, t) stores q's A operand of
    k-step 2p + s (s = 0, 1) as a_i = q[g + 8 (i & 1)][16p + 4t + 2s +
    (i >> 1)], and takes the B words of both k-steps from one 16-byte load
    of K's stored row g at chunk (4p + t) ^ swizzle (words 2s, 2s + 1);
    the MMAs over all k-steps give q K^T exactly for 16 rows x 8 keys
    (integer values, so float64 sums are exact)."""
    rng = np.random.default_rng(d)
    Dp = (d + 15) // 16 * 16
    q = rng.integers(-64, 64, (16, d)).astype(np.float64)
    k = rng.integers(-64, 64, (8, d)).astype(np.float64)
    qp = np.zeros((16, Dp))
    qp[:, :d] = q
    ring = np.stack([_k_ring_row(k[r], r, Dp) for r in range(8)])
    swz = 4 if (Dp // 16) % 2 == 0 else 0
    c = np.zeros((32, 4))
    for p in range(Dp // 16):
        a2p, a2p1, b2p, b2p1 = [], [], [], []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for s, a in ((0, a2p), (1, a2p1)):
                a.append([qp[g + 8 * (i & 1), 16 * p + 4 * t + 2 * s
                             + (i >> 1)] for i in range(4)])
            chunk = (4 * p + t) ^ (swz if g & 1 else 0)
            b = ring[g, 4 * chunk:4 * chunk + 4]
            b2p.append([b[0], b[1]])
            b2p1.append([b[2], b[3]])
        c += _mma_tf32(a2p, b2p) + _mma_tf32(a2p1, b2p1)
    want = q @ k.T
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            assert c[lane, i] == want[g + 8 * (i >> 1), 2 * t + (i & 1)]


@pytest.mark.parametrize("dv", [16, 64, 160])
def test_pv_fragments_take_the_score_accumulator(dv):
    """P x V emulated lane by lane: the score accumulator of n-tile j
    (rows g, g + 8, keys 8j + 2t, 8j + 2t + 1) is P's A fragment of k-step j
    reordered (c0, c2, c1, c3: k = t is key 2t, k = t + 4 key 2t + 1), and B
    is V[8j + 2t][8c + g], V[8j + 2t + 1][8c + g] from rows padded to
    dv + 4 words; the MMAs give P V exactly over 64 keys."""
    rng = np.random.default_rng(dv)
    keys = 64
    p = rng.integers(0, 32, (16, keys)).astype(np.float64)
    v = rng.integers(-16, 16, (keys, dv)).astype(np.float64)
    vs = np.zeros((keys, dv + 4))
    vs[:, :dv] = v
    flat = vs.reshape(-1)
    acc = np.zeros((dv // 8, 32, 4))
    for j in range(keys // 8):
        a = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            s = [p[g, 8 * j + 2 * t], p[g, 8 * j + 2 * t + 1],
                 p[g + 8, 8 * j + 2 * t], p[g + 8, 8 * j + 2 * t + 1]]
            a.append([s[0], s[2], s[1], s[3]])
        for cc in range(dv // 8):
            b = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                v0 = (8 * j + 2 * t) * (dv + 4) + g + 8 * cc
                b.append([flat[v0], flat[v0 + dv + 4]])
            acc[cc] += _mma_tf32(a, b)
    want = p @ v
    for cc in range(dv // 8):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for i in range(4):
                assert acc[cc, lane, i] == \
                    want[g + 8 * (i >> 1), 8 * cc + 2 * t + (i & 1)]


def _wavefronts(word_addrs, width):
    """Shared-memory wavefronts of one warp-wide load of `width` words a
    lane: the lanes go in phases of 32 / width, and each phase takes as many
    wavefronts as its most loaded bank has distinct words."""
    per = 32 // width
    total = 0
    for ph in range(0, 32, per):
        banks = {}
        for lane in range(ph, ph + per):
            for w in range(width):
                a = word_addrs[lane] + w
                banks.setdefault(a % 32, set()).add(a)
        total += max(len(s) for s in banks.values())
    return total


@pytest.mark.parametrize("Dp", [16, 32, 48, 64, 80, 96, 112, 128, 144, 160])
def test_fragment_loads_do_not_conflict_on_banks(Dp):
    """Every warp-wide fragment load of the kernel takes the fewest
    wavefronts: K's 16-byte loads (rows 8j + g, chunk (4p + t) ^ swizzle)
    four, V's word loads (rows 8j + 2t and + 1, padded to dv + 4, column
    8c + g) one, and q's lane-private float4s four."""
    swz = 4 if (Dp // 16) % 2 == 0 else 0
    for p in range(Dp // 16):
        for j in range(2):
            addrs = [(8 * j + (lane >> 2)) * Dp
                     + 4 * ((4 * p + (lane & 3)) ^ (swz if (lane >> 2) & 1
                                                    else 0))
                     for lane in range(32)]
            assert _wavefronts(addrs, 4) == 4
    for dv in (16, 32, 64, 128, 160):
        for j, cc, half in ((0, 0, 0), (3, 1, 1)):
            addrs = [(8 * j + 2 * (lane & 3) + half) * (dv + 4)
                     + 8 * cc + (lane >> 2) for lane in range(32)]
            assert _wavefronts(addrs, 1) == 1
    assert _wavefronts([4 * lane for lane in range(32)], 4) == 4


# --- the kernel's algorithm -------------------------------------------------

def emulate_kernel(q, k, v, causal, block_q, block_k, sm_scale=None):
    """The CUDA kernel's algorithm for one slice q [Sq, D], k [Sk, D],
    v [Sk, Dv], in torch on the CPU: blocks of 64 q rows, kv tiles of 64
    keys (32 for value widths over 64) up to the block's last visible key,
    keys past Sk at -inf, split dots, the reference's float steps and
    order, and rows that see no key set to the mean of V over the last kv
    tile of the reference's tiling that their q tile reaches.  The MMAs'
    own f32 roundings are not emulated (each split product is summed in
    float64 and rounded once)."""
    Sq, D = q.shape
    Sk, Dv = v.shape
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    KT = 64 if Dv <= 64 else 32
    off = Sk - Sq if causal else 0
    q, k, v = q.float(), k.float(), v.float()
    out = torch.empty(Sq, Dv)
    for q0 in range(0, Sq, 64):
        rows = torch.arange(q0, min(q0 + 64, Sq))
        last = Sk - 1
        if causal:
            last = min(last, int(rows[-1]) + off)
        m = torch.full((len(rows),), NEG_INF)
        l = torch.zeros(len(rows))
        acc = torch.zeros(len(rows), Dv)
        for k0 in range(0, last + 1, KT):
            cols = torch.arange(k0, k0 + KT)
            src = cols.clamp(max=Sk - 1)
            s = split_matmul(q[rows], k[src].T) * torch.tensor(
                sm_scale, dtype=torch.float32)
            if causal:
                s = torch.where(cols[None] > rows[:, None] + off,
                                torch.tensor(NEG_INF), s)
            s = torch.where(cols[None] >= Sk, torch.tensor(-math.inf), s)
            m_new = torch.maximum(m, s.max(1).values)
            p = torch.exp(s - m_new[:, None])
            corr = torch.where(m == NEG_INF, torch.tensor(0.0),
                               torch.exp(m - m_new))
            l = l * corr + p.sum(1)
            acc = split_matmul(p, v[src], acc * corr[:, None])
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)[:, None]
        if causal:
            for i, r in enumerate(rows.tolist()):
                if r + off >= 0:
                    continue
                lastr = (r // bq) * bq + off + bq - 1
                if lastr < 0:
                    res[i] = 0.0
                else:
                    kb = min(lastr // bk, Sk // bk - 1)
                    res[i] = v[kb * bk:(kb + 1) * bk].sum(0) / bk
        out[rows] = res
    return out


def _inputs(seed, Sq, Sk, d, dv, lead=(), scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.normal(size=lead + s)).astype(np.float32)
                 for s in ((Sq, d), (Sk, d), (Sk, dv)))


def _sm_scale(d, scale):
    """sm_scale that gives inputs scaled by `scale` the logits of unit
    inputs at the default 1 / sqrt(d)."""
    return 1.0 / (scale * scale * math.sqrt(d))


def _tol_ratio(got, want):
    """The largest |got - want| / (TOL + TOL |want|): at most 1 within TOL."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (TOL + TOL * want.abs())).max())


def _float64_attention(q, k, v, causal, sm_scale):
    """The dense softmax in float64: the function both versions round."""
    q, k, v = q.double(), k.double(), v.double()
    logits = torch.einsum("...qd,...kd->...qk", q, k) * sm_scale
    if causal:
        Sq, Sk = q.shape[-2], k.shape[-2]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(
            Sk - Sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    return torch.softmax(logits, -1) @ v


# Inputs scaled by 8 at the default sm_scale put the logits at 64 times
# those of unit inputs (std about 64): there the plain version's own f32
# rounding is 10-20 TOL from the float64 softmax (CPU and card, measured by
# the tests below), and two f32 versions that round differently cannot agree
# within TOL.  The scaled cases held to the plain version therefore take
# operands scaled by 8 with sm_scale / 64, the logits of unit inputs (the
# split is exact under a power-of-two scale; the output's absolute error
# grows 8x with V against TOL's fixed absolute part); the default sm_scale
# at 8x is held to float64, no further than the plain version.
EMULATED = {
    # Sq, Sk, d, dv, block, scale
    "square": (128, 128, 64, 64, 128, 1.0),
    "tiles8": (64, 64, 64, 64, 8, 1.0),
    "tiles24": (96, 96, 32, 32, 24, 1.0),
    "sq_lt_sk": (64, 192, 64, 64, 64, 1.0),
    "scaled8": (128, 128, 64, 64, 128, 8.0),
    "d18": (64, 128, 18, 16, 64, 1.0),
    "wide": (64, 96, 160, 160, 32, 1.0),
    "ragged": (40, 72, 40, 128, 8, 1.0),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_kernel_matches_plain(case, causal):
    """The kernel's algorithm with emulated split dots against the plain
    version (dense softmax) within TOL: tiles of 8, 24, 64 and 128 rows,
    Sq < Sk, inputs scaled x8, a head width that is not a multiple of 4,
    value widths 16 to 160, lengths that are not multiples of 64."""
    Sq, Sk, d, dv, blk, scale = EMULATED[case]
    seed = sorted(EMULATED).index(case)
    q, k, v = map(torch.as_tensor, _inputs(seed, Sq, Sk, d, dv, scale=scale))
    sm = _sm_scale(d, scale)
    got = emulate_kernel(q, k, v, causal, blk, blk, sm_scale=sm)
    want = FA.flash_attention_plain(q, k, v, causal=causal, sm_scale=sm)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_kernel_at_large_logits_is_no_further_from_float64(d,
                                                                    causal):
    """Inputs scaled x8 at the default sm_scale: the kernel's algorithm is
    no further from the float64 softmax than the plain version is (both
    beyond TOL of it: the f32 logits themselves are rounded)."""
    q, k, v = map(torch.as_tensor, _inputs(d, 128, 128, d, d, scale=8.0))
    truth = _float64_attention(q, k, v, causal, 1 / math.sqrt(d))
    kernel = _tol_ratio(emulate_kernel(q, k, v, causal, 128, 128), truth)
    plain = _tol_ratio(FA.flash_attention_plain(q, k, v, causal), truth)
    assert plain > 1
    assert kernel <= plain


@pytest.mark.parametrize("Sq,Sk,bq,bk", [(96, 64, 48, 16), (96, 64, 48, 32),
                                         (128, 64, 32, 32), (64, 8, 64, 8)])
def test_emulated_kernel_matches_reference_when_rows_see_no_key(Sq, Sk, bq,
                                                                bk):
    """Causal with Sq > Sk: the first Sq - Sk rows see no key.  The
    reference's Pallas kernel (interpret mode) gives them the mean of V
    over the last kv tile their q tile reaches (0 where it reaches none),
    which the dense plain version does not; the kernel's algorithm gives
    them the reference's, and every other row within TOL."""
    q, k, v = _inputs(Sq + Sk + bq + bk, Sq, Sk, 32, 32)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=True,
                             block_q=bq, block_k=bk))
    got = emulate_kernel(*map(torch.as_tensor, (q, k, v)), True, bq, bk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# --- the CUDA kernel on the card --------------------------------------------

CARD_CASES = {
    # lead, Sq, Sk, d, dv, block, scale
    "forward_d64": ((64,), 1024, 1024, 64, 64, 128, 1.0),
    "forward_d128": ((64,), 1024, 1024, 128, 128, 128, 1.0),
    "sq_lt_sk": ((4,), 128, 384, 64, 64, 64, 1.0),
    "sq_lt_sk_long": ((2,), 64, 1024, 64, 64, 64, 1.0),
    "tiles8": ((3,), 64, 64, 64, 64, 8, 1.0),
    "tiles24": ((2, 2), 96, 192, 64, 64, 24, 1.0),
    "tiles64": ((4,), 256, 256, 64, 64, 64, 1.0),
    "scaled8": ((8,), 256, 256, 64, 64, 128, 8.0),
    "scaled8_d128": ((4,), 256, 256, 128, 128, 128, 8.0),
    "d18": ((2,), 96, 192, 18, 16, 24, 1.0),
    "d160_dv64": ((2,), 128, 128, 160, 64, 64, 1.0),
    "ragged": ((3,), 40, 72, 40, 128, 8, 1.0),
}


def _on_card(x):
    return torch.as_tensor(x, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_tf32_kernel_matches_plain_on_card(case):
    """The CUDA kernel against its plain version on the card, causal and
    not, within TOL, one launch per call: the forward's shape at head
    widths 64 and 128, Sq < Sk, tiles of 8, 24 and 64, inputs scaled x8
    (sm_scale / 64, see EMULATED), head widths 18 and 160."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    lead, Sq, Sk, d, dv, blk, scale = CARD_CASES[case]
    seed = 100 + sorted(CARD_CASES).index(case)
    q, k, v = map(_on_card, _inputs(seed, Sq, Sk, d, dv, lead, scale=scale))
    sm = _sm_scale(d, scale)
    for causal in (False, True):
        before = FA.LAUNCHES
        got = FA.flash_attention(q, k, v, causal=causal, sm_scale=sm,
                                 block_q=blk, block_k=blk)
        assert FA.LAUNCHES == before + 1
        want = FA.flash_attention_plain(q, k, v, causal=causal, sm_scale=sm)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_tf32_kernel_at_large_logits_is_no_further_from_float64_on_card(d):
    """Inputs scaled x8 at the default sm_scale, causal and not: the
    kernel is no further from the float64 softmax than the plain version
    on the card is (both beyond TOL of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = map(_on_card, _inputs(d + 1, 256, 256, d, d, (8,), scale=8.0))
    for causal in (False, True):
        truth = _float64_attention(q, k, v, causal, 1 / math.sqrt(d))
        kernel = _tol_ratio(FA.flash_attention(q, k, v, causal=causal),
                            truth)
        plain = _tol_ratio(FA.flash_attention_plain(q, k, v, causal), truth)
        assert plain > 1
        assert kernel <= plain


@pytest.mark.gpu
def test_tf32_kernel_takes_unaligned_operands_on_card():
    """Operands whose rows do not start on 16 bytes (views one element into
    their storage, a head width of 18) go through the kernel's 4-byte
    copies and give the plain version's output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    def shifted(x):
        """x in storage one element in: 4 bytes off 16-byte alignment."""
        flat = torch.empty(x.size + 1, dtype=torch.float32, device="cuda")
        flat[1:] = _on_card(x.reshape(-1))
        return flat[1:].view(x.shape)

    for seed, d in ((30, 64), (31, 18)):
        q, k, v = map(shifted, _inputs(seed, 128, 128, d, 32))
        assert k.data_ptr() % 16 and v.data_ptr() % 16
        for causal in (False, True):
            got = FA.flash_attention(q, k, v, causal=causal, block_q=64,
                                     block_k=64)
            want = FA.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,bq,bk", [(96, 64, 48, 16), (128, 64, 32, 32),
                                         (256, 128, 128, 64)])
def test_tf32_kernel_rows_that_see_no_key_on_card(Sq, Sk, bq, bk):
    """Causal with Sq > Sk: the kernel against its algorithm emulated on the
    CPU (which the CPU tests hold to the reference's Pallas kernel), rows
    that see no key included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _inputs(Sq + Sk, Sq, Sk, 64, 64, (2,))
    got = FA.flash_attention(*map(_on_card, (q, k, v)), causal=True,
                             block_q=bq, block_k=bk)
    for i in range(2):
        want = emulate_kernel(*map(torch.as_tensor, (q[i], k[i], v[i])),
                              True, bq, bk)
        torch.testing.assert_close(got[i].cpu(), want, atol=TOL, rtol=TOL)
