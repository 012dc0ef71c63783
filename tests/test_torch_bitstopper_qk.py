"""The port's fused BitStopper attention held against the JAX package on
the CPU: the wrapper's prepared operands equal the reference's exactly, the
plain version equals the reference's Pallas kernel (interpret mode) on
rounds and survivors exactly and on the output within 2e-5, and the port's
per-token BESF equals the reference's on its integer statistics.  The
gpu-marked test holds the CUDA kernel against the plain version on the
card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import margins as jmargins
from repro.core import quantization as jqlib
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import besf_attention as jbesf
from repro.kernels.bitstopper_qk import bitstopper_attention_kernel as jkernel
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention as tbesf
from repro_torch.kernels import bitstopper_qk as BQ
from repro_torch.kernels import ref as tref
from repro_torch.kernels.runtime import width_refusal
from _torch_threads import one_thread  # noqa: F401

# Integers exact; the output's softmax differs by exp and summation order.
TOL = 2e-5


def _inputs(seed, Sq, Sk, d, dv, lead=(), scale=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=lead + (Sq, d)) * scale).astype(np.float32),
            (rng.normal(size=lead + (Sk, d)) * scale).astype(np.float32),
            rng.normal(size=lead + (Sk, dv)).astype(np.float32))


def _hot_inputs(seed=11, d=64):
    """``test_bitstopper_kernel_skips_planes``: every query shares a
    dominant direction and only the first kv block holds keys along it, so
    later blocks terminate early."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    q = 8.0 * u[None] + 0.05 * rng.normal(size=(64, d))
    k = np.concatenate([8.0 * u[None] + 0.05 * rng.normal(size=(32, d)),
                        0.05 * rng.normal(size=(224, d))])
    v = rng.normal(size=(256, d))
    return tuple(x.astype(np.float32) for x in (q, k, v))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reference_prep(q, k, v, cfg):
    """The reference wrapper's operand preparation
    (``bitstopper_qk.py:319-338``), per slice, vmapped as it is there."""
    def one(q2, k2, v2):
        bits = cfg.bits
        q_int, qp = jqlib.quantize(q2, bits)
        k_int, kp = jqlib.quantize(k2, bits)
        k_packed = jqlib.pack_planes_seq(jqlib.to_bitplanes(k_int, bits))
        m_min, m_max = jmargins.bit_margins(q_int, bits)
        scale_total = qp.scale * kp.scale * (1.0 / (q2.shape[-1] ** 0.5))
        radius_int = cfg.radius / scale_total
        scalars = jnp.stack([scale_total, cfg.alpha * radius_int]).astype(
            jnp.float32)
        v_int, vp = jqlib.quantize(v2, bits)
        return (q_int, k_packed, jqlib.dequantize(v_int, vp), m_min, m_max,
                scalars)
    return jax.vmap(one)(q, k, v)


@pytest.mark.parametrize("alpha", [0.2, 0.6])
def test_prep_operands_equal_reference(alpha):
    """q_int, packed K planes, V, both margins and both LATS scalars equal
    the reference's bit for bit, per (batch, head) slice."""
    q, k, v = _inputs(0, 64, 128, 64, 32, (3,))
    want = _reference_prep(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           JConfig(alpha=alpha))
    got = BQ.prep(*map(torch.as_tensor, (q, k, v)), TConfig(alpha=alpha))
    names = ("q_int", "k_packed", "v_eff", "m_min", "m_max", "scalars")
    for name, w in zip(names, want):
        g = getattr(got, name).numpy()
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _assert_matches(got, want):
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    np.testing.assert_array_equal(got.survivors.numpy(),
                                  np.asarray(want.survivors))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Sq,Sk,d,dv,bq,bk", [
    (64, 64, 32, 32, 32, 32),
    (64, 128, 64, 64, 32, 64),
    (128, 128, 64, 64, 64, 64),
    (32, 256, 64, 32, 32, 64),
    (128, 128, 256, 256, 64, 64),     # recurrentgemma-2b's heads
    (128, 128, 192, 128, 64, 64),     # deepseek-v3's MLA heads
])
@pytest.mark.parametrize("alpha", [0.2, 0.6])
def test_kernel_matches_reference(Sq, Sk, d, dv, bq, bk, alpha):
    """The shapes and alphas of ``test_bitstopper_kernel_matches_oracle``:
    rounds and survivors exact, out within 2e-5, and the survivors equal
    the port's block oracle."""
    q, k, v = _inputs(42 + Sq + Sk, Sq, Sk, d, dv)
    want = jkernel(*map(jnp.asarray, (q, k, v)), cfg=JConfig(alpha=alpha),
                   block_q=bq, block_k=bk)
    got = BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)),
                                         cfg=TConfig(alpha=alpha),
                                         block_q=bq, block_k=bk)
    _assert_matches(got, want)
    oracle = tref.bitstopper_attention(*map(torch.as_tensor, (q, k, v)),
                                       cfg=TConfig(alpha=alpha), block_q=bq,
                                       block_k=bk)
    assert torch.equal(got.survivors.bool(), oracle.stats.survivors)


@pytest.mark.parametrize("case", ["causal", "full", "batched", "hot"])
def test_kernel_cases_match_reference(case):
    """Causal and not (``test_bitstopper_kernel_causal``), leading [B, H]
    dims (``test_bitstopper_kernel_batched``), and the plane-skipping input
    (``test_bitstopper_kernel_skips_planes``), where whole blocks stop
    before the dense 12 planes."""
    kw = dict(block_q=64, block_k=64)
    cfg = dict(alpha=0.6)
    if case in ("causal", "full"):
        q, k, v = _inputs(7, 128, 128, 64, 64, scale=1.0)
        kw["causal"] = case == "causal"
    elif case == "batched":
        q, k, v = _inputs(3, 64, 64, 32, 32, (2, 3), scale=1.0)
        kw = dict(block_q=32, block_k=32)
        cfg = {}
    else:
        q, k, v = _hot_inputs()
        kw = dict(block_q=32, block_k=32)
        cfg = dict(alpha=0.4)
    want = jkernel(*map(jnp.asarray, (q, k, v)), cfg=JConfig(**cfg), **kw)
    got = BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)),
                                         cfg=TConfig(**cfg), **kw)
    assert got.out.shape == want.out.shape
    assert got.survivors.dtype == torch.int8
    _assert_matches(got, want)
    if case == "hot":
        assert int(got.rounds.sum()) < got.rounds.numel() * 12
    if case == "causal":
        # the block above the diagonal is skipped: no plane, no survivor
        assert int(got.rounds[0, 1]) == 0


def test_untiled_lengths_raise():
    """The reference asserts its tiling; the port raises ``ValueError``."""
    q, k, v = _inputs(1, 200, 200, 32, 32)
    with pytest.raises(AssertionError):
        jkernel(*map(jnp.asarray, (q, k, v)))
    with pytest.raises(ValueError, match="tiled"):
        BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)))
    q, k, v = _inputs(1, 20, 20, 32, 32)       # 20 <= 128 but not 8 | 20
    with pytest.raises(ValueError, match="multiple of 8"):
        BQ.bitstopper_attention_kernel(*map(torch.as_tensor, (q, k, v)))


@pytest.mark.parametrize("mask_kind", ["causal", "per_example"])
def test_besf_attention_matches_reference(mask_kind):
    """The per-token BESF: planes fetched, survivors and validity exact;
    probabilities and output within 2e-5.  The block oracle keeps a
    superset of its survivors (``test_block_keeps_superset``)."""
    q, k, v = _inputs(5, 64, 64, 32, 32, (2, 2), scale=1.0)
    cfg = dict(alpha=0.5, min_rounds=2)
    if mask_kind == "causal":
        kw = dict(causal=True)
        tkw = kw
    else:
        m = np.random.default_rng(6).random((2, 1, 64, 64)) < 0.7
        kw = dict(mask=jnp.asarray(m))
        tkw = dict(mask=torch.as_tensor(m))
    want = jbesf(*map(jnp.asarray, (q, k, v)), cfg=JConfig(**cfg), **kw)
    got = tbesf(*map(torch.as_tensor, (q, k, v)), cfg=TConfig(**cfg), **tkw)
    for name in ("planes_fetched", "survivors", "valid"):
        np.testing.assert_array_equal(getattr(got.stats, name).numpy(),
                                      np.asarray(getattr(want.stats, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.scores.numpy() <= -1e29,
                                  np.asarray(want.scores) <= -1e29)
    for name in ("out", "probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=TOL, err_msg=name)
    if mask_kind == "causal":
        ref = tref.bitstopper_reference(*map(torch.as_tensor, (q, k, v)),
                                        cfg=TConfig(**cfg), causal=True)
        block = tref.bitstopper_attention(*map(torch.as_tensor, (q, k, v)),
                                          cfg=TConfig(**cfg), block_q=32,
                                          block_k=32, causal=True)
        assert torch.equal(ref.stats.survivors, got.stats.survivors)
        assert bool((block.stats.survivors | ~ref.stats.survivors).all())


# (lead, Sq, Sk, d, dv, block_q, block_k, cfg, input seed, input scale):
# the forward's tile (128) and small tiles; head widths below and between
# the tensor-core depth of 32 bytes (16, 48, 96) and 160 (stablelm-12b),
# and widths whose planes are not copied in 16-byte pieces (40: 4-byte
# pieces, 18: through registers); q tiles of 8 and 24 rows (not a multiple
# of 16); kv blocks of 8; a causal grid of eight q tiles with 1 to 8 kv
# blocks each; 14-bit planes (LATS by the float operations alone); and an
# input where tiles die at round min_rounds - 1 and one dies at its last
# round.
CARD_CASES = {
    "blk128": ((2, 4), 256, 256, 64, 64, 128, 128, dict(alpha=0.6), 30, 2.0),
    "blk64": ((3,), 64, 128, 64, 64, 64, 64, dict(alpha=0.2), 31, 2.0),
    "blk32": ((2,), 32, 256, 64, 32, 32, 32, dict(alpha=0.6), 32, 2.0),
    "d16": ((2, 2), 64, 64, 16, 16, 128, 128, dict(alpha=0.8), 33, 2.0),
    "d160": ((2,), 256, 256, 160, 160, 128, 128, dict(alpha=0.6), 34, 2.0),
    "d16_dv32": ((2,), 128, 128, 16, 32, 64, 64, dict(alpha=0.6), 35, 2.0),
    "d48": ((2,), 128, 128, 48, 64, 64, 64, dict(alpha=0.6), 36, 2.0),
    "d96": ((2,), 128, 128, 96, 128, 64, 64, dict(alpha=0.6), 37, 2.0),
    "sq8": ((3,), 8, 64, 64, 64, 128, 128, dict(alpha=0.6), 38, 2.0),
    "sq24": ((2,), 24, 48, 32, 32, 128, 128, dict(alpha=0.4), 39, 2.0),
    "bk8": ((2,), 32, 64, 64, 64, 16, 8, dict(alpha=0.6), 40, 2.0),
    "uneven_causal": ((2,), 512, 512, 64, 64, 64, 64, dict(alpha=0.6), 41,
                      1.0),
    "deaths": ((4,), 64, 256, 32, 32, 16, 16, dict(alpha=0.0, min_rounds=6),
               0, 2.0),
    "d40": ((2,), 64, 128, 40, 32, 64, 64, dict(alpha=0.6), 42, 2.0),
    "d18": ((2,), 64, 128, 18, 16, 64, 64, dict(alpha=0.6), 43, 2.0),
    "bits14": ((2,), 128, 128, 64, 64, 64, 64, dict(alpha=0.6, bits=14), 44,
               2.0),
    # The wide instantiations (V staged in column chunks): the registry's
    # widest heads, a narrow head with a wide value, and a value width of
    # 48 on the narrow ones.
    "d256": ((2,), 256, 256, 256, 256, 128, 128, dict(alpha=0.6), 45, 2.0),
    "d192_dv128": ((2,), 128, 256, 192, 128, 64, 64, dict(alpha=0.6), 46,
                   2.0),
    "d64_dv208": ((2,), 64, 128, 64, 208, 64, 64, dict(alpha=0.6), 47,
                  2.0),
    "dv48": ((2,), 64, 128, 64, 48, 64, 64, dict(alpha=0.6), 48, 2.0),
}


def _card_case(name):
    lead, Sq, Sk, d, dv, blk_q, blk_k, cfg, seed, scale = CARD_CASES[name]
    q, k, v = (torch.as_tensor(x, device="cuda")
               for x in _inputs(seed, Sq, Sk, d, dv, lead, scale=scale))
    return q, k, v, blk_q, blk_k, TConfig(**cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bitstopper_kernel_matches_plain_on_card(case):
    """The CUDA kernel against its plain version on the same operands,
    causal and not: rounds and survivors exact, out within 2e-5, one launch
    per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, blk_q, blk_k, cfg = _card_case(case)
    Sq, Sk = q.shape[-2], k.shape[-2]
    flat = lambda x: x.reshape((-1,) + x.shape[-2:])
    ops = BQ.prep(flat(q), flat(k), flat(v), cfg)
    bq, bk = BQ._blocks(Sq, Sk, blk_q, blk_k)
    for causal in (False, True):
        before = BQ.LAUNCHES
        got = BQ.bitstopper_attention_kernel(q, k, v, cfg, blk_q, blk_k,
                                             causal)
        assert BQ.LAUNCHES == before + 1
        want = BQ.bitstopper_qk_plain(ops, cfg, bq, bk, causal)
        torch.cuda.synchronize()
        assert torch.equal(got.rounds.reshape(want.rounds.shape),
                           want.rounds)
        assert torch.equal(got.survivors.reshape(want.survivors.shape),
                           want.survivors)
        torch.testing.assert_close(got.out.reshape(want.out.shape),
                                   want.out, atol=TOL, rtol=TOL)
        if case == "deaths" and not causal:
            n_qt, n_kb = want.rounds.shape[1:]
            surv = want.survivors.reshape(-1, n_qt, bq, n_kb, bk).any(4) \
                .any(2)
            assert bool((want.rounds == cfg.min_rounds).any())
            assert bool(((want.rounds == cfg.bits) & ~surv).any())
        if case == "uneven_causal" and causal:
            live = (want.rounds > 0).sum(-1)[0]
            assert live.tolist() == list(range(1, Sq // bq + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["blk128", "deaths", "sq24", "d40", "d18",
                                  "d256", "d64_dv208"])
def test_kernel_copy_counter_matches_design(case):
    """The plane and V bytes the kernel requested, by its own counter: every
    reachable tile min(bits, rounds + LOOKAHEAD) planes, V only for a tile
    with a survivor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, blk_q, blk_k, cfg = _card_case(case)
    flat = lambda x: x.reshape((-1,) + x.shape[-2:])
    ops = BQ.prep(flat(q), flat(k), flat(v), cfg)
    bq, bk = BQ._blocks(q.shape[-2], k.shape[-2], blk_q, blk_k)
    d, dv = q.shape[-1], v.shape[-1]
    for causal in (False, True):
        BQ.count_copies(True)
        try:
            BQ.copied_bytes()
            got = BQ.launch_kernel(ops, cfg, bq, bk, causal)
            planes, v_bytes = BQ.copied_bytes()
        finally:
            BQ.count_copies(False)
        n_qt, n_kb = got.rounds.shape[1:]
        live_v = int(got.survivors.reshape(-1, n_qt, bq, n_kb, bk).any(4)
                     .any(2).sum())
        assert planes == BQ.design_plane_bytes(got.rounds, cfg.bits, bk, d)
        assert v_bytes == live_v * bk * dv * 4


def _stream_requests(tile_rounds, bits, look=BQ.LOOKAHEAD):
    """The kernel's plane stream (``refill`` and the kv loop of
    ``csrc/bitstopper_qk.cu``) over reachable tiles that run
    ``tile_rounds`` rounds: planes requested per tile.  After each live
    vote the stream runs look + 1 planes ahead of the consumers; a tile that
    dies waits for the planes requested past its verdict.  Asserts that a
    ring slot is refilled only after every thread used its plane before the
    last vote (a block barrier)."""
    slots = 2 * look + 1
    st = dict(pkb=0, pr=0, pseq=0, cseq=0)
    req = [0] * len(tile_rounds)
    used_by_all = -1          # items every thread has used

    def refill():
        while st["pseq"] < st["cseq"] + look + 1 and \
                st["pkb"] < len(tile_rounds):
            assert st["pseq"] - slots <= used_by_all
            req[st["pkb"]] += 1
            st["pseq"] += 1
            st["pr"] += 1
            if st["pr"] == bits:
                st["pr"], st["pkb"] = 0, st["pkb"] + 1

    refill()
    for kb, R in enumerate(tile_rounds):
        for r in range(R):
            assert st["cseq"] < st["pseq"]         # the plane was requested
            st["cseq"] += 1
            used_by_all = st["cseq"] - 1           # the vote
            if r == R - 1 and R < bits:            # dead
                st["cseq"] += min(bits - R, look)  # dropped, waited for
                if st["pkb"] == kb:
                    st["pkb"], st["pr"] = kb + 1, 0
                refill()
                break
            refill()
    assert st["cseq"] == st["pseq"]               # nothing left in flight
    return req


@pytest.mark.parametrize("pattern", ["dense", "early", "mixed", "random"])
def test_plane_stream_requests_design_figure(pattern):
    """The design's plane bytes (``design_plane_bytes``, what the card test
    holds the kernel's own counter to) are what the kernel's plane stream
    requests: min(bits, rounds + LOOKAHEAD) planes per reachable tile, none
    for an unreachable one."""
    bits = 12
    rng = np.random.default_rng(5)
    tiles = {"dense": [bits] * 6, "early": [1] * 6,
             "mixed": [1, bits, 2, bits - 1, bits - 2, 3, bits],
             "random": rng.integers(1, bits + 1, 40).tolist()}[pattern]
    req = _stream_requests(tiles, bits)
    assert req == [min(bits, r + BQ.LOOKAHEAD) for r in tiles]
    rounds = torch.tensor([tiles + [0, 0]], dtype=torch.int32)[None]
    assert BQ.design_plane_bytes(rounds, bits, 64, 48) == \
        sum(req) * 8 * 48


def _mma_s8(a_regs, b_regs, signed_a):
    """mma.sync.m16n8k32 with 8-bit operands, from per-lane registers in
    the PTX ISA's fragment layout: A (16 x 32, row) a[lane][4], B (32 x 8,
    col) b[lane][2] (s8); C (16 x 8) as c[lane][4]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        for reg in range(4):
            for j in range(4):
                x = (int(a_regs[lane][reg]) >> (8 * j)) & 255
                if signed_a and x > 127:
                    x -= 256
                A[g + 8 * (reg & 1), 4 * c + j + 16 * (reg >> 1)] = x
        for reg in range(2):
            for j in range(4):
                x = (int(b_regs[lane][reg]) >> (8 * j)) & 255
                B[4 * c + j + 16 * reg, g] = x - 256 if x > 127 else x
    C = A @ B
    return [[C[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)]
             for i in range(4)] for lane in range(32)]


@pytest.mark.parametrize("bits", [12, 16])
def test_q_bytes_recompose_every_value(bits):
    """The kernel's split of q_int into the A operands of its two MMAs: a
    signed high byte q >> 8 (s8) and an unsigned low byte q & 255 (u8), with
    256 * hi + lo == q for every value of the quantizer's range."""
    q = np.arange(-2 ** (bits - 1), 2 ** (bits - 1), dtype=np.int64)
    hi, lo = q >> 8, q & 255
    assert hi.min() >= -128 and hi.max() <= 127
    assert lo.min() >= 0 and lo.max() <= 255
    np.testing.assert_array_equal(256 * hi + lo, q)
    # as the packed register bytes the fragments hold
    hi_u8 = (hi & 255).astype(np.uint8)
    np.testing.assert_array_equal(hi_u8.view(np.int8).astype(np.int64) * 256
                                  + lo.astype(np.uint8), q)


@pytest.mark.parametrize("d", [16, 48, 64, 96, 160])
@pytest.mark.parametrize("bits", [12, 16])
def test_plane_dot_fragments_are_exact(d, bits):
    """The kernel's plane dots, emulated lane by lane: q's hi/lo byte
    fragments in the permuted k order, B words of a packed plane row
    shifted by the lane's token and masked (bytes past d are arbitrary),
    and dot = 256 * hi + lo give q_int . plane exactly for 16 rows x 8
    tokens."""
    rng = np.random.default_rng(d + bits)
    KS = (d + 31) // 32
    q = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), (16, d))
    q[0, :] = -2 ** (bits - 1)                    # the extremes
    q[1, :] = 2 ** (bits - 1) - 1
    plane = rng.integers(0, 2, (8, d))
    packed = rng.integers(0, 256, KS * 32)        # the ring row, padded
    packed[:d] = (plane << np.arange(8)[:, None]).sum(0)

    def word(off):
        return sum(int(packed[off + j]) << (8 * j) for j in range(4))

    th = np.zeros((32, 4), np.int64)
    tl = np.zeros((32, 4), np.int64)
    for ks in range(KS):
        pair = (ks & 1) or ks + 1 < KS
        a_hi, a_lo, b = [], [], []
        for lane in range(32):
            g, c = lane >> 2, lane & 3
            base = (32 * (ks & ~1) + 16 * c + 8 * (ks & 1) if pair
                    else 32 * ks + 8 * c)
            hi, lo = [0] * 4, [0] * 4
            for h in range(2):
                for half in range(2):
                    for j in range(4):
                        dd = base + 4 * half + j
                        v = int(q[g + 8 * h, dd]) if dd < d else 0
                        hi[h + 2 * half] |= ((v >> 8) & 255) << (8 * j)
                        lo[h + 2 * half] |= (v & 255) << (8 * j)
            a_hi.append(hi)
            a_lo.append(lo)
            # the B words: one 16-byte load per lane for a pair of k-steps
            off = (32 * (ks & ~1) + 16 * c + 8 * (ks & 1) if pair
                   else 32 * ks + 8 * c)
            b.append([(word(off + 4 * i) >> g) & 0x01010101
                      for i in range(2)])
        th += np.array(_mma_s8(a_hi, b, True))
        tl += np.array(_mma_s8(a_lo, b, False))
    want = q @ plane.T
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        for i in range(4):
            got = th[lane, i] * 256 + tl[lane, i]
            assert got == want[g + 8 * (i >> 1), 2 * c + (i & 1)]


def test_fp64_fragments_sum_every_token():
    """P x V's fragments (mma.sync.m16n8k8.f64): lane (g, c) gives A its own
    accumulator weights, rows g and g + 8 of tokens 2c (k = c) and 2c + 1
    (k = c + 4) of an 8-token n-tile, and B V[token][column g] of the same
    tokens; C (rows g and g + 8, columns 2c and 2c + 1) is the sum over the
    n-tile's tokens."""
    rng = np.random.default_rng(9)
    p = rng.random((16, 8))
    v = rng.normal(size=(8, 8))
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for lane in range(32):
        g, c = lane >> 2, lane & 3
        a = (p[g, 2 * c], p[g + 8, 2 * c], p[g, 2 * c + 1],
             p[g + 8, 2 * c + 1])
        for e, (row, k) in enumerate(((g, c), (g + 8, c), (g, c + 4),
                                      (g + 8, c + 4))):
            A[row, k] = a[e]
        B[c, g] = v[2 * c, g]
        B[c + 4, g] = v[2 * c + 1, g]
    np.testing.assert_allclose(A @ B, p @ v, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("d,dv", [(256, 256), (64, 48), (192, 64), (64, 40),
                                  (200, 64), (272, 64), (64, 272)])
def test_kernel_refuses_widths_it_does_not_take(d, dv):
    """Value widths that are not a multiple of 16, widths over 256, and
    heads over 160 that are not a multiple of 16 raise before any launch.
    The first three widths were refused until the kernel took every head
    and value width that is a multiple of 16 up to 256 (its wide
    instantiations): they are held instead, the plain version (the CPU
    path) against the reference's kernel in interpret mode."""
    q, k, v = _inputs(41, 128, 128, d, dv, (1,))
    cfg = TConfig(alpha=0.6)
    if width_refusal(d, dv) is None:
        want = jkernel(*map(jnp.asarray, (q[0], k[0], v[0])),
                       cfg=JConfig(alpha=0.6), block_q=64, block_k=64)
        got = BQ.bitstopper_attention_kernel(
            *(torch.as_tensor(x[0]) for x in (q, k, v)), cfg=cfg,
            block_q=64, block_k=64)
        _assert_matches(got, want)
        return
    ops = BQ.prep(*map(torch.as_tensor, (q, k, v)), cfg)
    before = BQ.LAUNCHES
    with pytest.raises(ValueError, match="value widths"):
        BQ.launch_kernel(ops, cfg, 128, 128, True)
    assert BQ.LAUNCHES == before
