"""The port's paged BESF verify (speculative decoding's draft-block scorer)
held against the JAX package: the torch oracle against the JAX oracle, the
kernel's plain version against the Pallas kernel in interpret mode on the
reference's adversarial tables, each real query against the port's Sq=1
decode, the per-KV-head ``rounds`` rule the CUDA kernel relies on, and (on
a card) the CUDA kernel against the plain version and the decode kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core.besf import BitStopperConfig as JConfig
from repro.core.besf import besf_attention_verify_paged as joracle
from repro.kernels.paged_verify import paged_bitstopper_verify as jkernel
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention_verify_paged as toracle
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_verify as pv

# The reference's tests/test_speculative.py tables: a physical block shared
# by two rows, a recycled block, a row ending mid-page (row 2) and a
# padding query (row 2, query 2, fill level 0).
_TABLE = np.array([[1, 2, 3, 4], [1, 5, 6, 0], [7, 3, 0, 0]], np.int32)
_QPOS = np.array([[61, 62, 63], [38, 39, 40], [17, 18, 0]], np.int32)
_LENGTHS = np.array([[62, 63, 64], [39, 40, 41], [18, 19, 0]], np.int32)


def _pool(seed, P=9, bs=16, Hkv=2, D=16, hot_heads=()):
    """The reference's ``_pool_state``: stale garbage louder than the
    running amax in the unreferenced block 8.  Each KV head in
    ``hot_heads`` gets a hot page (block 1) along a unit direction."""
    rng = np.random.default_rng(seed)
    k = (rng.normal(size=(P, bs, Hkv, D)) * 2).astype(np.float32)
    v = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    hot = {}
    for h in hot_heads:
        u = rng.normal(size=D)
        hot[h] = (u / np.linalg.norm(u)).astype(np.float32)
        k[:, :, h] *= 0.02
        k[1, :, h] += 8.0 * hot[h]
    k[8] = 50.0
    k_amax = np.abs(k[:8]).max(axis=(0, 1, 3))
    v_amax = np.abs(v).max(axis=(0, 1, 3))
    return k, v, k_amax, v_amax, hot


def _inputs(seed, G, hot_heads=()):
    """Operands on the reference's tables; query heads of a hot KV head
    point at its hot page."""
    k, v, k_amax, v_amax, hot = _pool(seed, hot_heads=hot_heads)
    rng = np.random.default_rng(seed + 1)
    Hkv, D = k.shape[2], k.shape[3]
    q = (rng.normal(size=(3, 3, Hkv * G, D)) * 2).astype(np.float32)
    for h, u in hot.items():
        q[:, :, h * G:(h + 1) * G] = (8.0 * u
                                      + 0.05 * q[:, :, h * G:(h + 1) * G])
    kq = np.asarray(jq.pack_pool_planes(jnp.asarray(k), jnp.asarray(k_amax)))
    return k, kq, v, _TABLE, _LENGTHS, _QPOS, k_amax, v_amax, q


def _draft_inputs(seed, G, bs=16, D=16, Sq=3):
    """Draft blocks of Sq consecutive queries on the reference's tables
    with pages of ``bs`` tokens (KV head 0 hot): slot 0's block ends its
    last page; slot 1's crosses from page 1 into page 2, so its first
    queries reach one page fewer than its last; slot 2 has two real queries
    ending mid-page 1, then padding queries (fill level 0)."""
    k, v, k_amax, v_amax, hot = _pool(seed, bs=bs, D=D, hot_heads=(0,))
    rng = np.random.default_rng(seed + 1)
    q = (rng.normal(size=(3, Sq, 2 * G, D)) * 2).astype(np.float32)
    q[:, :, :G] = 8.0 * hot[0] + 0.05 * q[:, :, :G]
    first = np.array([4 * bs - Sq, 2 * bs - 2, bs + 1], np.int32)
    q_pos = first[:, None] + np.arange(Sq, dtype=np.int32)[None]
    real = np.ones((3, Sq), bool)
    real[2, 2:] = False
    q_pos = np.where(real, q_pos, 0).astype(np.int32)
    lengths = np.where(real, q_pos + 1, 0).astype(np.int32)
    kq = np.asarray(jq.pack_pool_planes(jnp.asarray(k), jnp.asarray(k_amax)))
    return k, kq, v, _TABLE, lengths, q_pos, k_amax, v_amax, q


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_same(got, want, tol=1e-5):
    """rounds, survivors and v_fetched exactly; out within ``tol`` (f32
    exp and the summation order differ between the frameworks)."""
    for field in ("rounds", "survivors", "v_fetched"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(want, field)),
            err_msg=field)
    np.testing.assert_allclose(np.asarray(got.out), np.asarray(want.out),
                               atol=tol, rtol=tol)


_CASES = [(0.2, None, 1), (0.6, None, 2), (0.8, 24, 2)]   # alpha, window, G


@pytest.mark.parametrize("alpha,window,G", _CASES)
def test_oracle_matches_jax_oracle(alpha, window, G):
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(2, G)
    want = joracle(*map(jnp.asarray, (q, k, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=alpha), window=window)
    got = toracle(*map(_t, (q, k, v, table, lengths, q_pos, k_amax,
                            v_amax)), cfg=TConfig(alpha=alpha), window=window)
    _assert_same(got, want)


@pytest.mark.parametrize("alpha,window,G", _CASES)
def test_plain_matches_jax_kernel_interpret(alpha, window, G):
    """The kernel's plain version against the Pallas kernel itself, run in
    interpret mode as the reference's tests run it."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(2, G)
    want = jkernel(*map(jnp.asarray, (q, kq, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=alpha), window=window, interpret=True)
    got = pv.paged_bitstopper_verify(
        *map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)),
        cfg=TConfig(alpha=alpha), window=window)
    _assert_same(got, want)
    rounds = got.rounds.numpy()
    assert (rounds[2, :, 2:] == 0).all()      # row 2 ends mid page 2
    assert (rounds[2, 2] == 0).all()          # padding query: nothing
    assert rounds[1, 0, 3] == 0               # null table entry


@pytest.mark.parametrize("G", [1, 2])
def test_each_query_equals_sq1_decode(G):
    """Losslessness foundation: every real (slot, query) row of the verify
    equals the port's Sq=1 decode at that position and fill level, bit for
    bit; the padding query reads nothing.  One plane load serves the whole
    block, so the block's plane count (max over its queries per page) is
    below the sum of the per-query counts."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(4, G)
    rest = tuple(map(_t, (k_amax, v_amax)))
    cfg = TConfig(alpha=0.4)
    ver = pv.paged_bitstopper_verify(_t(q), _t(kq), _t(v), _t(table),
                                     _t(lengths), _t(q_pos), *rest, cfg=cfg)
    for b in range(3):
        for s in range(3):
            if lengths[b, s] == 0:
                assert ver.rounds[b, s].sum() == 0
                assert not ver.survivors[b, s].any()
                continue
            dec = pd.paged_bitstopper_decode(
                _t(q[b:b + 1, s]), _t(kq), _t(v), _t(table[b:b + 1]),
                _t(lengths[b:b + 1, s]), _t(q_pos[b:b + 1, s]), *rest,
                cfg=cfg)
            assert torch.equal(dec.out[0], ver.out[b, s])
            assert torch.equal(dec.rounds[0], ver.rounds[b, s])
            assert torch.equal(dec.survivors[0], ver.survivors[b, s])
            assert torch.equal(dec.v_fetched[0], ver.v_fetched[b, s])
    rounds = ver.rounds.numpy()
    assert rounds.max(1).sum() < rounds.sum()


@pytest.mark.parametrize("G", [1, 2])
def test_rounds_is_max_over_kv_heads(G):
    """The CUDA kernel walks each (slot, KV head) on its own and writes
    per-(head, query) plane counts; the reference counts rounds per query
    over all heads.  Run the plain version on each KV head alone: survivors
    and output per head are unchanged, and each query's rounds is the max
    of the per-head rounds."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
        5, G, hot_heads=(0,))
    cfg = TConfig(alpha=0.4)
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    whole = pv.paged_bitstopper_verify(*args, cfg=cfg)
    per_head = []
    for h in range(kq.shape[3]):
        hs = slice(h * G, (h + 1) * G)
        part = pv.paged_bitstopper_verify(
            args[0][:, :, hs], args[1][:, :, :, h:h + 1].contiguous(),
            args[2][:, :, h:h + 1].contiguous(), *args[3:6],
            args[6][h:h + 1], args[7][h:h + 1], cfg=cfg)
        assert torch.equal(part.survivors, whole.survivors[:, :, hs])
        assert torch.equal(part.out, whole.out[:, :, hs])
        per_head.append(part.rounds)
    per_head = torch.stack(per_head, 1)
    assert torch.equal(per_head.amax(1), whole.rounds)
    assert (per_head[:, 0] != per_head[:, 1]).any()       # the max matters


@pytest.mark.parametrize("window,G", [(None, 1), (None, 2), (20, 1),
                                      (20, 2)])
def test_plain_pages_outside_a_query_range_stay_empty(window, G):
    """The rule the kernel's union walk keeps: a page outside a query's
    range (after its position, or before its window) gets 0 rounds and no
    survivors for that query, though another query of the draft block
    reaches it, and a padding query reaches no page.  The plain version
    equals the JAX oracle on these draft blocks."""
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _draft_inputs(8, G)
    cfg = TConfig(alpha=0.4)
    got = pv.paged_bitstopper_verify(
        *map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)),
        cfg=cfg, window=window)
    want = joracle(*map(jnp.asarray, (q, k, v, table, lengths, q_pos,
                                      k_amax, v_amax)),
                   cfg=JConfig(alpha=0.4), window=window)
    _assert_same(got, want)
    rounds = got.rounds.numpy()                            # [B, Sq, MB]
    surv = got.survivors.numpy().reshape(3, 3, 2 * G, 4, 16)
    # Slot 1: queries 0 and 1 end on page 1; query 2 reaches page 2.
    assert rounds[1, 2, 2] > 0 and (rounds[1, :2, 2] == 0).all()
    assert not surv[1, :2, :, 2].any()
    # Slot 2: query 2 is padding.
    assert (rounds[2, 2] == 0).all() and not surv[2, 2].any()
    assert (got.out[2, 2] == 0).all()
    if window is not None:
        # Slot 0 (positions 61..63, window 20): pages 0 and 1 lie before
        # every query's window; page 2 (32..47) holds the window start.
        assert (rounds[0, :, :2] == 0).all() and not surv[0, :, :, :2].any()
        assert (rounds[0, :, 2] > 0).all()


def test_cpu_tensors_take_the_plain_path():
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(0, 1)
    args = tuple(map(_t, (q, kq, v, table, lengths, q_pos, k_amax, v_amax)))
    before = pv.LAUNCHES
    full = pv.paged_bitstopper_verify(*args)
    lean = pv.paged_bitstopper_verify(*args, stats=False)
    assert pv.LAUNCHES == before
    assert lean.survivors is None and lean.v_fetched is None
    assert torch.equal(lean.out, full.out)
    assert torch.equal(lean.rounds, full.rounds)
    with pytest.raises(ValueError):
        pv.paged_bitstopper_verify(args[0], *args[1:4], args[4][:, :2],
                                   *args[5:])
    with pytest.raises(ValueError):
        pv.paged_bitstopper_verify(args[0][:, 0], *args[1:])


# Card cases: (alpha, window, G, min_rounds, quantize_v, tables, bs, D, Sq).
# "reference" runs the reference's tables (_inputs), "draft" the draft
# blocks of _draft_inputs: a block crossing a page boundary, one ending
# mid-page with padding queries.  G = 3, 5 and 8 give other row layouts
# (beyond four rows a walk warp walks several); G = 1 with Sq = 5 gives two
# query groups per (slot, KV head); pages of 48 and 64 tokens give a lane
# several tokens, pages of 512 and 1024 run the striped walk; windows give
# each query another first page.
_GPU_CASES = [
    (0.2, None, 1, 1, True, "reference", 16, 16, 3),
    (0.6, None, 2, 1, True, "reference", 16, 16, 3),
    (0.8, 24, 2, 1, False, "reference", 16, 16, 3),
    (1.0, 16, 1, 3, True, "reference", 16, 16, 3),
    (0.4, None, 1, 1, True, "reference", 16, 16, 3),
    (0.6, None, 3, 1, True, "draft", 16, 16, 3),
    (0.8, 24, 5, 2, False, "draft", 16, 16, 3),
    (0.6, None, 8, 1, True, "draft", 16, 64, 3),
    (0.6, None, 1, 1, True, "draft", 16, 16, 5),
    (0.4, 20, 1, 1, True, "draft", 16, 16, 5),
    (0.6, None, 1, 1, True, "draft", 48, 16, 5),
    (0.8, 40, 2, 1, True, "draft", 64, 16, 3),
    (0.6, None, 1, 1, True, "draft", 512, 16, 5),
    (0.8, 600, 2, 1, False, "draft", 1024, 64, 3),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "alpha,window,G,min_rounds,quantize_v,tables,bs,D,Sq", _GPU_CASES)
def test_cuda_kernel_matches_plain_and_decode(alpha, window, G, min_rounds,
                                              quantize_v, tables, bs, D, Sq):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors (integer observables exact, out within 1e-5: expf and the
    summation order differ), and each real query against the decode
    kernel at its position (exact: the same float operations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if tables == "reference":
        k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
            3, G, hot_heads=(0,))
    else:
        k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _draft_inputs(
            3, G, bs=bs, D=D, Sq=Sq)
    args = tuple(torch.as_tensor(np.array(a), device="cuda")
                 for a in (q, kq, v, table, lengths, q_pos, k_amax, v_amax))
    cfg = TConfig(alpha=alpha, min_rounds=min_rounds, quantize_v=quantize_v)
    before = pv.LAUNCHES
    ker = pv.paged_bitstopper_verify(*args, cfg=cfg, window=window)
    torch.cuda.synchronize()
    assert pv.LAUNCHES == before + 1
    ref = pv.paged_bitstopper_verify_plain(*args, cfg=cfg, window=window)
    for field in ("rounds", "survivors", "v_fetched"):
        assert torch.equal(getattr(ker, field), getattr(ref, field)), field
    assert float((ker.out - ref.out).abs().max()) <= 1e-5
    for s in range(q.shape[1]):
        dec = pd.paged_bitstopper_decode(
            args[0][:, s], *args[1:4], args[4][:, s].contiguous(),
            args[5][:, s].contiguous(), *args[6:], cfg=cfg, window=window)
        real = args[4][:, s] > 0
        assert torch.equal(dec.out[real], ker.out[:, s][real])
        assert torch.equal(dec.rounds[real], ker.rounds[:, s][real])
        assert torch.equal(dec.survivors[real], ker.survivors[:, s][real])
        assert torch.equal(dec.v_fetched[real], ker.v_fetched[:, s][real])
    lean = pv.paged_bitstopper_verify(*args, cfg=cfg, window=window,
                                      stats=False)
    assert torch.equal(lean.rounds, ker.rounds)
    assert torch.equal(lean.out, ker.out)


def _block_pages(lengths, q_pos, bs, MB, G, window):
    """Per (slot, query group) block of the kernel: the pages some query of
    the group reaches (groups of max(1, 4 // G) queries)."""
    QG = max(1, 4 // G)
    pages = []
    for b in range(lengths.shape[0]):
        for s0 in range(0, lengths.shape[1], QG):
            reach = set()
            for s in range(s0, min(s0 + QG, lengths.shape[1])):
                qp, n = int(q_pos[b, s]), int(lengths[b, s])
                lo = max(0, qp - window + 1) if window is not None else 0
                hi = min(qp, n - 1)
                if hi >= lo:
                    reach |= set(range(lo // bs, min(hi // bs, MB - 1) + 1))
            pages.append((b, s0, QG, sorted(reach)))
    return pages


@pytest.mark.gpu
@pytest.mark.parametrize("G,window,bs,Sq", [(1, None, 16, 5), (2, 20, 16, 3),
                                            (1, None, 64, 5),
                                            (1, None, 512, 5)])
def test_cuda_kernel_copies_reachable_planes(G, window, bs, Sq):
    """On the card: the kernel's own count of the bytes it requested is
    every plane of every page some query of a block reaches, once per
    (slot, KV head, query group) block, and V only of the (block, page)
    pairs where some row of the block has a survivor; a launch without
    stats adds nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _draft_inputs(
        7, G, bs=bs, Sq=Sq)
    args = tuple(torch.as_tensor(np.array(a), device="cuda")
                 for a in (q, kq, v, table, lengths, q_pos, k_amax, v_amax))
    cfg = TConfig(alpha=0.4)
    pv.copied_bytes()
    res = pv.paged_bitstopper_verify(*args, cfg=cfg, window=window)
    pv.paged_bitstopper_verify(*args, cfg=cfg, window=window, stats=False)
    planes, v_bytes = pv.copied_bytes()
    P, bits, bs8, Hkv, D = kq.shape
    MB = table.shape[1]
    blocks = _block_pages(lengths, q_pos, bs, MB, G, window)
    assert planes == sum(len(p) for *_, p in blocks) * Hkv * bits * bs8 * D
    B, _, Hq, _ = q.shape
    sv = res.survivors.reshape(B, Sq, Hkv, G, MB, bs).any(5).any(3).cpu()
    live = sum(int(sv[b, s0:s0 + QG, :, pages].any(0).sum())
               for b, s0, QG, pages in blocks)
    assert 0 < live < sum(len(p) for *_, p in blocks) * Hkv
    assert v_bytes == live * bs * v.shape[-1] * 4
