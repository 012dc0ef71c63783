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


@pytest.mark.gpu
@pytest.mark.parametrize("alpha,window,G,min_rounds,quantize_v", [
    (0.2, None, 1, 1, True), (0.6, None, 2, 1, True), (0.8, 24, 2, 1, False),
    (1.0, 16, 1, 3, True), (0.4, None, 1, 1, True)])
def test_cuda_kernel_matches_plain_and_decode(alpha, window, G, min_rounds,
                                              quantize_v):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors (integer observables exact, out within 1e-5: expf and the
    summation order differ), and each real query against the decode
    kernel at its position (exact: the same float operations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, kq, v, table, lengths, q_pos, k_amax, v_amax, q = _inputs(
        3, G, hot_heads=(0,))
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
    lean = pv.paged_bitstopper_verify(*args, cfg=cfg, window=window,
                                      stats=False)
    assert torch.equal(lean.rounds, ker.rounds)
