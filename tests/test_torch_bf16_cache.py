"""bf16 KV caches (``ServeConfig.cache_dtype="bfloat16"``) of the port held
against the reference's on the CPU, below the engines: the cache leaves
after each write in every layout, the bf16 arithmetic of the score paths
that read a bf16 view, the plain versions of the paged kernels over a bf16
V pool, the block-row transport and the prefix store's records.

On equal f32 inputs the bf16 K/V bits must equal the reference's, and
``kq``, ``k_amax``, ``v_amax``, ``pos``, lengths and block tables too.
Where each package projects K/V itself, its f32 K can round to bf16 apart
at a boundary: there K/V agree within one bf16 ulp (``BF16_ULP``) and the
integer leaves exactly.  numpy has no bf16: the port's host arrays carry a
bf16 tensor as its bits (uint16), the reference's as ml_dtypes arrays,
compared here through ``view(np.uint16)``."""

import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import besf as JB
from repro.core import block_adaptation as JBA
from repro.core import quantization as jq
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import attention as JA
from repro_torch.checkpoint import store as tstore
from repro_torch.core import block_adaptation as TBA
from repro_torch.core import quantization as tq
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.core.besf import besf_attention as t_besf_attention
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_verify as pv
from repro_torch.models import attention as TA
from _torch_threads import one_thread  # noqa: F401

BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative to the value's magnitude
OUT_TOL = 2e-5            # outputs of f32 arithmetic in two frameworks
S = JA.POS_SENTINEL
BF = jnp.bfloat16


def _bits(x):
    """bf16 bits (uint16) of a port tensor or a reference array; any other
    leaf as a host array."""
    if isinstance(x, torch.Tensor):
        return TA.host_array(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same_leaves(tcache, jcache, ulp=False):
    """Every leaf equal (bf16 through its bits); with ``ulp``, K/V within
    one bf16 ulp instead."""
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        got, want = _bits(tcache[key]), _bits(jcache[key])
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if ulp and key in ("k", "v"):
            g, w = TA.host_f32(got), TA.host_f32(want)
            np.testing.assert_array_less(
                np.abs(g - w), BF16_ULP * np.maximum(abs(g), abs(w)) + 1e-30,
                err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------


def _paged_pair(fused, layout=(6, 8, 3), table=((1, 2, 3), (4, 5, 0))):
    kw = dict(d_model=16, n_heads=2, n_kv_heads=2, head_dim=8,
              impl="bitstopper_xla", fused_decode=fused)
    jcache = JA.init_cache(JA.AttnConfig(**kw), batch=2, max_len=64,
                           dtype=BF, paged=JA.PagedLayout(*layout))
    tcache = TA.init_cache(TA.AttnConfig(**kw), 2, dtype=torch.bfloat16,
                           paged=TA.PagedLayout(*layout))
    jcache = dict(jcache, table=jnp.asarray(table, jnp.int32))
    tcache = dict(tcache, table=_t(np.asarray(table, np.int32)))
    return jcache, tcache


@pytest.mark.parametrize("fused", [True, False])
def test_paged_cache_writes_equal_reference(fused):
    """tests/test_torch_model.py's write sequence on a bf16 pool (a
    mid-page prefill, an idle row, a page-crossing append, a write that
    grows the scales and requantizes the plane pool from the bf16 K pool,
    writes that do not, one past the table): every leaf after each write
    equals the reference's, K and V bit for bit; the scales and planes come
    from the bf16-rounded K/V, and ``k_amax``/``v_amax`` stay f32."""
    jcache, tcache = _paged_pair(fused)
    assert tcache["k"].dtype == tcache["v"].dtype == torch.bfloat16
    assert tcache["k_amax"].dtype == torch.float32
    rng = np.random.default_rng(0)
    writes = [(5, np.stack([np.arange(5), np.full(5, S)]), 1.0),
              (6, np.stack([np.arange(5, 11),
                            np.concatenate([np.arange(3), [S] * 3])]), 0.5),
              (1, np.asarray([[11], [3]]), 20.0),
              (1, np.asarray([[12], [4]]), 0.1),
              (2, np.asarray([[13, 14], [S, S]]), 0.3),
              (1, np.asarray([[40], [5]]), 0.2)]
    grew = []
    for n, pos, scale in writes:
        k = (rng.normal(size=(2, n, 2, 8)) * scale).astype(np.float32)
        v = (rng.normal(size=(2, n, 2, 8)) * scale).astype(np.float32)
        before = np.asarray(jcache["k_amax"]).copy()
        jcache = JA._update_paged_cache(jcache, jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(pos))
        tcache = TA._update_paged_cache(tcache, _t(k), _t(v), _t(pos))
        _same_leaves(tcache, jcache)
        grew.append(bool((np.asarray(jcache["k_amax"]) > before).any()))
    assert grew[2] and not all(grew)
    # The scales are those of the bf16-rounded rows, not of the f32 input.
    assert float(tcache["k_amax"].max()) != float(
        np.abs(k).max() * np.float32(1.25))
    for got, want in zip(TA.gather_paged_view(tcache, torch.tensor([True,
                                                                   False])),
                         JA.gather_paged_view(jcache, jnp.asarray([True,
                                                                  False]))):
        np.testing.assert_array_equal(_bits(got), _bits(want))


_WRITES = {
    "per_slot": (None, False, True, [
        np.array([[0, 1, 2, 3, 4, S], [0, 1, 2, S, S, S]]),
        np.array([[5], [3]]), np.array([[6], [4]])]),
    "shared": (None, False, False, [np.arange(5), np.array([5]),
                                    np.array([6])]),
    "ring_shared": (4, True, False, [np.arange(3), np.array([3]),
                                     np.array([4]), np.array([5])]),
    "ring_per_slot": (4, True, True, [
        np.array([[0, 1, 2], [0, 1, S]]), np.array([[3], [2]]),
        np.array([[4], [3]]), np.array([[5], [4]])]),
}


def _attn(window=None, impl="xla", alpha=0.6):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              window=window, impl=impl)
    return (JA.AttnConfig(**kw, bitstopper=JConfig(alpha=alpha)),
            TA.AttnConfig(**kw, bitstopper=TConfig(alpha=alpha)))


@pytest.mark.parametrize("case", list(_WRITES))
def test_contiguous_cache_writes_equal_reference(case):
    """The per-slot scatter, the shared cursor and both ring buffers at
    bf16: every leaf after each write equals the reference's, K/V bit for
    bit, and the views the write returns too."""
    window, ring, per_slot, writes = _WRITES[case]
    jc, tc = _attn(window)
    jcache = JA.init_cache(jc, 2, 16, BF, ring=ring, per_slot=per_slot)
    tcache = TA.init_cache(tc, 2, 16, torch.bfloat16, ring=ring,
                           per_slot=per_slot)
    _same_leaves(tcache, jcache)
    rng = np.random.default_rng(3)
    for pos in writes:
        n = pos.shape[-1]
        k = rng.normal(size=(2, n, 2, 8)).astype(np.float32)
        v = rng.normal(size=(2, n, 2, 8)).astype(np.float32)
        jout = JA._update_cache(jcache, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos, jnp.int32))
        tout = TA._update_cache(tcache, _t(k), _t(v),
                                torch.as_tensor(pos, dtype=torch.int32))
        jcache, tcache = jout[3], tout[3]
        _same_leaves(tcache, jcache)
        for t, j in zip(tout[:3], jout[:3]):
            np.testing.assert_array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------------------
# the score paths over a bf16 view
# ---------------------------------------------------------------------------


def test_quantize_follows_the_input_dtype():
    """The reference's ``quantize`` computes in its input's dtype: a bf16
    tensor gets a bf16 scale and bf16 quotients (12-bit values round to
    bf16's 8 significant bits, the max even to 2048).  The port's gives the
    same integers and scale, per tensor and per slice; f32 is unchanged."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 16, 8)) * 3).astype(np.float32)
    xb = jnp.asarray(x).astype(BF)
    tb = _t(x).to(torch.bfloat16)
    jint, jp = jq.quantize(xb, 12)
    tint, tscale = tq.quantize(tb, 12)
    np.testing.assert_array_equal(tint.numpy(), np.asarray(jint))
    assert float(tscale) == float(jp.scale)
    assert int(tint.abs().max()) == 2048          # bf16's 2047
    for n in range(3):
        jint, jp = jq.quantize(xb[n], 12)
        tint, tscale = tq.quantize(tb, 12, dims=(1, 2))
        np.testing.assert_array_equal(tint[n].numpy(), np.asarray(jint))
        assert float(tscale.reshape(-1)[n]) == float(jp.scale)
    jint, jp = jq.quantize(jnp.asarray(x), 12)
    tint, tscale = tq.quantize(_t(x), 12)
    np.testing.assert_array_equal(tint.numpy(), np.asarray(jint))
    assert float(tscale) == float(jp.scale)


@pytest.mark.parametrize("quantize_v", [True, False])
def test_block_and_token_besf_over_bf16_equal_reference(quantize_v):
    """Block BitStopper (prefill chunks and the shared-cursor branch) and
    the per-token BESF (the contiguous engine's decode) over bf16 K/V:
    rounds, block verdicts and survivors equal the reference's, the output
    within ``OUT_TOL``."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 16, 8)).astype(np.float32)
    k = rng.normal(size=(2, 32, 8)).astype(np.float32)
    k[:, ::5] *= 4.0
    v = rng.normal(size=(2, 32, 8)).astype(np.float32)
    mask = np.tril(np.ones((16, 32), bool), 16)
    jc = JConfig(alpha=0.6, quantize_v=quantize_v)
    tc = TConfig(alpha=0.6, quantize_v=quantize_v)
    kb, vb = jnp.asarray(k).astype(BF), jnp.asarray(v).astype(BF)
    tkb, tvb = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    want = JBA.block_bitstopper_attention(jnp.asarray(q), kb, vb, cfg=jc,
                                          block_q=8, block_k=8,
                                          mask=jnp.asarray(mask))
    got = TBA.block_bitstopper_attention(_t(q), tkb, tvb, cfg=tc, block_q=8,
                                         block_k=8, mask=_t(mask))
    for g, w in zip(got.stats, want.stats):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=OUT_TOL, atol=OUT_TOL)
    want = JB.besf_attention(jnp.asarray(q), kb, vb, cfg=jc,
                             mask=jnp.asarray(mask))
    got = t_besf_attention(_t(q), tkb, tvb, cfg=tc, mask=_t(mask))
    np.testing.assert_array_equal(got.stats.survivors.numpy(),
                                  np.asarray(want.stats.survivors))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=OUT_TOL, atol=OUT_TOL)


def _params(rng):
    p = {name: {"w": rng.normal(size=shape).astype(np.float32) * 0.3}
         for name, shape in (("wq", (32, 4, 8)), ("wk", (32, 2, 8)),
                             ("wv", (32, 2, 8)), ("wo", (32, 32)))}
    return jax.tree.map(jnp.asarray, p), jax.tree.map(torch.as_tensor, p)


@pytest.mark.parametrize("impl", ["xla", "bitstopper_xla"])
@pytest.mark.parametrize("layout", ["shared", "per_slot", "ring", "paged"])
def test_attention_layer_over_bf16_cache_equals_reference(impl, layout):
    """``attention()`` over a bf16 cache, a prefill block then two decode
    steps, in every layout (the paged decode through the reference's
    oracle and the port's plain kernel version): the dense path's
    mixed-dtype arithmetic (f32 logits from widened K, softmax weights
    rounded to bf16 before P x V, an f32 sum) and every BitStopper branch
    give the reference's output within ``OUT_TOL``; K/V within one bf16
    ulp (each package projects its own), the other leaves exactly."""
    window = 6 if layout == "ring" else None
    jc, tc = _attn(window, impl)
    jp, tp = _params(np.random.default_rng(11))
    rng = np.random.default_rng(12)
    if layout == "paged":
        kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, impl=impl,
                  fused_decode=impl != "xla")
        jc = JA.AttnConfig(**kw, bitstopper=JConfig(alpha=0.6))
        tc = TA.AttnConfig(**kw, bitstopper=TConfig(alpha=0.6))
        jcache = JA.init_cache(jc, 2, 32, BF, paged=JA.PagedLayout(6, 8, 3))
        tcache = TA.init_cache(tc, 2, dtype=torch.bfloat16,
                               paged=TA.PagedLayout(6, 8, 3))
        table = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
        jcache = dict(jcache, table=jnp.asarray(table))
        tcache = dict(tcache, table=_t(table))
        # row 0's prefill chunk, then row 1's (the other row at the
        # sentinel), then two decode ticks of both rows
        steps = [np.array([list(range(10)), [S] * 10]),
                 np.array([[S] * 9, list(range(9))]),
                 np.array([[10], [9]]), np.array([[11], [10]])]
    else:
        per_slot = layout == "per_slot"
        jcache = JA.init_cache(jc, 2, 16, BF, ring=layout == "ring",
                               per_slot=per_slot)
        tcache = TA.init_cache(tc, 2, 16, torch.bfloat16,
                               ring=layout == "ring", per_slot=per_slot)
        if per_slot:
            steps = [np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                               [0, 1, 2, 3, 4, S, S, S]]),
                     np.array([[8], [5]]), np.array([[9], [6]])]
        elif layout == "ring":
            steps = [np.arange(5), np.array([5]), np.array([6]),
                     np.array([7])]
        else:
            steps = [np.arange(8), np.array([8]), np.array([9])]
    for pos in steps:
        x = rng.normal(size=(2, pos.shape[-1], 32)).astype(np.float32)
        jy, jcache = JA.attention(jp, jnp.asarray(x),
                                  jnp.asarray(pos, jnp.int32), jc, jcache)
        ty, tcache = TA.attention(tp, _t(x),
                                  torch.as_tensor(pos, dtype=torch.int32),
                                  tc, tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=OUT_TOL, atol=OUT_TOL)
        _same_leaves(tcache, jcache, ulp=True)


def test_dense_weights_round_to_the_cache_dtype():
    """The dense softmax's weights round to bf16 before P x V: an output
    that the f32 weights would not give (held against both roundings)."""
    rng = np.random.default_rng(2)
    _, tc = _attn()
    q = _t(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    k = _t(rng.normal(size=(1, 16, 2, 8)).astype(np.float32)).bfloat16()
    v = _t(rng.normal(size=(1, 16, 2, 8)).astype(np.float32)).bfloat16()
    pos = torch.arange(16, dtype=torch.int32)
    out = TA._cached_attention(q, k, v, torch.tensor([15]), pos, tc)
    logits = torch.einsum("bqhgd,bthd->bhgqt", q.reshape(1, 1, 2, 2, 8),
                          k.float()) / torch.tensor(8 ** 0.5)
    p = torch.softmax(logits, -1)
    ref = {}
    for name, w in (("bf16", p.bfloat16().float()), ("f32", p)):
        ref[name] = torch.einsum("bhgqt,bthd->bqhgd", w,
                                 v.float()).reshape(out.shape)
    assert torch.equal(out, ref["bf16"])
    assert not torch.equal(out, ref["f32"])


# ---------------------------------------------------------------------------
# the paged kernels' plain versions over a bf16 V pool
# ---------------------------------------------------------------------------


def _decode_operands(Sq=1, seed=4):
    rng = np.random.default_rng(seed)
    P, bs, Hkv, D, B, Hq, MB = 9, 16, 2, 16, 2, 4, 4
    k = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    k[:, ::3] *= 3.0
    v = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32) * 2.5
    kb = jnp.asarray(k).astype(BF)
    vb = jnp.asarray(v).astype(BF)
    k_amax = np.abs(np.asarray(kb.astype(jnp.float32))).max((0, 1, 3)) * 1.25
    v_amax = np.abs(np.asarray(vb.astype(jnp.float32))).max((0, 1, 3)) * 1.25
    table = np.array([[3, 1, 7, 0], [5, 2, 0, 0]], np.int32)
    lengths = np.array([3 * bs + 5, bs + 9], np.int32)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    q_pos = (lengths[:, None] - Sq + np.arange(Sq)[None]).astype(np.int32)
    return (q, kb, vb, table, q_pos + 1, q_pos, k_amax.astype(np.float32),
            v_amax.astype(np.float32))


@pytest.mark.parametrize("Sq", [1, 3])
def test_plain_paged_kernels_take_bf16_v(Sq):
    """The plain versions of the decode and verify kernels over a packed
    plane pool and a bf16 V pool give the reference oracle's rounds,
    survivors and V fetches on the bf16 pools exactly, and its output
    within ``OUT_TOL`` (both widen V with an exact cast); the kernels'
    operand check takes the bf16 pool and refuses f16 and widths that are
    not whole 16-byte pieces of bf16."""
    q, kb, vb, table, lengths, q_pos, k_amax, v_amax = _decode_operands(Sq)
    cfg = TConfig(alpha=0.6)
    tk = TA.tensor_from_host(np.asarray(kb))
    tv = TA.tensor_from_host(np.asarray(vb))
    assert tv.dtype == torch.bfloat16
    kq = tq.pack_pool_planes(tk, _t(k_amax), 12)
    if Sq == 1:
        want = JB.besf_attention_decode_paged(
            jnp.asarray(q[:, 0]), kb, vb, jnp.asarray(table),
            jnp.asarray(lengths[:, 0]), jnp.asarray(q_pos[:, 0]),
            jnp.asarray(k_amax), jnp.asarray(v_amax), cfg=JConfig(alpha=0.6))
        args = (_t(q[:, 0]), kq, tv, _t(table), _t(lengths[:, 0]),
                _t(q_pos[:, 0]), _t(k_amax), _t(v_amax))
        got = pd.paged_bitstopper_decode(*args, cfg=cfg)
    else:
        want = JB.besf_attention_verify_paged(
            jnp.asarray(q), kb, vb, jnp.asarray(table), jnp.asarray(lengths),
            jnp.asarray(q_pos), jnp.asarray(k_amax), jnp.asarray(v_amax),
            cfg=JConfig(alpha=0.6))
        args = (_t(q), kq, tv, _t(table), _t(lengths), _t(q_pos),
                _t(k_amax), _t(v_amax))
        got = pv.paged_bitstopper_verify(*args, cfg=cfg)
    for key in ("rounds", "survivors", "v_fetched"):
        np.testing.assert_array_equal(
            getattr(got, key).numpy(),
            np.asarray(getattr(want, key)).reshape(getattr(got, key).shape),
            err_msg=key)
    assert got.v_fetched.any()
    np.testing.assert_allclose(got.out.numpy(),
                               np.asarray(want.out).reshape(got.out.shape),
                               rtol=OUT_TOL, atol=OUT_TOL)
    if Sq == 1:
        pd.check_kernel_operands(*args[:6], cfg)
        with pytest.raises(TypeError, match="f32 or bf16"):
            pd.check_kernel_operands(args[0], kq, tv.half(), *args[3:6],
                                     cfg)
    assert pd.kernel_refusal(16, 64, 60, 12) is None
    assert "multiple of 8" in pd.kernel_refusal(16, 64, 60, 12,
                                                torch.bfloat16)


# ---------------------------------------------------------------------------
# block-row transport and the prefix store
# ---------------------------------------------------------------------------


def test_block_row_transport_carries_bf16_bits():
    """``extract_block_rows`` gives a bf16 pool's rows as their bits, equal
    to the reference's record (viewed as uint16) and half an f32 record's
    bytes; ``splice_block_rows`` takes the port's bits, the reference's
    ml_dtypes arrays and a stored record's void arrays alike;
    ``apply_inject_amax_rule`` widens the bits exactly and grows the
    scales as the reference's does."""
    jcache, tcache = _paged_pair(True)
    rng = np.random.default_rng(7)
    k = rng.normal(size=(2, 10, 2, 8)).astype(np.float32)
    pos = np.stack([np.arange(10), np.arange(10)])
    jcache = JA._update_paged_cache(jcache, jnp.asarray(k), jnp.asarray(k),
                                    jnp.asarray(pos))
    tcache = TA._update_paged_cache(tcache, _t(k), _t(k), _t(pos))
    jtree = {"seg0": {"b0": jcache}}
    ttree = {"seg0": [{"b0": tcache}]}
    want = JA.extract_block_rows(jtree, [4, 1], planes=True)
    got = TA.extract_block_rows(ttree, [4, 1], planes=True)
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], _bits(want[0][key]))
    assert got[0]["k"].dtype == np.uint16
    assert got[0]["k"].nbytes == np.asarray(want[0]["k"]).nbytes
    np.testing.assert_array_equal(
        TA.host_f32(got[0]["v"]),
        np.asarray(want[0]["v"]).astype(np.float32))
    # Splice block 4's rows into block 2 from each of the three forms.
    void = {f: (a.view("V2") if a.dtype == np.uint16 else a)
            for f, a in got[0].items()}
    jsp = JA.splice_block_rows(jtree, [2], want, sel=[0])
    for rows in (got, want, [void]):
        _, c2 = _paged_pair(True)
        c2.update({f: tcache[f].clone() for f in tcache})
        TA.splice_block_rows({"seg0": [{"b0": c2}]}, [2], rows, sel=[0])
        _same_leaves(c2, jsp["seg0"]["b0"])
    big = [{f: (TA.host_array(TA.tensor_from_host(a).float().mul(3.0)
                              .bfloat16()) if f in ("k", "v") else a)
            for f, a in got[0].items()}]
    jbig = [{f: (np.asarray(jnp.asarray(a).astype(jnp.float32) * 3.0)
                 .astype(ml_dtypes.bfloat16) if f in ("k", "v") else a)
             for f, a in want[0].items()}]
    groups = [[(0, 0, 8)], [(1, 0, 2)]]
    jtree, jgrew = JA.apply_inject_amax_rule(jtree, jbig, groups)
    _, tgrew = TA.apply_inject_amax_rule(ttree, big, groups)
    assert jgrew is tgrew is True
    for key in ("k_amax", "v_amax"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jtree["seg0"]["b0"][key]))


def test_prefix_record_bytes_equal_reference(tmp_path):
    """A bf16 prefix record written by the port holds the reference's
    bytes: the same ``record.npz`` members (bf16 fields as raw 2-byte values
    under ``<V2``), the same file size.  Either package's record loads in
    the port with its K/V as uint16 bits; the reference's own loader gives
    the void type back (its ``astype`` then refuses it: ROADMAP C7)."""
    rng = np.random.default_rng(8)
    kb = rng.normal(size=(2, 1, 8, 4, 16)).astype(ml_dtypes.bfloat16)
    vb = rng.normal(size=(2, 1, 8, 4, 16)).astype(ml_dtypes.bfloat16)
    pos = rng.integers(0, 64, (2, 1, 8)).astype(np.int32)
    chain = list(range(8))
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jstore.save_prefix_record(jdir, chain, [{"k": kb, "v": vb, "pos": pos}])
    tstore.save_prefix_record(tdir, chain, [{"k": kb.view(np.uint16),
                                             "v": vb.view(np.uint16),
                                             "pos": pos}])
    name = tstore.prefix_record_name(chain)
    paths = [os.path.join(d, name, "record.npz") for d in (jdir, tdir)]
    zips = [zipfile.ZipFile(p) for p in paths]
    assert zips[0].namelist() == zips[1].namelist()
    for member in zips[0].namelist():
        assert zips[0].read(member) == zips[1].read(member), member
    assert os.path.getsize(paths[0]) == os.path.getsize(paths[1])
    assert (tstore.prefix_store_bytes(tdir)
            == jstore.prefix_store_bytes(jdir))
    for d in (jdir, tdir):
        rec = tstore.load_prefix_record(d, chain)[0]
        np.testing.assert_array_equal(rec["k"], kb.view(np.uint16))
        np.testing.assert_array_equal(rec["v"], vb.view(np.uint16))
        np.testing.assert_array_equal(rec["pos"], pos)
        assert jstore.load_prefix_record(d, chain)[0]["k"].dtype.kind == "V"
