"""The paper's baselines and traffic statistics held against the JAX
package on the CPU: the quantization helpers and ``LATSConfig``, the four
baseline attentions (dense INT12, Sanger, SOFA, TokenPicker; causal and
under an explicit mask) and every ``Complexity`` function in both
accounting modes.  Inputs are made with numpy from a seed.

Masks and fetch counters are held exactly and ``out`` within 1e-5, with one
exception, ROADMAP C12: SOFA's per-query top-k compares predictor scores
that the reference sums in f32 in XLA's order.  Its log-domain scores are
products of powers of two, so two keys often tie exactly, and the
reference's rounding decides such a tie at the top-k boundary one way or
the other.  The port rounds each exact score once (the same on every
device); where the two masks differ, the test requires an exact tie at the
row's boundary, and compares ``out`` on the other rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import lats as jlats
from repro.core import quantization as jq
from repro.core import stats as JS
from repro.core.besf import besf_attention as jbesf
from repro_torch.core import baselines as TB
from repro_torch.core import lats as tlats
from repro_torch.core import quantization as tq
from repro_torch.core import stats as TS
from repro_torch.core.besf import besf_attention as tbesf

B, H, S, D = 2, 4, 96, 32
OUT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, S, D)) * 2).astype(np.float32)
    k = (rng.normal(size=(B, H, S, D)) * 2).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v


def _mask(seed=1):
    return np.random.default_rng(seed).random((S, S)) < 0.7


def _t(a):
    return torch.as_tensor(np.array(a))


def test_quantization_helpers_match_reference():
    """QuantParams, plane_weights, dequantize, partial_value and
    quantize_and_pack: bit-equal to the reference's (``quantize_folded``
    to its ``quantize`` under ``jax.jit``, where XLA folds the division by
    qmax into a product)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 16)) * 3).astype(np.float32)
    for bits in (4, 8, 12):
        jv, js = jax.jit(lambda a: (lambda q, p: (q, p.scale))(
            *jq.quantize(a, bits)))(jnp.asarray(x))
        jp = jq.QuantParams(scale=js, bits=bits)
        tv, tp = tq.quantize_folded(_t(x), bits)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert float(tp.scale) == float(jp.scale)
        assert (tp.bits, tp.qmax, tp.qmin) == (jp.bits, jp.qmax, jp.qmin)
        np.testing.assert_array_equal(tq.dequantize(tv, tp).numpy(),
                                      np.asarray(jq.dequantize(jv, jp)))
        np.testing.assert_array_equal(tq.plane_weights(bits).numpy(),
                                      np.asarray(jq.plane_weights(bits)))
        planes = tq.to_bitplanes(tv, bits)
        for r in (0, bits // 2, bits - 1):
            np.testing.assert_array_equal(
                tq.partial_value(planes, r).numpy(),
                np.asarray(jq.partial_value(jnp.asarray(planes.numpy()), r)))
        jpk, js = jq.quantize_and_pack(jnp.asarray(x), bits)
        tpk, ts = tq.quantize_and_pack(_t(x), bits)
        np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
        assert float(ts) == float(js)
    assert dataclasses_equal(tlats.LATSConfig(), jlats.LATSConfig())
    assert dataclasses_equal(tlats.LATSConfig(alpha=0.2, radius=3.0, bits=8),
                             jlats.LATSConfig(alpha=0.2, radius=3.0, bits=8))


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


_METHODS = {
    "dense": ("dense_attention", ("mask",)),
    "sanger": ("sanger_attention", ("kept", "valid", "mask")),
    "sofa": ("sofa_attention", ("kept", "valid", "mask")),
    "tokenpicker": ("tokenpicker_attention",
                    ("kept", "valid", "chunks_fetched")),
}


def _run(mod, fn, q, k, v, causal, mask, conv):
    out, info = getattr(mod, fn)(conv(q), conv(k), conv(v), causal=causal,
                                 mask=None if mask is None else conv(mask))
    return np.asarray(out), {key: None if val is None else np.asarray(val)
                             for key, val in info.items()}


def _sofa_ties(q, k, mask, causal, k_ratio=0.25):
    """Per pair: whether its exact predictor score ties its row's top-k
    boundary (the reference's rounding may then decide either way)."""
    lq = [TB._log_quant(_t(x), 4).double().numpy() for x in (q, k)]
    exact = np.einsum("...qd,...kd->...qk", *lq) / D ** 0.5
    valid = np.ones((S, S), bool) if mask is None else mask.copy()
    if causal:
        valid &= np.tril(np.ones((S, S), bool))
    exact = np.where(valid, exact, -1e30)
    topk = max(int(k_ratio * S), 1)
    thresh = np.sort(exact, -1)[..., S - topk]
    scale = np.abs(np.where(valid, exact, 0)).max(-1)
    return np.abs(exact - thresh[..., None]) <= 1e-6 * scale[..., None]


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("method", list(_METHODS))
def test_baseline_matches_reference(method, causal, masked):
    """Masks and fetch counters exactly (SOFA: C12, exact ties at the top-k
    boundary only), ``out`` and the probabilities within 1e-5."""
    fn, int_keys = _METHODS[method]
    q, k, v = _qkv()
    mask = _mask() if masked else None
    jout, jinfo = _run(JB, fn, q, k, v, causal, mask, jnp.asarray)
    tout, tinfo = _run(TB, fn, q, k, v, causal, mask, _t)
    assert set(tinfo) == set(jinfo)
    rows = np.ones(jout.shape[:-1], bool)
    for key in int_keys:
        if jinfo[key] is None:
            assert tinfo[key] is None
            continue
        diff = tinfo[key] != jinfo[key]
        if method == "sofa" and key in ("kept", "mask") and diff.any():
            ties = _sofa_ties(q, k, mask, causal)
            assert (ties[diff]).all(), "SOFA masks differ off a tie"
            assert diff.any(-1).mean() < 0.01
            rows &= ~diff.any(-1)
            continue
        assert not diff.any(), key
    np.testing.assert_allclose(tout[rows], jout[rows], atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(tinfo["probs"][rows], jinfo["probs"][rows],
                               atol=OUT_TOL, rtol=0)


def _same(a, b):
    return (a.k_bytes, a.v_bytes, a.compute_bitmacs, a.total_bytes) == \
        (b.k_bytes, b.v_bytes, b.compute_bitmacs, b.total_bytes)


@pytest.mark.parametrize("mode", ["per_pair", "shared"])
def test_complexity_matches_reference(mode):
    """Every Complexity function on the same inputs (the port's tensors on
    one side, the reference's numpy on the other): equal floats; the
    normalized ratios too."""
    q, k, v = _qkv(5)
    jd = JS.dense_complexity(S, S, D, D)
    td = TS.dense_complexity(S, S, D, D)
    assert _same(td, jd)
    res = tbesf(_t(q), _t(k), _t(v), causal=True)
    jres = jbesf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    for key in ("planes_fetched", "survivors"):
        np.testing.assert_array_equal(
            getattr(res.stats, key).numpy(),
            np.asarray(getattr(jres.stats, key)))
    tb = TS.besf_complexity(res.stats.planes_fetched, res.stats.survivors,
                            D, D, mode=mode)
    jb = JS.besf_complexity(np.asarray(jres.stats.planes_fetched),
                            np.asarray(jres.stats.survivors), D, D,
                            mode=mode)
    assert _same(tb, jb)
    assert tb.normalized_to(td) == jb.normalized_to(jd)
    _, sanger = TB.sanger_attention(_t(q), _t(k), _t(v), causal=True)
    assert _same(
        TS.predictor_complexity(S, S, D, D, sanger["kept"], 4, mode=mode,
                                batch=B * H),
        JS.predictor_complexity(S, S, D, D, sanger["kept"].numpy(), 4,
                                mode=mode, batch=B * H))
    _, tp = TB.tokenpicker_attention(_t(q), _t(k), _t(v), causal=True)
    assert _same(
        TS.chunk_progressive_complexity(tp["chunks_fetched"], tp["kept"], D,
                                        D, mode=mode),
        JS.chunk_progressive_complexity(tp["chunks_fetched"].numpy(),
                                        tp["kept"].numpy(), D, D,
                                        mode=mode))
    rng = np.random.default_rng(6)
    rounds = rng.integers(0, 13, (B, H, 3, 3))
    alive = rounds > 4
    assert _same(
        TS.block_besf_complexity(_t(rounds), _t(alive), res.stats.survivors,
                                 32, 32, D, D),
        JS.block_besf_complexity(rounds, alive,
                                 res.stats.survivors.numpy(), 32, 32, D, D))
    with pytest.raises(ValueError):
        TS.besf_complexity(res.stats.planes_fetched, res.stats.survivors, D,
                           D, mode="other")
