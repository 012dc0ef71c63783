"""The port's paged engine on the dense ``xla`` impl held against the
reference on the CPU, and against the port's own contiguous engine.

Reduced stablelm-1.6b with the reference's weights carried across, on
tests/test_serving.py's traces and geometry (max_len 64, two slots,
prefill_bucket 8, page_size 8).  A dense pool carries no scales and no
planes: prefill chunks and decode ticks read each slot's gathered view
through the dense masked softmax, and a speculative tick verifies through
the same gather with no growth bailout.  Tokens, counters and
``kv_bytes_resident()`` must equal the reference's; the paged engine's
tokens must equal the contiguous engine's (tests/test_serving.py:181-203).
"""

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JContinuous
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                 Request, ServeConfig)

# tests/test_serving.py's geometry.
_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8)
_OS = dict(max_slots=3, page_size=8, pool_blocks=10, oversubscribe=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b")          # attn_impl="xla"
    tcfg = reduced_config("stablelm-1.6b")
    assert jcfg.attn_impl == tcfg.attn_impl == "xla"
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _reqs(pkg, lens, max_new=6, seed=0, vocab=256, prefix=None):
    R = JRequest if pkg == "ref" else Request
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        p = rng.integers(0, vocab, L, dtype=np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(R(prompt=p, max_new_tokens=max_new))
    return out


def _engine(model, pkg, kind="paged", **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(_BASE, **kw)
    if kind == "paged":
        kw.setdefault("page_size", 8)
        if pkg == "ref":
            return JEngine(jcfg, jparams, JServe(**kw))
        return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    if pkg == "ref":
        return JContinuous(jcfg, jparams, JServe(**kw))
    return ContinuousBatchingEngine(tcfg, tparams, ServeConfig(**kw),
                                    device="cpu")


def _both(model, lens, max_new=6, seed=0, req_seed=0, kind="paged",
          **kw):
    """The trace through both packages; returns {pkg: (engine, reqs)}."""
    out = {}
    for pkg in ("ref", "port"):
        eng = _engine(model, pkg, kind, **kw)
        reqs = _reqs(pkg, lens, max_new, req_seed)
        eng.generate(reqs, seed=seed)
        out[pkg] = (eng, reqs)
    (jeng, jreqs), (teng, treqs) = out["ref"], out["port"]
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.counters == jeng.counters
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()
    return out


def _tokens(out, pkg="port"):
    return [r.generated for r in out[pkg][1]]


@pytest.mark.parametrize("temperature,seed,lens,max_new", [
    (0.0, 0, (5, 11, 17, 9), 6), (1.0, 7, (5, 11, 17), 5)],
    ids=["greedy", "sampled"])
def test_paged_matches_contiguous_bitexact(model, temperature, seed, lens,
                                           max_new):
    """tests/test_serving.py:181 (greedy) and :194 (sampled at 1.0, seed
    7): the paged engine on ``xla`` serves the contiguous engine's tokens,
    in the port as in the reference, and both equal the reference's."""
    paged = _both(model, lens, max_new, seed, temperature=temperature)
    contiguous = _both(model, lens, max_new, seed, kind="continuous",
                       temperature=temperature)
    assert _tokens(paged) == _tokens(contiguous)
    assert paged["port"][0].kv_bytes_resident() < \
        contiguous["port"][0].kv_bytes_resident()
    assert paged["port"][0].kv_bytes_contiguous_equiv() == \
        contiguous["port"][0].kv_bytes_resident()


def test_paged_chunked_prefill_invariance(model):
    """tests/test_serving.py:225: the chunk size changes no token on the
    dense path, and a 37-token prompt takes ceil(37 / 8) chunks."""
    outs, chunks = [], []
    for chunk in (8, 16, 32):
        out = _both(model, (37,), max_new=4, prefill_chunk=chunk)
        outs.append(_tokens(out))
        chunks.append(out["port"][0].counters["prefill_chunks"])
    assert outs[0] == outs[1] == outs[2], outs
    assert chunks[0] == 5


def test_paged_recycled_blocks_no_stale_kv(model):
    """tests/test_serving.py:272: a request on recycled blocks reads none
    of the previous owner's rows; equal to a fresh engine's run and to the
    reference's."""
    kw = dict(max_slots=2, pool_blocks=5, prefix_sharing=False)
    for pkg in ("ref", "port"):
        eng = _engine(model, pkg, **kw)
        eng.generate(_reqs(pkg, (12, 9), max_new=4, seed=3), seed=0)
        assert eng.pool.alloc_count >= 4
        reused = _reqs(pkg, (11, 7), max_new=4, seed=4)
        eng.generate(reused, seed=0)
        if pkg == "ref":
            want = [r.generated for r in reused]
    fresh = _both(model, (11, 7), max_new=4, req_seed=4, **kw)
    assert [r.generated for r in reused] == want == _tokens(fresh)


def test_paged_prefix_sharing_bitident_and_saves_blocks(model):
    """tests/test_serving.py:311: a common system prompt, published once,
    then four requests: shared serving gives unshared serving's tokens, hits
    the prefix cache and keeps fewer blocks live, as in the reference."""
    sys_prompt = np.random.default_rng(42).integers(0, 256, 24,
                                                    dtype=np.int32)
    res = {}
    for pkg in ("ref", "port"):
        R = JRequest if pkg == "ref" else Request
        for sharing in (True, False):
            eng = _engine(model, pkg, prefix_sharing=sharing)
            eng.generate([R(prompt=sys_prompt.copy(), max_new_tokens=1)],
                         seed=0)
            eng.pool.peak_live_blocks = 0
            reqs = _reqs(pkg, (3, 7, 5, 9), max_new=4, seed=1,
                         prefix=sys_prompt)
            eng.generate(reqs, seed=0)
            res[pkg, sharing] = (eng, [r.generated for r in reqs])
    for pkg in ("ref", "port"):
        es, shared = res[pkg, True]
        eu, unshared = res[pkg, False]
        assert shared == unshared
        assert es.counters["prefix_hit_tokens"] >= 24 * 3
        assert es.pool.peak_live_blocks < eu.pool.peak_live_blocks
        assert es.pool.live_blocks() == 0
    for sharing in (True, False):
        (jeng, jt), (teng, tt) = res["ref", sharing], res["port", sharing]
        assert tt == jt and teng.counters == jeng.counters
        assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (1.0, 7)],
                         ids=["greedy", "sampled"])
def test_oversubscribed_preemption_bitident(model, temperature, seed):
    """tests/test_serving.py:484 and :503 on ``xla``: an oversubscribed
    pool preempts at least once and serves the uncontended run's tokens;
    tokens and counters equal the reference's."""
    want = _both(model, (12, 9, 11), max_new=16, seed=seed, max_slots=3,
                 temperature=temperature)
    got = _both(model, (12, 9, 11), max_new=16, seed=seed,
                temperature=temperature, **_OS)
    eng = got["port"][0]
    assert eng.counters["preemptions"] >= 1
    assert _tokens(got) == _tokens(want)
    assert eng.pool.available() == eng.pool.capacity
    assert (eng.table == 0).all()


def test_speculative_dense_verify_is_lossless(model):
    """Speculative serving on ``xla`` verifies through the gathered view
    with no scales, so no tick bails out on growth; a repeated-pattern
    trace gives the plain run's tokens, with the reference's counters."""
    pattern = np.tile(np.arange(7, dtype=np.int32) * 13 % 256, 4)
    out = {}
    for pkg in ("ref", "port"):
        R = JRequest if pkg == "ref" else Request
        for spec in ("off", "ngram"):
            eng = _engine(model, pkg, speculative=spec, draft_k=3)
            reqs = [R(prompt=pattern[:n].copy(), max_new_tokens=10)
                    for n in (12, 17)]
            eng.generate(reqs, seed=0)
            out[pkg, spec] = (eng.counters, [r.generated for r in reqs])
    for pkg in ("ref", "port"):
        assert out[pkg, "ngram"][1] == out[pkg, "off"][1]
    assert out["port", "ngram"] == out["ref", "ngram"]
    c = out["port", "ngram"][0]
    assert c["spec_ticks"] > 0 and c["spec_bailouts"] == 0
