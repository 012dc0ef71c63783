"""Serving with bf16 KV caches (``ServeConfig.cache_dtype="bfloat16"``) in
the port held against the reference's bf16 engines on the CPU: reduced
stablelm-1.6b with the reference's weights carried across, on
tests/test_serving.py's traces and geometry (max_len 64, two slots,
prefill_bucket 8, pages of 8).

``PagedEngine`` on ``xla`` and on ``bitstopper_xla`` (the fused decode
through the kernels' plain versions, beside the reference's interpreted
kernel; the plain oracle), speculative n-gram decoding,
``ContinuousBatchingEngine`` and ``StaticBucketEngine``, greedy and sampled
at 0.7: tokens and counters must equal the reference's, and so must
``kv_bytes_resident()``, ``kv_bytes_contiguous_equiv()`` and
``memory_report()``, which count 2-byte K/V values."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JContinuous
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import StaticBucketEngine as JStatic
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                 Request, ServeConfig, StaticBucketEngine)
from _torch_threads import one_thread  # noqa: F401

_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8,
             cache_dtype="bfloat16")
_LENS = (5, 11, 17, 9)


@pytest.fixture(scope="module")
def models():
    """{impl: (jcfg, tcfg, jparams, tparams)}; BitStopper at alpha 0.8 as
    tests/test_serving.py serves it."""
    out = {}
    for impl in ("xla", "bitstopper_xla"):
        jcfg = jreduced("stablelm-1.6b").replace(attn_impl=impl)
        tcfg = reduced_config("stablelm-1.6b").replace(attn_impl=impl)
        if impl != "xla":
            jcfg = jcfg.replace(bitstopper=JConfig(alpha=0.8))
            tcfg = tcfg.replace(bitstopper=TConfig(alpha=0.8))
        jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg)
        out[impl] = (jcfg, tcfg, jparams, tparams)
    return out


def _prompts(lens=_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, L, dtype=np.int32) for L in lens]


def _engine(models, impl, pkg, kind, **kw):
    jcfg, tcfg, jparams, tparams = models[impl]
    kw = dict(_BASE, **kw)
    if kind == "paged":
        kw.setdefault("page_size", 8)
    engines = {"paged": (JEngine, PagedEngine),
               "continuous": (JContinuous, ContinuousBatchingEngine),
               "static": (JStatic, StaticBucketEngine)}[kind]
    if pkg == "ref":
        return engines[0](jcfg, jparams, JServe(**kw))
    return engines[1](tcfg, tparams, ServeConfig(**kw), device="cpu")


def _serve(models, impl, pkg, prompts, kind="paged", max_new=6, seed=0,
           **kw):
    """Serve ``prompts`` on one package; returns (engine, tokens)."""
    eng = _engine(models, impl, pkg, kind, **kw)
    R = JRequest if pkg == "ref" else Request
    reqs = [R(prompt=p.copy(), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, seed=seed)
    return eng, [r.generated for r in reqs]


_RUNS = {}        # _serve_both's results by argument (one module's worker)


def _serve_both(models, impl, kind="paged", lens=_LENS, max_new=6, seed=0,
                **kw):
    """The trace of random prompts of ``lens`` through both packages,
    served once per set of arguments; tokens must be equal.  Returns
    {pkg: (engine, tokens)}."""
    key = (impl, kind, lens, max_new, seed, tuple(sorted(kw.items())))
    if key in _RUNS:
        return _RUNS[key]
    out = {pkg: _serve(models, impl, pkg, _prompts(lens), kind, max_new,
                       seed, **kw) for pkg in ("ref", "port")}
    assert out["port"][1] == out["ref"][1]
    _RUNS[key] = out
    return out


# (impl, ServeConfig fields) of the paged cases
_PAGED = {
    "xla": ("xla", dict(temperature=0.0)),
    "xla_sampled": ("xla", dict(temperature=0.7)),
    "fused": ("bitstopper_xla", dict(fused_decode=True)),
    "fused_sampled": ("bitstopper_xla", dict(fused_decode=True,
                                             temperature=0.7)),
    "oracle": ("bitstopper_xla", dict(fused_decode=False)),
}


@pytest.mark.parametrize("case", list(_PAGED))
def test_paged_engine_equals_reference(models, case):
    """The paged engine at bf16 serves the reference's tokens, greedy and
    sampled at 0.7, on ``xla`` and on BitStopper through the kernels' plain
    versions and through the oracle; counters and every byte report equal
    the reference's, and the K/V pools are bf16 (the scales f32)."""
    impl, kw = _PAGED[case]
    out = _serve_both(models, impl, seed=7 if "sampled" in case else 0,
                      **kw)
    (jeng, _), (teng, toks) = out["ref"], out["port"]
    assert all(len(t) == 6 for t in toks)
    assert teng.counters == jeng.counters
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()
    assert (teng.kv_bytes_resident(peak=False)
            == jeng.kv_bytes_resident(peak=False))
    assert teng.kv_bytes_contiguous_equiv() == jeng.kv_bytes_contiguous_equiv()
    assert teng.memory_report() == jeng.memory_report()
    layer = teng.caches["seg0"][0]["b0"]
    assert layer["k"].dtype == layer["v"].dtype == torch.bfloat16
    if impl != "xla":
        assert layer["k_amax"].dtype == torch.float32
        assert ("kq" in layer) is kw["fused_decode"]
    assert teng.pool.live_blocks() == 0


def test_bf16_halves_the_kv_bytes(models):
    """At bf16 the K/V rows cost half the f32 bytes a token; the plane pool
    and the scales keep theirs (the engine's reports, as the reference's
    count them)."""
    jcfg, tcfg, _, tparams = models["bitstopper_xla"]
    got = {}
    for dtype in ("float32", "bfloat16"):
        eng = PagedEngine(tcfg, tparams, ServeConfig(
            **dict(_BASE, cache_dtype=dtype, page_size=8,
                   fused_decode=True)), device="cpu")
        eng.pool.peak_live_blocks = 5
        got[dtype] = (eng.kv_bytes_resident(), eng.kv_bytes_contiguous_equiv())
    n_layers, hkv, d = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    kv32 = 5 * 8 * n_layers * 2 * hkv * d * 4
    assert got["float32"][0] - got["bfloat16"][0] == kv32 // 2
    assert got["float32"][1] == 2 * got["bfloat16"][1]


class _ReplayDrafter:
    """Drafts the tokens a recorded plain run generated after the same
    context (a perfect draft model of the greedy target), so that every
    tick verifies drafts."""

    def __init__(self, prompts, tokens):
        self.runs = [(np.asarray(p), list(t)) for p, t in zip(prompts,
                                                                tokens)]

    def propose(self, context, k):
        for prompt, gen in self.runs:
            n = len(context) - len(prompt)
            if (0 < n <= len(gen)
                    and np.array_equal(context[:len(prompt)], prompt)
                    and list(context[len(prompt):]) == gen[:n]):
                return gen[n:n + k]
        return []


@pytest.mark.parametrize("drafter", ["ngram", "replay"])
def test_speculative_equals_reference(models, drafter):
    """Speculative decoding over a bf16 pool (the verify through the plain
    version of the verify kernel): the n-gram drafter on a random prompt
    and one that repeats a pattern (tests/test_torch_speculative.py's),
    and drafts replayed from the plain run, which verify on every tick:
    the reference's tokens and speculation counters, and plain greedy's
    tokens."""
    prompts = [_prompts((12,))[0], np.tile(_prompts((4,), seed=7)[0], 5)]
    key = ("plain", "speculative")
    if key not in _RUNS:
        _RUNS[key] = _serve(models, "bitstopper_xla", "port", prompts,
                            max_new=10, fused_decode=True)[1]
    plain = _RUNS[key]
    kw = dict(fused_decode=True, speculative="ngram", draft_k=3)
    out = {}
    for pkg in ("ref", "port"):
        eng = _engine(models, "bitstopper_xla", pkg, "paged", **kw)
        if drafter == "replay":
            eng._drafter = _ReplayDrafter(prompts, plain)
        R = JRequest if pkg == "ref" else Request
        reqs = [R(prompt=p.copy(), max_new_tokens=10) for p in prompts]
        eng.generate(reqs, seed=0)
        out[pkg] = (eng, [r.generated for r in reqs])
    (jeng, jtok), (teng, toks) = out["ref"], out["port"]
    assert toks == jtok == plain
    assert teng.counters == jeng.counters
    if drafter == "replay":
        assert teng.counters["spec_ticks"] > 0
        assert teng.counters["spec_accepted"] > 0


@pytest.mark.parametrize("impl", ["xla", "bitstopper_xla"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_continuous_engine_equals_reference(models, impl, temperature):
    """``ContinuousBatchingEngine`` over bf16 per-slot caches: the
    reference's tokens and counters and its resident bytes, half the f32
    cache's; on ``xla`` its tokens equal the paged engine's."""
    seed = 7 if temperature else 0          # the paged cases' seeds
    out = _serve_both(models, impl, "continuous", seed=seed,
                      temperature=temperature)
    (jeng, _), (teng, toks) = out["ref"], out["port"]
    assert teng.counters == jeng.counters
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()
    layer = teng.caches["seg0"][0]["b0"]
    assert layer["k"].dtype == torch.bfloat16
    if impl == "xla":
        paged = _serve_both(models, impl, seed=seed, temperature=temperature)
        assert toks == paged["port"][1]


@pytest.mark.parametrize("impl", ["xla", "bitstopper_xla"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_static_engine_equals_reference(models, impl, temperature):
    """``StaticBucketEngine`` on bf16 shared-cursor caches (two prompts of
    one length share a batch): the reference's tokens."""
    _serve_both(models, impl, "static", lens=(9, 9, 13), max_new=5, seed=3,
                temperature=temperature)
