"""The port's contiguous KV caches and the engines on them
(``ContinuousBatchingEngine``, ``StaticBucketEngine``) held against the
reference on the CPU.

Cache writes (``_update_cache``: per-slot scatter, shared cursor, ring
buffers of a ``local_attn`` layer) are compared leaf for leaf: integer
leaves (``pos``, ``length``) exactly, K and V within ``KV_RTOL``.  The
engines run reduced stablelm-1.6b with the reference's weights carried
across, on tests/test_serving.py's traces and geometry (max_len 64, two
slots, prefill_bucket 8): tokens, counters and ``kv_bytes_resident()``
must equal the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JContinuous
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import StaticBucketEngine as JStatic
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServeConfig, StaticBucketEngine)
from repro_torch.serving.sampling import categorical_block, fold_in, prng_key

KV_RTOL = 1e-6        # the same K/V rows written by both packages
PROJ_ATOL = 1e-6      # K/V projected by each package from the same inputs
S = JA.POS_SENTINEL

# tests/test_serving.py's geometry.
_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b")
    tcfg = reduced_config("stablelm-1.6b")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _cfgs(model, impl, alpha=None):
    jcfg, tcfg = model[:2]
    j = jcfg.replace(attn_impl=impl)
    t = tcfg.replace(attn_impl=impl)
    if alpha is not None:
        j = j.replace(bitstopper=JConfig(alpha=alpha))
        t = t.replace(bitstopper=TConfig(alpha=alpha))
    return j, t


def _reqs(pkg, vocab, lens, max_new=6, seed=0):
    """tests/test_serving.py's ``_reqs``."""
    R = JRequest if pkg == "ref" else Request
    rng = np.random.default_rng(seed)
    return [R(prompt=rng.integers(0, vocab, L, dtype=np.int32),
              max_new_tokens=max_new) for L in lens]


def _continuous(model, pkg, impl="xla", alpha=None, **kw):
    jcfg, tcfg = _cfgs(model, impl, alpha)
    kw = dict(_BASE, **kw)
    if pkg == "ref":
        return JContinuous(jcfg, model[2], JServe(**kw))
    return ContinuousBatchingEngine(tcfg, model[3], ServeConfig(**kw),
                                    device="cpu")


def _serve(model, lens, max_new=6, seed=0, impl="xla", alpha=None,
           prompt_seed=0, **kw):
    """The same trace through both packages' contiguous engines."""
    out = {}
    for pkg in ("ref", "port"):
        eng = _continuous(model, pkg, impl, alpha, **kw)
        reqs = _reqs(pkg, model[0].vocab, lens, max_new, prompt_seed)
        eng.generate(reqs, seed=seed)
        out[pkg] = (eng, reqs)
    return out


def _same_serve(out):
    (jeng, jreqs), (teng, treqs) = out["ref"], out["port"]
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.counters == jeng.counters
    assert [(r.prefill_len, r.admitted_step, r.finished_step)
            for r in treqs] == [(r.prefill_len, r.admitted_step,
                                 r.finished_step) for r in jreqs]
    assert teng.kv_bytes_resident() == jeng.kv_bytes_resident()


# ---------------------------------------------------------------------------
# cache layouts and writes
# ---------------------------------------------------------------------------


def _attn(window=None, impl="xla"):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              window=window, impl=impl)
    return (JA.AttnConfig(**kw, bitstopper=JConfig(alpha=0.6)),
            TA.AttnConfig(**kw, bitstopper=TConfig(alpha=0.6)))


def _same_leaves(tcache, jcache, atol=0.0):
    for key in jcache:
        got = tcache[key].numpy()
        want = np.asarray(jcache[key])
        assert got.shape == want.shape, key
        if key in ("k", "v"):
            np.testing.assert_allclose(got, want, rtol=KV_RTOL, atol=atol)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


# (window, ring, per_slot, writes: a list of position arrays)
_WRITES = {
    "per_slot": (None, False, True, [
        np.array([[0, 1, 2, 3, 4, S], [0, 1, 2, S, S, S]]),
        np.array([[5], [3]]), np.array([[6], [4]])]),
    "shared": (None, False, False, [np.arange(5), np.array([5]),
                                    np.array([6])]),
    "ring_shared": (4, True, False, [np.arange(3), np.array([3]),
                                     np.array([4]), np.array([5]),
                                     np.array([6])]),
    "ring_per_slot": (4, True, True, [
        np.array([[0, 1, 2], [0, 1, S]]), np.array([[3], [2]]),
        np.array([[4], [3]]), np.array([[5], [4]]), np.array([[6], [5]])]),
}


@pytest.mark.parametrize("case", list(_WRITES))
def test_update_cache_matches_reference(case):
    """Every leaf after each write: the per-slot scatter (pad tokens
    dropped, cursors apart), the shared cursor, and the ring buffers of a
    sliding-window layer (``min(max_len, window)`` slots, writes wrapping
    at ``length mod n_slots``)."""
    window, ring, per_slot, writes = _WRITES[case]
    jc, tc = _attn(window)
    jcache = JA.init_cache(jc, 2, 16, ring=ring, per_slot=per_slot)
    tcache = TA.init_cache(tc, 2, 16, ring=ring, per_slot=per_slot)
    _same_leaves(tcache, jcache)
    assert TA.cache_is_per_slot(tcache) == JA.cache_is_per_slot(jcache)
    rng = np.random.default_rng(3)
    for pos in writes:
        n = pos.shape[-1]
        k = rng.normal(size=(2, n, 2, 8)).astype(np.float32)
        v = rng.normal(size=(2, n, 2, 8)).astype(np.float32)
        jout = JA._update_cache(jcache, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos, jnp.int32))
        tout = TA._update_cache(tcache, torch.as_tensor(k),
                                torch.as_tensor(v),
                                torch.as_tensor(pos, dtype=torch.int32))
        jcache, tcache = jout[3], tout[3]
        _same_leaves(tcache, jcache)
        for t, j in zip(tout[:3], jout[:3]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("impl", ["xla", "bitstopper_xla"])
@pytest.mark.parametrize("layout", ["shared", "per_slot", "ring"])
def test_cached_attention_layer_matches_reference(impl, layout):
    """``attention()`` over a contiguous cache, a prefill block then two
    decode steps: the dense masked softmax (grouped heads, window mask
    from slot positions) and the BitStopper branches of a shared cursor
    and of per-slot rows, every output and cache leaf against the
    reference."""
    window = 6 if layout == "ring" else None
    jc, tc = _attn(window, impl)
    rng = np.random.default_rng(11)
    p = {name: {"w": rng.normal(size=shape).astype(np.float32) * 0.3}
         for name, shape in (("wq", (32, 4, 8)), ("wk", (32, 2, 8)),
                             ("wv", (32, 2, 8)), ("wo", (32, 32)))}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.as_tensor, p)
    per_slot = layout == "per_slot"
    jcache = JA.init_cache(jc, 2, 16, ring=layout == "ring",
                           per_slot=per_slot)
    tcache = TA.init_cache(tc, 2, 16, ring=layout == "ring",
                           per_slot=per_slot)
    if per_slot:
        steps = [np.array([[0, 1, 2, 3, 4, 5, 6, 7],
                           [0, 1, 2, 3, 4, S, S, S]]),
                 np.array([[8], [5]]), np.array([[9], [6]])]
    elif layout == "ring":      # a 6-slot ring wraps on the third step
        steps = [np.arange(5), np.array([5]), np.array([6]), np.array([7])]
    else:
        steps = [np.arange(8), np.array([8]), np.array([9])]
    for pos in steps:
        n = pos.shape[-1]
        x = rng.normal(size=(2, n, 32)).astype(np.float32)
        jy, jcache = JA.attention(jp, jnp.asarray(x),
                                  jnp.asarray(pos, jnp.int32), jc, jcache)
        ty, tcache = TA.attention(tp, torch.as_tensor(x),
                                  torch.as_tensor(pos, dtype=torch.int32),
                                  tc, tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                                   atol=2e-5)
        # K and V come from each package's own projections.
        _same_leaves(tcache, jcache, atol=PROJ_ATOL)


def test_init_caches_contiguous_tree_matches_reference(model):
    """``init_caches`` (shared cursor and per-slot) gives the reference's
    leaves through the numpy bridge."""
    jcfg, tcfg = model[:2]
    for per_slot in (False, True):
        jtree = jax.tree.map(np.asarray, JT.init_caches(
            jcfg, 3, 32, per_slot=per_slot))
        ttree = TT.caches_to_numpy(
            TT.init_caches(tcfg, 3, 32, per_slot=per_slot), tcfg)
        assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
        for t, j in zip(jax.tree.leaves(ttree), jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(t, j)
        back = TT.caches_from_numpy(jtree, tcfg)
        for t, j in zip(jax.tree.leaves(TT.caches_to_numpy(back, tcfg)),
                        jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(t, j)


def test_per_slot_cache_layout(model):
    """tests/test_serving.py:686."""
    c = TT.init_caches(model[1], 3, 32, per_slot=True)["seg0"][0]["b0"]
    assert c["pos"].shape == (3, 32) and c["length"].shape == (3,)
    assert bool((c["pos"] >= 2 ** 30).all())


def test_per_slot_rejects_non_attention():
    """tests/test_serving.py:697."""
    cfg = reduced_config("mamba2-130m")
    with pytest.raises(NotImplementedError):
        TT.init_caches(cfg, 2, 16, per_slot=True)
    with pytest.raises(NotImplementedError, match="A10"):
        TT.init_caches(cfg, 2, 16)


# ---------------------------------------------------------------------------
# the contiguous engine (tests/test_serving.py:49-178)
# ---------------------------------------------------------------------------


def test_decode_matches_prefill_bitexact_xla(model):
    """tests/test_serving.py:49: the engine's greedy tokens follow a
    one-shot cache-free forward, and equal the reference engine's."""
    out = _serve(model, (9,), max_new=8, prompt_seed=1)
    _same_serve(out)
    tcfg, tparams = model[1], model[3]
    req = out["port"][1][0]
    seq = np.concatenate([req.prompt, np.asarray(req.generated[:-1],
                                                 np.int32)])
    logits, _, _ = TT.forward(tparams, torch.as_tensor(seq)[None], tcfg)
    greedy = logits[0].argmax(-1).numpy()[len(req.prompt) - 1:]
    assert req.generated == [int(t) for t in greedy]


def test_decode_matches_prefill_bitstopper(model):
    """tests/test_serving.py:65, on bitstopper_xla at alpha 0.8."""
    _same_serve(_serve(model, (9,), max_new=5, impl="bitstopper_xla",
                       alpha=0.8, prompt_seed=2))


def test_mixed_lengths_isolated_slots(model):
    """tests/test_serving.py:94: each request served together equals it
    served alone, in both packages."""
    lens = (5, 11, 17)
    together = _serve(model, lens)
    _same_serve(together)
    for i in range(len(lens)):
        eng = _continuous(model, "port")
        alone = _reqs("port", model[0].vocab, lens)[i]
        eng.generate([alone], seed=0)
        assert alone.generated == together["port"][1][i].generated


def test_queue_admission_and_eviction(model):
    """tests/test_serving.py:111: five requests on two slots interleave
    admissions with decoding; counters and steps equal the reference's."""
    out = _serve(model, (5, 7, 9, 11, 13), max_new=4)
    _same_serve(out)
    eng, reqs = out["port"]
    assert eng.counters["requests_finished"] == 5
    assert max(r.admitted_step for r in reqs) > 0
    assert all(r is None for r in eng.slots)


def test_eos_eviction(model):
    """tests/test_serving.py:126."""
    free = _serve(model, (9,), max_new=8, prompt_seed=1)
    eos = free["port"][1][0].generated[2]
    stopped = _serve(model, (9,), max_new=8, prompt_seed=1, eos_id=int(eos))
    _same_serve(stopped)
    assert stopped["port"][1][0].generated == \
        free["port"][1][0].generated[:3]


def test_max_len_rejection(model):
    """tests/test_serving.py:141, with the reference's messages."""
    for bad in (dict(prompt=np.zeros(12, np.int32), max_new_tokens=8),
                dict(prompt=np.zeros(4, np.int32), max_new_tokens=0)):
        with pytest.raises(ValueError) as want:
            _continuous(model, "ref", max_len=16).submit(JRequest(**bad))
        with pytest.raises(ValueError) as got:
            _continuous(model, "port", max_len=16).submit(Request(**bad))
        assert str(got.value) == str(want.value)


def test_prefill_bucket_invariance(model):
    """tests/test_serving.py:150: bucket padding changes no token."""
    outs = []
    for bucket in (1, 8, 16):
        out = _serve(model, (9,), max_new=5, impl="bitstopper_xla",
                     alpha=0.6, prompt_seed=5, prefill_bucket=bucket)
        _same_serve(out)
        outs.append(out["port"][1][0].generated)
    assert outs[0] == outs[1] == outs[2], outs


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (1.0, 7),
                                              (0.7, 3)])
def test_sampled_and_greedy_tokens_match_reference(model, temperature,
                                                   seed):
    """tests/test_serving.py:656-675: seeded sampling reproduces the
    reference's tokens; greedy ignores the seed."""
    out = _serve(model, (5, 11), max_new=6, seed=seed,
                 temperature=temperature)
    _same_serve(out)
    again = _serve(model, (5, 11), max_new=6, seed=seed + 1,
                   temperature=temperature)
    same = ([r.generated for r in again["port"][1]]
            == [r.generated for r in out["port"][1]])
    assert same == (temperature == 0.0)


# (reference test, ServeConfig fields): the contiguous engine refuses what
# only the paged engine has, with the reference's messages.
_REFUSALS = {
    "tests/test_chaos.py:128": dict(max_len=32, max_slots=2,
                                    prefill_bucket=8, deadline_ticks=4),
    "tests/test_speculative.py:389": dict(speculative="ngram"),
    "tests/test_swap.py:411": dict(max_len=64, prefix_store_dir="/tmp/x"),
    "tests/test_serving.py:614": dict(oversubscribe=True),
    "shed_watermark": dict(oversubscribe=True, shed_watermark=0.5),
    "swap_host_bytes": dict(oversubscribe=True, swap_host_bytes=1 << 20),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_continuous_engine_refusals(model, case):
    jcfg, tcfg, jparams, tparams = model
    kw = _REFUSALS[case]
    with pytest.raises(ValueError) as want:
        JContinuous(jcfg, jparams, JServe(**kw))
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tcfg, tparams, ServeConfig(**kw),
                                 device="cpu")
    assert str(got.value) == str(want.value)


def test_continuous_engine_needs_the_card_by_default(model):
    tcfg, tparams = model[1], model[3]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(tcfg, tparams, ServeConfig(**_BASE))
    with pytest.raises(RuntimeError, match="CUDA"):
        StaticBucketEngine(tcfg, tparams, ServeConfig(**_BASE))


# ---------------------------------------------------------------------------
# the static engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "bitstopper_xla"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_static_engine_matches_reference(model, impl, temperature):
    """tests/test_serving.py:677's trace (prompts 8, 8, 12; seed 3): one
    batch per exact length, the reference's tokens greedy and sampled."""
    jcfg, tcfg = _cfgs(model, impl, 0.6 if impl != "xla" else None)
    kw = dict(max_len=64, temperature=temperature)
    jreqs = _reqs("ref", jcfg.vocab, (8, 8, 12), max_new=5)
    JStatic(jcfg, model[2], JServe(**kw)).generate(jreqs, seed=3)
    treqs = _reqs("port", tcfg.vocab, (8, 8, 12), max_new=5)
    StaticBucketEngine(tcfg, model[3], ServeConfig(**kw),
                       device="cpu").generate(treqs, seed=3)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_static_sampler_matches_reference():
    """The static engine's block sampler: ``categorical(key, logits /
    temperature)`` over a [B, V] block under one key, against the
    reference framework's eager call, on keys folded as the engine folds
    them."""
    rng = np.random.default_rng(4)
    for seed, bi, i in ((0, 0, 0), (3, 1, 2), (7, 0, 5)):
        logits = (rng.normal(size=(3, 4000)) * 3).astype(np.float32)
        jkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), bi), i)
        want = np.asarray(jax.random.categorical(
            jkey, jnp.asarray(logits) / 0.7, axis=-1))
        key = fold_in(fold_in(prng_key(seed).numpy(), bi), i)
        np.testing.assert_array_equal(key, np.asarray(jkey))
        got = categorical_block(key, torch.as_tensor(logits), 0.7)
        np.testing.assert_array_equal(got.numpy(), want)
