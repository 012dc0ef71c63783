"""Swap-to-host preemption of the port held against the reference on the
CPU: reduced stablelm-1.6b (alpha 0.8) with the reference's weights carried
across, on the oversubscribed shape of tests/test_swap.py (three slots, a
pool of 10 blocks of 8 tokens).

Each case of the reference's swap tests is served by both packages with a
swap tier: the tokens, the swap and prefill counters and
``memory_report()`` must equal the reference's, and the port's swap run
must give the port's recompute run's tokens with fewer prefill chunks.  The
reference's ``model`` fixture there serves dense ``xla`` attention; every
case here runs the BitStopper score path, whose swap also carries planes
and scales (a dense pool's swap is the same row transport without them).  Also: the block-row transport against the
reference's on equal caches, the stale-planes path (a scale that grows
between swap-out and swap-in; a probe asserts the growth in both
packages), ``swap_fail`` through both chaos harnesses, and a swap record
that stays whole while its freed blocks are overwritten."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core import quantization as jq
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serving import FaultPlan as JPlan
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import serve_with_chaos as jchaos
from repro.serving.engine import _amax_leaves as j_amax_leaves
from repro.serving.kv_pool import SwapPool as JSwapPool
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import (FaultPlan, PagedEngine, Request,
                                 ServeConfig, SwapPool, serve_with_chaos)
from repro_torch.serving.engine import _amax_arrays

# tests/test_swap.py's oversubscribed shape and swap budget.
_OS = dict(max_len=64, max_slots=3, prefill_bucket=8, page_size=8,
           pool_blocks=10, oversubscribe=True)
_SWAP = 1 << 22
_COUNTERS = ("preemptions", "swap_outs", "swap_ins", "swap_fallbacks",
             "swap_in_tokens", "prefill_chunks")


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(lens, seed=0, prefix=None):
    """Prompts drawn as tests/test_swap.py's ``_reqs`` draws them."""
    rng = np.random.default_rng(seed)
    tails = [rng.integers(0, 256, L, dtype=np.int32) for L in lens]
    if prefix is None:
        return tails
    return [np.concatenate([prefix, t]) for t in tails]


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    if pkg == "ref":
        return JEngine(jcfg, jparams, JServe(**kw))
    return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")


def _serve(model, pkg, prompts, seed=0, max_new=16, swap_in_probe=None,
           **kw):
    """Serve the prompts; returns (engine, tokens)."""
    eng = _engine(model, pkg, **kw)
    if swap_in_probe is not None:
        swap_in_probe(eng)
    R = JRequest if pkg == "ref" else Request
    reqs = [R(prompt=p.copy(), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, seed=seed)
    return eng, [r.generated for r in reqs]


@pytest.fixture(scope="module")
def runs(model):
    """Served runs, each made once for the whole file: ``runs(name, pkg,
    swap)`` for the named traces below."""
    memo = {}

    def get(name, pkg, swap=_SWAP):
        key = (name, pkg, swap)
        if key not in memo:
            prompts, seed, kw = _TRACES[name]
            memo[key] = _serve(model, pkg, prompts, seed,
                               swap_host_bytes=swap, **kw)
        return memo[key]

    return get


_SYS = np.random.default_rng(42).integers(0, 256, 16, dtype=np.int32)
# name -> (prompts, seed, ServeConfig fields): the reference's cases.
_TRACES = {
    # tests/test_swap.py:82, greedy
    "greedy": (_prompts((12, 9, 11)), 0,
               dict(_OS, fused_decode=False)),
    # :101, sampled
    "sampled": (_prompts((12, 9, 11)), 7,
                dict(_OS, fused_decode=False, temperature=1.0)),
    # :112, shared system prompt (one more block)
    "shared": (_prompts((3, 7, 5), seed=5, prefix=_SYS), 0,
               dict(_OS, pool_blocks=11, fused_decode=False)),
    # :141, speculative n-gram
    "ngram": (_prompts((12, 9, 11)), 0,
              dict(_OS, fused_decode=False, speculative="ngram",
                   draft_k=3)),
    # :153, the decode kernel: the port's plain kernel path against the
    # reference's interpreted kernel (the plane pool travels in the record)
    "fused": (_prompts((12, 9, 11)), 0, dict(_OS, fused_decode=True)),
    # two fixed examples of the property sweep (:219)
    "prop_a": (_prompts((13, 10, 9), seed=9), 9,
               dict(_OS, fused_decode=False)),
    "prop_b": (_prompts((11, 12, 10), seed=8), 8,
               dict(_OS, fused_decode=False, temperature=1.0)),
}


def _assert_swap_case(runs, name):
    """The port's swap run against the reference's and the port's own
    recompute run."""
    jeng, jtok = runs(name, "ref")
    teng, ttok = runs(name, "port")
    rec, rtok = runs(name, "port", swap=0)
    assert ttok == jtok
    assert ({k: teng.counters[k] for k in _COUNTERS}
            == {k: jeng.counters[k] for k in _COUNTERS})
    assert teng.memory_report() == jeng.memory_report()
    assert teng.counters["preemptions"] >= 1
    assert teng.counters["swap_outs"] >= 1
    assert teng.counters["swap_ins"] >= 1
    assert teng.counters["swap_in_tokens"] > 0
    assert ttok == rtok
    assert teng.counters["prefill_chunks"] < rec.counters["prefill_chunks"]
    assert teng._swap.bytes_used == 0
    assert teng.pool.available() == teng.pool.capacity
    return teng


@pytest.mark.parametrize("name", ["greedy", "sampled", "shared", "ngram",
                                  "prop_a", "prop_b"])
def test_swap_resume_equals_reference(runs, name):
    """tests/test_swap.py's greedy, sampled, shared-prefix, speculative and
    property cases: the reference's tokens, counters and tiers."""
    teng = _assert_swap_case(runs, name)
    if name == "shared":
        assert teng.counters["prefix_hit_tokens"] > 0


def test_swap_resume_fused_and_fallback(runs):
    """tests/test_swap.py:153: ``kq`` rows travel in the record, and the
    kernel path gives the plain oracle's tokens."""
    teng = _assert_swap_case(runs, "fused")
    assert "kq" in teng.caches["seg0"][0]["b0"]
    assert runs("fused", "port")[1] == runs("greedy", "port")[1]


def test_swap_budget_refusal_falls_back_to_recompute(model, runs):
    """tests/test_swap.py:203: a swap pool too small for the record refuses
    the put, and the victim recomputes."""
    prompts, seed, kw = _TRACES["greedy"]
    jeng, jtok = _serve(model, "ref", prompts, seed, swap_host_bytes=64,
                        **kw)
    teng, ttok = _serve(model, "port", prompts, seed, swap_host_bytes=64,
                        **kw)
    assert ttok == jtok == runs("greedy", "port", swap=0)[1]
    assert ({k: teng.counters[k] for k in _COUNTERS}
            == {k: jeng.counters[k] for k in _COUNTERS})
    assert teng.counters["swap_fallbacks"] >= 1
    assert teng.counters["swap_ins"] == 0
    assert teng._swap.refused_count == jeng._swap.refused_count >= 1
    assert teng.memory_report() == jeng.memory_report()


def _grew_probe(get_amax, grew, captured=None):
    """Wrap an engine's ``_swap_in``: record whether any scale grew between
    the record's swap-out and now; with ``captured``, also keep the
    reference engine's caches around the call and its arguments."""
    def install(eng):
        orig = eng._swap_in

        def probe(req, row, ctx, m, resumed):
            rec = eng._swap.get(req.rid)
            if rec is not None:
                grew.append(not all(
                    np.array_equal(c, r)
                    for c, r in zip(get_amax(eng), rec["amax"])))
                if captured is not None:
                    captured.update(
                        before=jax.tree.map(np.asarray, eng.caches),
                        rec=copy.deepcopy(rec),
                        args=(req.rid, row.copy(), ctx.copy(), m, resumed))
            out = orig(req, row, ctx, m, resumed)
            if captured is not None and rec is not None:
                captured["after"] = jax.tree.map(np.asarray, eng.caches)
            return out

        eng._swap_in = probe
    return install


def test_swap_quant_grid_growth_repacks(model):
    """The stale-planes path (tests/test_swap.py:169): a scale grows while
    the victim is on the host, so ``_swap_in`` drops the stored ``kq`` rows
    and repacks the spliced blocks.  The reference's seed 6 no longer grows
    a scale there; this trace (seed 0, found by a sweep) does, in both
    packages, as the probes assert.  Tokens equal the reference's and the
    port's recompute run's, and the port's ``_swap_in`` on the reference's
    caches and record gives the reference's caches byte for byte (``kq``
    included)."""
    jcfg, tcfg, _, _ = model
    prompts, seed, kw = _TRACES["fused"]
    jgrew, tgrew, captured = [], [], {}
    jeng, jtok = _serve(model, "ref", prompts, seed, swap_host_bytes=_SWAP,
                        swap_in_probe=_grew_probe(
                            lambda e: [np.asarray(a, np.float32)
                                       for a in j_amax_leaves(e.caches)],
                            jgrew, captured), **kw)
    teng, ttok = _serve(model, "port", prompts, seed, swap_host_bytes=_SWAP,
                        swap_in_probe=_grew_probe(
                            lambda e: _amax_arrays(e.caches, True), tgrew),
                        **kw)
    assert jgrew == tgrew == [True], \
        "trace no longer exercises the stale-planes path"
    assert ttok == jtok
    rec_eng, rtok = _serve(model, "port", prompts, seed, **kw)
    assert ttok == rtok

    # The port's _swap_in on the reference's state at the same call.
    eng = _engine(model, "port", swap_host_bytes=_SWAP, **kw)
    eng.caches = TT.caches_from_numpy(captured["before"], tcfg)
    rid, row, ctx, m, resumed = captured["args"]
    eng._swap.put(rid, captured["rec"], 0)
    req = Request(prompt=ctx, max_new_tokens=1, rid=rid)
    assert eng._swap_in(req, row, ctx, m, resumed) is not None
    got = TT.caches_to_numpy(eng.caches, tcfg)["seg0"]["b0"]
    want = captured["after"]["seg0"]["b0"]
    before = captured["before"]["seg0"]["b0"]
    assert not np.array_equal(want["kq"], before["kq"])
    for key in ("k", "v", "pos", "kq", "k_amax", "v_amax"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_swap_fail_falls_back_to_recompute(model, runs):
    """tests/test_chaos.py:495 through both ``serve_with_chaos``s: the
    injected host-copy failure costs the victim its record, never a
    token."""
    jcfg, tcfg, jparams, tparams = model
    prompts, seed, kw = _TRACES["greedy"]
    scfg = dict(kw, swap_host_bytes=_SWAP)
    out = []
    for chaos, make, R, P in (
            (jchaos, lambda: JEngine(jcfg, jparams, JServe(**scfg)),
             JRequest, JPlan),
            (serve_with_chaos,
             lambda: PagedEngine(tcfg, tparams, ServeConfig(**scfg),
                                 device="cpu"), Request, FaultPlan)):
        reqs, rep = chaos(make, [R(prompt=p.copy(), max_new_tokens=16)
                                 for p in prompts],
                          seed=0, plan=P.scripted([("swap_fail", 0)]))
        out.append(([r.generated for r in reqs], rep))
    (jtok, jrep), (ttok, trep) = out
    assert ttok == jtok == runs("greedy", "port", swap=0)[1]
    assert trep["fired_by_kind"] == jrep["fired_by_kind"] == {"swap_fail": 1}
    assert trep["engine_counters"] == {
        k: jrep["engine_counters"][k] for k in trep["engine_counters"]}
    assert trep["engine_counters"]["swap_fallbacks"] >= 1
    assert trep["engine_counters"]["swap_ins"] == 0


def test_swap_record_is_a_copy(model, runs):
    """A swap record does not alias the pool: the victim's blocks are
    overwritten with garbage as soon as the record is taken (as a new owner
    would overwrite them), the record arrives at the swap-in unchanged, and
    the tokens equal the recompute run's."""
    prompts, seed, kw = _TRACES["fused"]
    eng = _engine(model, "port", swap_host_bytes=_SWAP, **kw)
    kept, seen = {}, []
    orig_out, orig_in = eng._swap_out, eng._swap_in

    def swap_out(slot, exclusive, L, req):
        orig_out(slot, exclusive, L, req)
        rec = eng._swap.get(req.rid)
        kept[req.rid] = copy.deepcopy(rec)
        idx = torch.as_tensor(exclusive)
        for c in TA.paged_layer_groups(eng.caches)[0]:
            for key in ("k", "v", "pos", "kq"):
                c[key][idx] = (7 if key != "k" else -1e6)

    def swap_in(req, row, ctx, m, resumed):
        rec = eng._swap.get(req.rid)
        if rec is not None:
            seen.append(req.rid)
            for lay, want in zip(rec["layers"], kept[req.rid]["layers"]):
                for key in want:
                    np.testing.assert_array_equal(lay[key], want[key])
        return orig_in(req, row, ctx, m, resumed)

    eng._swap_out, eng._swap_in = swap_out, swap_in
    reqs = [Request(prompt=p.copy(), max_new_tokens=16) for p in prompts]
    eng.generate(reqs, seed=seed)
    assert seen and eng.counters["swap_ins"] == len(seen)
    assert [r.generated for r in reqs] == runs("fused", "port", swap=0)[1]


def test_swap_pool_policies():
    """``SwapPool`` as the reference's: refusal without ``evict_cb``, LRU
    eviction through it, the counters and the peak."""
    log = {"ref": [], "port": []}
    pools = {}
    for name, cls in (("ref", JSwapPool), ("port", SwapPool)):
        refuse = cls(100)
        evict = cls(100, evict_cb=lambda k, r, n, name=name:
                    log[name].append((k, r, n)))
        steps = [refuse.put("a", 1, 60), refuse.put("b", 2, 60),
                 refuse.put("c", 3, 200), refuse.take("a"),
                 refuse.put("b", 2, 60),
                 evict.put("x", 1, 40), evict.put("y", 2, 40),
                 evict.get("x"), evict.put("z", 3, 40),
                 evict.put("y", 4, 10), evict.keys(), evict.items()]
        pools[name] = (steps, [(p.bytes_used, p.peak_bytes, p.put_count,
                                p.evict_count, p.refused_count, len(p))
                               for p in (refuse, evict)])
    assert pools["port"] == pools["ref"]
    assert log["port"] == log["ref"] == [("y", 2, 40)]
    with pytest.raises(ValueError):
        SwapPool(-1)
    with pytest.raises(ValueError):
        SwapPool(10).put("a", 1, -1)


# ---------------------------------------------------------------------------
# the block-row transport on equal caches
# ---------------------------------------------------------------------------


def _cache_pair(model, seed):
    """A reference paged cache tree with a plane pool, filled with random
    rows and scales, and the same caches in the port's layout."""
    jcfg, tcfg, _, _ = model
    layout = JA.PagedLayout(6, 8, 4)
    tree = jax.tree.map(np.asarray, JT.init_caches(
        jcfg.replace(fused_decode=True), 2, 32, paged=layout))
    rng = np.random.default_rng(seed)
    layer = tree["seg0"]["b0"]                   # stacked over 2 reps
    layer["k"] = rng.normal(size=layer["k"].shape).astype(np.float32)
    layer["v"] = rng.normal(size=layer["v"].shape).astype(np.float32)
    layer["pos"] = rng.integers(0, 32, layer["pos"].shape).astype(np.int32)
    layer["k_amax"] = (np.abs(layer["k"]).max(axis=(1, 2, 4))
                       * np.float32(1.25)).astype(np.float32)
    layer["v_amax"] = (np.abs(layer["v"]).max(axis=(1, 2, 4))
                       * np.float32(1.25)).astype(np.float32)
    layer["kq"] = np.stack([np.asarray(jq.pack_pool_planes(
        jnp.asarray(k), jnp.asarray(a))) for k, a in
        zip(layer["k"], layer["k_amax"])])
    return tree, TT.caches_from_numpy(tree, tcfg)


def _assert_caches_equal(tcache, jcache, tcfg):
    got = TT.caches_to_numpy(tcache, tcfg)["seg0"]["b0"]
    want = jax.tree.map(np.asarray, jcache)["seg0"]["b0"]
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_block_row_transport_equals_reference(model):
    """``extract_block_rows``, ``splice_block_rows`` (with ``sel``),
    ``repack_block_planes``, ``apply_inject_amax_rule`` and
    ``requant_plane_pools`` on equal caches give the reference's records
    and caches exactly, in the reference's layer layout (the stacked
    segment is one entry with a leading reps axis)."""
    jcfg, tcfg, _, _ = model
    jtree, tcache = _cache_pair(model, 0)
    jcache = jax.tree.map(jnp.asarray, jtree)
    want = JA.extract_block_rows(jcache, [3, 1], planes=True)
    got = TA.extract_block_rows(tcache, [3, 1], planes=True)
    assert len(got) == len(want) == 1
    for key in want[0]:
        assert got[0][key].dtype == want[0][key].dtype, key
        np.testing.assert_array_equal(got[0][key], want[0][key])
    assert got[0]["k"].shape[:2] == (2, 2)
    assert set(TA.extract_block_rows(tcache, [2])[0]) == {"k", "v", "pos"}

    # Splice rows of other caches into blocks 4 and 2, picked by sel.
    jsrc, tsrc = _cache_pair(model, 1)
    rows = JA.extract_block_rows(jax.tree.map(jnp.asarray, jsrc), [1, 5])
    jcache = JA.splice_block_rows(jcache, [4, 2], rows, sel=[1, 0])
    TA.splice_block_rows(tcache, [4, 2],
                         TA.extract_block_rows(tsrc, [1, 5]), sel=[1, 0])
    _assert_caches_equal(tcache, jcache, tcfg)
    jcache = JA.repack_block_planes(jcache, [4, 2])
    TA.repack_block_planes(tcache, [4, 2])
    _assert_caches_equal(tcache, jcache, tcfg)

    # The scale rule over two chunk groups of the spliced rows: one that
    # grows K (rows scaled up) and one that grows nothing.
    big = [{k: (v * np.float32(3.0) if k in ("k", "v") else v)
            for k, v in lay.items()} for lay in rows]
    groups = [[(0, 0, 8), (1, 0, 3)], [(1, 3, 8)]]
    jcache, jgrew = JA.apply_inject_amax_rule(jcache, big, groups)
    _, tgrew = TA.apply_inject_amax_rule(tcache, big, groups)
    assert jgrew is tgrew is True
    _assert_caches_equal(tcache, jcache, tcfg)
    jcache = JA.requant_plane_pools(jcache)
    TA.requant_plane_pools(tcache)
    _assert_caches_equal(tcache, jcache, tcfg)
    jcache, jgrew = JA.apply_inject_amax_rule(jcache, rows, groups)
    _, tgrew = TA.apply_inject_amax_rule(tcache, rows, groups)
    assert jgrew is tgrew is False
    _assert_caches_equal(tcache, jcache, tcfg)
    with pytest.raises(ValueError, match="paged layers"):
        TA.splice_block_rows(tcache, [1], rows + rows)


def test_block_rows_unstacked_layout(model):
    """Without ``scan_layers`` the reference keeps one entry per layer, and
    so does the port's record."""
    _, tcfg, _, _ = model
    _, tcache = _cache_pair(model, 2)
    stacked = TA.extract_block_rows(tcache, [2, 3])
    flat = TA.extract_block_rows(tcache, [2, 3], scan_layers=False)
    assert len(flat) == 2 and flat[0]["k"].shape[0] == 2
    for r in range(2):
        for key in ("k", "v", "pos"):
            np.testing.assert_array_equal(flat[r][key], stacked[0][key][r])
