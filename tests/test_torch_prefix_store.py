"""The persistent prefix store of the port held against the reference on the
CPU: the store's records (names, layout, crash consistency, and a store
written by either package loads in the other), and warm starts of the
port's engine beside the reference's.  Reduced stablelm-1.6b (alpha 0.8)
with the reference's weights carried across, on tests/test_swap.py's store
geometry (prefill chunks of one 8-token page).

The reference's warm grid is not its cold grid when two slots interleave
their writes: injection changes the order in which the running scales see
the rows (ROADMAP C5).  So the port's warm engine is held to the
reference's warm engine (tokens exactly, scales within ``AMAX_RTOL``), and
to its own cold run only where injection leaves the order of writes as it
was (one slot), where the grid and the plane bytes must be equal."""

import os

import jax
import numpy as np
import pytest

from repro.checkpoint import store as jstore
from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultPlan as JPlan
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving.engine import _amax_leaves as j_amax_leaves
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import (FaultInjector, FaultPlan, PagedEngine,
                                 Request, ServeConfig)
from repro_torch.serving.engine import _amax_arrays
from _torch_threads import one_thread  # noqa: F401

AMAX_RTOL = 1e-6      # a few f32 ulps: each package's own K/V projections

# tests/test_swap.py's store geometry.
_STORE = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8,
              prefill_chunk=8)
_SYS = np.random.default_rng(42).integers(0, 256, 16, dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(lens=(6, 9), seed=3, prefix_len=None):
    """tests/test_swap.py's ``_store_reqs`` (the system prompt, then a
    tail), or with ``prefix_len`` tests/test_chaos.py's ``_reqs``."""
    rng = np.random.default_rng(seed)
    prefix = (_SYS if prefix_len is None
              else rng.integers(0, 256, prefix_len, dtype=np.int32))
    return [np.concatenate([prefix, rng.integers(0, 256, L, dtype=np.int32)])
            for L in lens]


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    if pkg == "ref":
        return JEngine(jcfg, jparams, JServe(**kw))
    return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")


def _serve(model, pkg, prompts, max_new=8, engine=None, **kw):
    eng = engine if engine is not None else _engine(model, pkg, **kw)
    R = JRequest if pkg == "ref" else Request
    reqs = [R(prompt=p.copy(), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, seed=0)
    return eng, [r.generated for r in reqs]


def _amax(pkg, eng):
    if pkg == "ref":
        return [np.asarray(a, np.float32) for a in j_amax_leaves(eng.caches)]
    return _amax_arrays(eng.caches, True)


def _assert_grids_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=AMAX_RTOL, atol=0)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _layers(seed, reps=2, n_layers=1):
    rng = np.random.default_rng(seed)
    return [{"k": rng.normal(size=(reps, 1, 8, 4, 16)).astype(np.float32),
             "v": rng.normal(size=(reps, 1, 8, 4, 16)).astype(np.float32),
             "pos": rng.integers(0, 64, (reps, 1, 8)).astype(np.int32)}
            for _ in range(n_layers)]


@pytest.mark.parametrize("writer,reader", [(jstore, tstore),
                                           (tstore, jstore)])
def test_prefix_records_cross_packages(tmp_path, writer, reader):
    """A record saved by either package loads in the other with equal
    arrays, under the reference's name; both list the same chains and
    bytes."""
    d = str(tmp_path)
    chains = [[1, 2, 3], list(range(16)), [7] * 8]
    for i, chain in enumerate(chains):
        writer.save_prefix_record(d, chain, _layers(i, n_layers=2))
        assert (tstore.prefix_record_name(chain)
                == jstore.prefix_record_name(chain))
        assert os.path.isdir(os.path.join(d, jstore.prefix_record_name(
            chain)))
    for i, chain in enumerate(chains):
        got = reader.load_prefix_record(d, chain)
        for g, w in zip(got, _layers(i, n_layers=2)):
            assert set(g) == set(w)
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
    assert tstore.list_prefix_records(d) == jstore.list_prefix_records(d)
    assert sorted(tstore.list_prefix_records(d)) == sorted(chains)
    assert tstore.prefix_store_bytes(d) == jstore.prefix_store_bytes(d) > 0
    assert reader.load_prefix_record(d, [9, 9]) is None


def test_prefix_store_first_writer_and_crash_consistency(tmp_path):
    """First writer wins; a chain that does not match its MANIFEST is a
    miss; an interrupted save leaves an invisible staging orphan that
    ``gc_staging`` reclaims, as in the reference."""
    d = str(tmp_path)
    tstore.save_prefix_record(d, [1, 2], _layers(0))
    tstore.save_prefix_record(d, [1, 2], _layers(1))
    np.testing.assert_array_equal(
        tstore.load_prefix_record(d, [1, 2])[0]["k"], _layers(0)[0]["k"])
    # A digest collision: the MANIFEST holds another chain.
    os.rename(os.path.join(d, tstore.prefix_record_name([1, 2])),
              os.path.join(d, tstore.prefix_record_name([5])))
    assert tstore.load_prefix_record(d, [5]) is None
    assert jstore.load_prefix_record(d, [5]) is None

    class Die(RuntimeError):
        pass

    def die():
        raise Die()

    for pkg in (tstore, jstore):
        sub = os.path.join(d, pkg.__name__.split(".")[0])
        with pytest.raises(Die):
            pkg.save_prefix_record(sub, [3, 4], _layers(2), interrupt=die)
        assert len([n for n in os.listdir(sub) if ".tmp" in n]) == 1
        assert tstore.load_prefix_record(sub, [3, 4]) is None
        assert tstore.list_prefix_records(sub) == []
        assert tstore.prefix_store_bytes(sub) == 0
        assert len(tstore.gc_staging(sub, grace=0.0)) == 1
        assert os.listdir(sub) == []


# ---------------------------------------------------------------------------
# warm starts against the reference
# ---------------------------------------------------------------------------


def _first_then_warm(model, pkg, store_dir, fused, max_slots=2):
    """An engine that serves the trace and flushes its prefixes into
    ``store_dir``, then a cold engine and a warm one on that store."""
    kw = dict(_STORE, max_slots=max_slots, fused_decode=fused)
    first, _ = _serve(model, pkg, _prompts(), prefix_store_dir=store_dir,
                      **kw)
    flushed = first.flush_prefixes()
    cold, cold_tok = _serve(model, pkg, _prompts(), **kw)
    warm, warm_tok = _serve(model, pkg, _prompts(),
                            prefix_store_dir=store_dir, **kw)
    return flushed, cold, cold_tok, warm, warm_tok


@pytest.mark.parametrize("fused", [False, True])
def test_prefix_store_warm_start_equals_reference(model, tmp_path, fused):
    """tests/test_swap.py:260 (greedy) and :284 (BitStopper; with the plane
    pool): the port's warm tokens equal the reference's warm tokens and the
    cold ones, with fewer prefill chunks; its warm grid equals the
    reference's warm grid within ``AMAX_RTOL``; the counters and
    ``memory_report()`` equal the reference's."""
    out = {}
    for pkg in ("ref", "port"):
        out[pkg] = _first_then_warm(model, pkg, str(tmp_path / pkg), fused)
    jn, jcold, jcold_tok, jwarm, jwarm_tok = out["ref"]
    tn, tcold, tcold_tok, twarm, twarm_tok = out["port"]
    assert tn == jn >= 2
    assert twarm_tok == jwarm_tok == tcold_tok == jcold_tok
    keys = ("prefix_store_hits", "prefix_store_tokens", "prefill_chunks",
            "prefix_hit_tokens", "prefix_spills")
    assert ({k: twarm.counters[k] for k in keys}
            == {k: jwarm.counters[k] for k in keys})
    assert twarm.counters["prefix_store_hits"] >= 1
    assert twarm.counters["prefix_store_tokens"] >= 16
    assert twarm.counters["prefill_chunks"] < tcold.counters["prefill_chunks"]
    assert twarm.memory_report() == jwarm.memory_report()
    _assert_grids_close(_amax("port", twarm), _amax("ref", jwarm))
    _assert_grids_close(_amax("port", tcold), _amax("ref", jcold))
    assert (tstore.list_prefix_records(str(tmp_path / "port"))
            == jstore.list_prefix_records(str(tmp_path / "ref")))


def test_warm_grid_equals_cold_with_one_slot(model, tmp_path):
    """By construction: with one slot, injection leaves the order of writes
    as it was, so the port's warm scales and plane bytes equal its cold
    run's exactly (with two slots they do not, in either package: C5)."""
    _, tcfg, _, _ = model
    n, cold, cold_tok, warm, warm_tok = _first_then_warm(
        model, "port", str(tmp_path), fused=True, max_slots=1)
    assert warm_tok == cold_tok
    assert warm.counters["prefix_store_hits"] >= 2
    for a, b in zip(_amax("port", warm), _amax("port", cold)):
        np.testing.assert_array_equal(a, b)
    got = TT.caches_to_numpy(warm.caches, tcfg)["seg0"]["b0"]
    want = TT.caches_to_numpy(cold.caches, tcfg)["seg0"]["b0"]
    np.testing.assert_array_equal(got["kq"], want["kq"])


def test_prefix_store_resumed_request_zero_prefill(model, tmp_path):
    """tests/test_swap.py:309: a resumed request whose whole context is
    block-aligned and stored decodes with no prefill chunk at all, with the
    recompute continuation's tokens, as the reference's does."""
    d = str(tmp_path)
    first, _ = _serve(model, "port", _prompts(), prefix_store_dir=d,
                      fused_decode=False, **_STORE)
    first.flush_prefixes()
    got = {}
    for pkg, store_dir in (("ref", d), ("port", d), ("port_cold", None)):
        eng = _engine(model, pkg[:4], fused_decode=False,
                      prefix_store_dir=store_dir, **_STORE)
        R = JRequest if pkg == "ref" else Request
        r = R(prompt=_SYS[:15].copy(), max_new_tokens=4)
        r.generated = [int(_SYS[15]), 42]
        eng.generate([r], seed=0)
        got[pkg] = (r.generated, eng.counters["prefill_chunks"])
    assert got["port"][1] == got["ref"][1] == 0
    assert got["port_cold"][1] > 0
    assert got["port"][0] == got["ref"][0] == got["port_cold"][0]


def test_prefix_host_tier_spills_to_disk(model, tmp_path):
    """tests/test_swap.py:337: device LRU evictions land in the host tier,
    whose pressure spills them to disk; spills, evictions and every tier's
    bytes equal the reference's, and a warm engine on the store gives a
    cold one's tokens."""
    out = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        eng, tok = _serve(model, pkg, _prompts((9, 11, 10, 9, 11), seed=8),
                          max_new=16, prefix_store_dir=d,
                          prefix_host_bytes=1 << 14, pool_blocks=8,
                          fused_decode=False, **_STORE)
        out[pkg] = (eng, tok, eng.memory_report())
        eng.flush_prefixes()
    (jeng, jtok, jrep), (teng, ttok, trep) = out["ref"], out["port"]
    assert ttok == jtok
    assert teng.counters["prefix_spills"] == jeng.counters["prefix_spills"]
    assert teng.counters["prefix_spills"] >= 1
    assert (teng._prefix_host.evict_count == jeng._prefix_host.evict_count
            >= 1)
    assert trep == jrep
    assert trep["disk_prefix_bytes"] > 0
    assert trep["host_prefix_bytes"] <= 1 << 14
    assert (tstore.list_prefix_records(str(tmp_path / "port"))
            == jstore.list_prefix_records(str(tmp_path / "ref")))
    _, cold = _serve(model, "port", _prompts(), fused_decode=False, **_STORE)
    warm, got = _serve(model, "port", _prompts(), fused_decode=False,
                       prefix_store_dir=str(tmp_path / "port"), **_STORE)
    assert warm.counters["prefix_store_hits"] >= 1
    assert got == cold


def test_prefix_spill_interrupt_torn_write_invisible(model, tmp_path):
    """tests/test_chaos.py:517: a spill killed by ``checkpoint_interrupt``
    publishes nothing, leaves one staging orphan that GC reclaims, and
    counts as the reference's does; the flushed store still warms an
    engine to a cold one's tokens."""
    counters = {}
    for pkg, Inj, Plan in (("ref", JInjector, JPlan),
                           ("port", FaultInjector, FaultPlan)):
        d = str(tmp_path / pkg)
        eng = _engine(model, pkg, pool_blocks=8, prefix_store_dir=d,
                      fused_decode=False, **_STORE)
        eng.chaos = Inj(Plan.scripted([("checkpoint_interrupt", 0)]))
        _serve(model, pkg, _prompts((9, 11, 10, 9, 11), seed=8,
                                    prefix_len=16), max_new=16, engine=eng)
        counters[pkg] = {k: eng.counters[k] for k in (
            "prefix_spills", "prefix_store_interrupts", "prefill_chunks")}
        assert len([n for n in os.listdir(d) if ".tmp" in n]) == 1
        chains = tstore.list_prefix_records(d)
        assert len(chains) >= 1
        assert all(tstore.load_prefix_record(d, c) is not None
                   for c in chains)
        assert len(tstore.gc_staging(d, grace=0.0)) == 1
        eng.flush_prefixes()
    assert counters["port"] == counters["ref"]
    assert counters["port"]["prefix_spills"] >= 2
    assert counters["port"]["prefix_store_interrupts"] == 1
    prompts = _prompts((9, 11), seed=8, prefix_len=16)
    _, cold = _serve(model, "port", prompts, fused_decode=False, **_STORE)
    warm, got = _serve(model, "port", prompts, fused_decode=False,
                       prefix_store_dir=str(tmp_path / "port"), **_STORE)
    assert warm.counters["prefix_store_hits"] >= 1
    assert got == cold


def test_reference_store_warms_port_engine(model, tmp_path):
    """A store flushed by the reference warms a port engine, which serves
    the reference's warm tokens with the reference's store counters."""
    d = str(tmp_path)
    first, _ = _serve(model, "ref", _prompts(), prefix_store_dir=d,
                      fused_decode=True, **_STORE)
    first.flush_prefixes()
    jwarm, jtok = _serve(model, "ref", _prompts(), prefix_store_dir=d,
                         fused_decode=True, **_STORE)
    twarm, ttok = _serve(model, "port", _prompts(), prefix_store_dir=d,
                         fused_decode=True, **_STORE)
    assert ttok == jtok
    for k in ("prefix_store_hits", "prefix_store_tokens", "prefill_chunks"):
        assert twarm.counters[k] == jwarm.counters[k], k
    assert twarm.counters["prefix_store_hits"] >= 1
    _assert_grids_close(_amax("port", twarm), _amax("ref", jwarm))
