"""Crash snapshots of the port held against the reference on the CPU: the
snapshot store (crash consistency, and a directory written by either
package loads in the other), ``PagedEngine.snapshot()`` beside the
reference's tick by tick, a reference snapshot restored into a fresh port
engine, the restore guards, and a crash at every tick of a trace.

Reduced stablelm-1.6b (alpha 0.8) with the reference's weights carried
across.  A snapshot's keys all equal the reference's but ``amax``: the
pool-wide scales are the running max |K| and |V| of each package's own K/V
projections, which differ from XLA's in the last bits like every float
output of a forward, so they are held within ``AMAX_RTOL`` (and the tokens,
the allocator and every integer field exactly)."""

import json

import jax
import numpy as np
import pytest

from repro.checkpoint import store as jstore
from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import (CheckpointInterrupted, FaultPlan,
                                 PagedEngine, Request, ServeConfig,
                                 serve_with_chaos)
from repro_torch.serving.engine import _layers

AMAX_RTOL = 1e-6      # a few f32 ulps


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_snapshot_store_crash_consistency(tmp_path):
    """tests/test_chaos.py's torn-write case on the port's store."""
    d = str(tmp_path)
    tstore.save_snapshot({"v": 1}, d, step=1)
    assert tstore.load_snapshot(d) == ({"v": 1}, 1)

    def die():
        raise CheckpointInterrupted("killed between stage and promote")

    with pytest.raises(CheckpointInterrupted):
        tstore.save_snapshot({"v": 2}, d, step=2, interrupt=die)
    # The torn write is invisible: the latest promoted state still serves.
    assert tstore.latest_step(d) == 1
    assert tstore.load_snapshot(d) == ({"v": 1}, 1)
    orphans = [n for n in tmp_path.iterdir() if ".tmp" in n.name]
    assert len(orphans) == 1
    assert tstore.gc_staging(d, grace=3600.0) == []   # too young
    assert len(tstore.gc_staging(d, grace=0.0)) == 1  # single-writer reclaim
    assert [n for n in tmp_path.iterdir() if ".tmp" in n.name] == []
    tstore.save_snapshot({"v": 3}, d, step=3)
    assert tstore.load_snapshot(d) == ({"v": 3}, 3)
    assert tstore.load_snapshot(d, step=1) == ({"v": 1}, 1)
    with pytest.raises(FileNotFoundError):
        tstore.load_snapshot(str(tmp_path / "empty"))


@pytest.mark.parametrize("writer,reader", [(tstore, jstore),
                                           (jstore, tstore)])
def test_snapshot_directory_loads_in_the_other_package(tmp_path, writer,
                                                       reader):
    """The same ``step_<N>/`` layout, MANIFEST and JSON: each package reads
    what the other wrote, sees the other's torn write as invisible and
    reclaims its orphan."""
    d = str(tmp_path)
    obj = {"version": 1, "amax": [[0.5, 1.25]], "queue": [2, 0],
           "seed": None}
    writer.save_snapshot(obj, d, step=7)
    writer.save_snapshot({"older": True}, d, step=3)

    def die():
        raise RuntimeError("killed")

    with pytest.raises(RuntimeError):
        writer.save_snapshot({"torn": True}, d, step=9, interrupt=die)
    assert reader.latest_step(d) == 7
    assert reader.load_snapshot(d) == (obj, 7)
    assert reader.load_snapshot(d, step=3) == ({"older": True}, 3)
    with open(tmp_path / "step_00000007" / "MANIFEST.json") as f:
        assert json.load(f) == {"step": 7, "kind": "snapshot"}
    assert len(reader.gc_staging(d, grace=0.0)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000007"]


# ---------------------------------------------------------------------------
# snapshot() and restore() against the reference
# ---------------------------------------------------------------------------

# tests/test_serving.py's oversubscribed geometry: a mid-decode claim
# preempts, so the queue, the slots and the preemption counts all move.
_OS = dict(max_len=64, max_slots=3, prefill_bucket=8, page_size=8,
           pool_blocks=10, oversubscribe=True)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, L, dtype=np.int32) for L in (12, 9, 11)]


def _assert_snapshots_match(got, want, where):
    assert set(got) == set(want), where
    assert {k: v for k, v in got.items() if k != "amax"} == \
        {k: v for k, v in want.items() if k != "amax"}, where
    assert len(got["amax"]) == len(want["amax"]), where
    for g, w in zip(got["amax"], want["amax"]):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=AMAX_RTOL, atol=0, err_msg=where)
    json.dumps(got)


def test_snapshot_matches_reference_every_tick(model):
    """Sampled at 0.7 on the oversubscribed pool, both engines stepped
    together: the port's snapshot equals the reference's before ``begin``
    (seed None) and after every tick."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jcfg, jparams, JServe(temperature=0.7, **_OS))
    teng = PagedEngine(tcfg, tparams, ServeConfig(temperature=0.7, **_OS),
                       device="cpu")
    for p in _prompts():
        jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=16))
        teng.submit(Request(prompt=p.copy(), max_new_tokens=16))
    _assert_snapshots_match(teng.snapshot(), jeng.snapshot(), "submitted")
    assert teng.snapshot()["seed"] is None
    jeng.begin(7)
    teng.begin(7)
    ticks = 0
    while jeng.pending() or teng.pending():
        jeng.step()
        teng.step()
        ticks += 1
        _assert_snapshots_match(teng.snapshot(), jeng.snapshot(), ticks)
    state = teng.snapshot()
    assert state["counters"]["preemptions"] >= 1 and state["seed"] == 7
    assert len(state["amax"]) == 2            # k, v stacked over 2 layers


def _per_layer_amax(caches):
    return [np.concatenate([c["k_amax"].numpy(), c["v_amax"].numpy()])
            for c in _layers(caches)]


def test_reference_snapshot_restores_into_port(model):
    """At every tick of the reference's oversubscribed sampled run, its
    snapshot restored into a fresh port engine: each layer's restored
    scales equal the reference's own restore of that snapshot bit for bit
    (this pins the order of the scale leaves), and the port finishes the
    trace with the reference's tokens."""
    jcfg, tcfg, jparams, tparams = model
    jeng = JEngine(jcfg, jparams, JServe(temperature=0.7, **_OS))
    for p in _prompts():
        jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=16))
    jeng.begin(7)
    states = []
    while jeng.pending():
        jeng.step()
        states.append(jeng.snapshot())
    want = [r.generated for r in jeng.requests.values()]
    assert jeng.counters["preemptions"] >= 1
    for k, state in enumerate(states[:-1]):
        teng = PagedEngine(tcfg, tparams, ServeConfig(temperature=0.7,
                                                      **_OS), device="cpu")
        teng.restore(json.loads(json.dumps(state)))
        if k in (0, len(states) // 2):
            jrest = JEngine(jcfg, jparams, JServe(temperature=0.7, **_OS))
            jrest.restore(state)
            ref_layers = TT.caches_from_numpy(
                jax.tree.map(np.asarray, jrest.caches), tcfg)
            for g, w in zip(_per_layer_amax(teng.caches),
                            _per_layer_amax(ref_layers)):
                np.testing.assert_array_equal(g, w)
        assert teng.snapshot()["amax"] == state["amax"]
        teng.run(7)
        assert [teng.requests[rid].generated
                for rid in sorted(teng.requests)] == want, k


def test_restore_guards(model):
    """tests/test_chaos.py's guards: restore() refuses a used engine and an
    unknown snapshot version, and a snapshot with scale leaves the cache
    has no home for."""
    _, tcfg, _, tparams = model
    scfg = ServeConfig(max_len=32, max_slots=2, prefill_bucket=8,
                       page_size=8)
    eng = PagedEngine(tcfg, tparams, scfg, device="cpu")
    reqs = [Request(prompt=p[:L], max_new_tokens=3)
            for p, L in zip(_prompts(), (6, 9))]
    eng.generate(reqs, seed=0)
    state = eng.snapshot()
    json.dumps(state)
    assert state["version"] == 1 and state["ticks"] == eng.ticks
    assert [r["generated"] for r in state["requests"]] == \
        [r.generated for r in reqs]
    with pytest.raises(RuntimeError, match="freshly constructed"):
        eng.restore(state)
    fresh = PagedEngine(tcfg, tparams, scfg, device="cpu")
    with pytest.raises(ValueError, match="version"):
        fresh.restore({**state, "version": 99})
    with pytest.raises(ValueError, match="extra quant-scale"):
        PagedEngine(tcfg, tparams, scfg, device="cpu").restore(
            {**state, "amax": state["amax"] + [[0.0] * 4]})


def test_crash_restore_identical_at_every_tick(model, tmp_path):
    """tests/test_chaos.py's sweep on the port alone: snapshot every tick,
    kill the host at tick k for every k of the trace (in the queue, in a
    multi-tick chunked prefill, in decode, at the end), restore, and
    require the undisturbed run's tokens."""
    _, tcfg, _, tparams = model
    scfg = ServeConfig(max_len=48, max_slots=2, prefill_bucket=8,
                       page_size=8, prefill_chunk=8, snapshot_every=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, L, dtype=np.int32) for L in (6, 17)]

    def trace():
        return [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]

    ref = trace()
    ref_eng = PagedEngine(tcfg, tparams, scfg, device="cpu")
    ref_eng.generate(ref, seed=0)
    assert ref_eng.ticks >= 4
    for k in range(ref_eng.ticks):
        out, rep = serve_with_chaos(
            lambda: PagedEngine(tcfg, tparams, scfg, device="cpu"), trace(),
            seed=0, plan=FaultPlan.scripted([("crash", k)]),
            snapshot_dir=str(tmp_path / f"k{k}"))
        assert rep["crashes"] == 1 and rep["restores"] == 1, k
        assert [r.generated for r in out] == [r.generated for r in ref], k
