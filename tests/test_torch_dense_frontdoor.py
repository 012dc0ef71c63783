"""The reference's front door cases on its default ``attn_impl="xla"``
(tests/test_frontdoor.py), served by the port's dense paged engine and
held against the reference door on the CPU.

tests/test_torch_frontdoor.py and tests/test_torch_engine_api.py hold the
same cases on ``bitstopper_xla``; here both packages serve reduced
stablelm-1.6b on ``xla`` with the reference's weights carried across, at
the reference case's trace, temperature and seed (page_size 8,
prefill_bucket 8, max_len 64).  Streamed tokens, admission logs, the
ticks at which each stream got its first token and finished, counters and
transfer counters must equal the reference's."""

import asyncio

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.models import transformer as JT
from repro.runtime import ManualClock as JManualClock
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving.frontdoor import AsyncFrontDoor as JDoor
from repro.serving.frontdoor import DisaggController as JDisagg
from repro.serving.frontdoor import SlaMapper as JSla
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as TT
from repro_torch.runtime import ManualClock
from repro_torch.serving import PagedEngine, Request, ServeConfig
from repro_torch.serving.frontdoor import (AsyncFrontDoor, DisaggController,
                                           SlaMapper)

# tests/test_frontdoor.py's geometry.
_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b")          # attn_impl="xla"
    tcfg = reduced_config("stablelm-1.6b")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(_BASE, **kw)
    if pkg == "ref":
        return JEngine(jcfg, jparams, JServe(**kw))
    return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")


def _sync(model, lens, max_new=5, seed=0, **kw):
    """The reference's synchronous colocated trace."""
    rng = np.random.default_rng(0)
    reqs = [JRequest(prompt=rng.integers(0, 256, L, dtype=np.int32),
                     max_new_tokens=max_new) for L in lens]
    _engine(model, "ref", **kw).generate(reqs, seed=seed)
    return [r.generated for r in reqs]


def _stream_all(door, rids):
    async def go():
        task = asyncio.create_task(door.run())

        async def collect(rid):
            return [tok async for tok in door.stream(rid)]

        gathered = asyncio.gather(*(collect(r) for r in rids))
        door.shutdown("drain")
        toks = await gathered
        await task
        return toks

    return asyncio.run(go())


def _door_trace(pkg, backend, lens, max_new=5, seed=0, **door_kw):
    door = (JDoor if pkg == "ref" else AsyncFrontDoor)(backend, seed=seed,
                                                      **door_kw)
    door.start()
    rng = np.random.default_rng(0)
    rids = [door.submit(rng.integers(0, 256, L, dtype=np.int32),
                        max_new_tokens=max_new) for L in lens]
    return _stream_all(door, rids), door


def _same_door(tdoor, jdoor):
    assert tdoor.admission_log == jdoor.admission_log
    assert tdoor.ticks_run == jdoor.ticks_run
    assert tdoor.first_token_tick == jdoor.first_token_tick
    assert tdoor.finish_tick == jdoor.finish_tick


# (lens, max_new, seed, the door engine's config, the synchronous
# reference's): tests/test_frontdoor.py:152, :176 and :186.
_STREAM_CASES = {
    "seeded": ((5, 9, 7), 5, 7, dict(temperature=0.9),
               dict(temperature=0.9)),
    "speculative": ((12, 9), 8, 0, dict(speculative="ngram", draft_k=3),
                    dict()),
    "oversubscribed_seeded": (
        (12, 9, 11), 16, 7,
        dict(max_slots=3, pool_blocks=10, oversubscribe=True,
             temperature=1.0),
        dict(max_slots=3, temperature=1.0)),
}


@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_streamed_tokens_match_reference_xla(model, case):
    """Streamed tokens equal the synchronous trace and the reference
    door's; the door's log and ticks and the engine's counters equal the
    reference's."""
    lens, max_new, seed, kw, sync_kw = _STREAM_CASES[case]
    want = _sync(model, lens, max_new=max_new, seed=seed, **sync_kw)
    jtoks, jdoor = _door_trace("ref", _engine(model, "ref", **kw), lens,
                               max_new, seed)
    ttoks, tdoor = _door_trace("port", _engine(model, "port", **kw), lens,
                               max_new, seed)
    assert jtoks == want and ttoks == want
    _same_door(tdoor, jdoor)
    assert tdoor.backend.counters == jdoor.backend.counters
    if case == "oversubscribed_seeded":
        assert tdoor.backend.counters["preemptions"] >= 1


def test_fairness_admission_order_xla(model):
    """tests/test_frontdoor.py:206: one request per non-empty SLO class,
    strict first; the log, tokens and ticks equal the reference door's."""
    out = {}
    for pkg in ("ref", "port"):
        door = (JDoor if pkg == "ref" else AsyncFrontDoor)(
            _engine(model, pkg), seed=0)
        door.start()
        rng = np.random.default_rng(0)
        p = [rng.integers(0, 256, L, dtype=np.int32)
             for L in (5, 9, 7, 12, 6)]
        rids = [door.submit(p[0], 3, slo="besteffort"),
                door.submit(p[1], 3, slo="besteffort"),
                door.submit(p[2], 3, slo="besteffort"),
                door.submit(p[3], 3, slo="strict"),
                door.submit(p[4], 3, slo="standard")]
        out[pkg] = (_stream_all(door, rids), door)
    assert out["port"][1].admission_log == [3, 4, 0, 1, 2]
    assert out["port"][0] == out["ref"][0]
    _same_door(out["port"][1], out["ref"][1])


def test_door_maps_deadline_s_xla(model):
    """tests/test_frontdoor.py:257: ``deadline_s=0.5`` at a 0.25 s tick
    estimate becomes two ticks, and the truncated stream equals the
    reference door's."""
    reqs = {}
    for pkg, Clock, Sla in (("ref", JManualClock, JSla),
                            ("port", ManualClock, SlaMapper)):
        door = (JDoor if pkg == "ref" else AsyncFrontDoor)(
            _engine(model, pkg), clock=Clock(granularity=0.125),
            sla=Sla(granularity=0.125, default_tick_s=0.25), seed=0)
        door.start()
        rng = np.random.default_rng(0)
        rid = door.submit(rng.integers(0, 256, 5, dtype=np.int32),
                          max_new_tokens=32, deadline_s=0.5)
        _stream_all(door, [rid])
        reqs[pkg] = door.result(rid)
    t, j = reqs["port"], reqs["ref"]
    assert t.deadline_ticks == j.deadline_ticks == 2
    assert t.deadline_hit and j.deadline_hit
    assert t.generated == j.generated and len(t.generated) < 32


def test_snapshot_shutdown_restore_lossless_xla(model, tmp_path):
    """tests/test_frontdoor.py:374: a snapshot shutdown once a stream holds
    2 tokens, then a fresh door on the directory restores, and every
    stream replays to the undisturbed synchronous trace."""
    want = _sync(model, (5, 9, 7))
    snap = str(tmp_path / "snap")
    door = AsyncFrontDoor(_engine(model, "port"), snapshot_dir=snap, seed=0)
    assert door.start() is False
    rng = np.random.default_rng(0)
    rids, partial = [], {}

    async def phase1():
        for L in (5, 9, 7):
            rid = door.submit(rng.integers(0, 256, L, np.int32),
                              max_new_tokens=5)
            rids.append(rid)
            partial[rid] = []

        async def collect(rid):
            async for tok in door.stream(rid):
                partial[rid].append(tok)

        task = asyncio.create_task(door.run())
        collectors = [asyncio.create_task(collect(r)) for r in rids]
        for _ in range(200):
            await asyncio.sleep(0)
            if any(len(v) >= 2 for v in partial.values()):
                break
        door.shutdown("snapshot")
        await task
        await asyncio.gather(*collectors)

    asyncio.run(phase1())
    assert door.interrupted and any(partial.values())
    door2 = AsyncFrontDoor(_engine(model, "port"), snapshot_dir=snap, seed=0)
    assert door2.start() is True and door2.restored
    full = _stream_all(door2, rids)
    assert full == want
    for rid, seen in partial.items():
        assert full[rids.index(rid)][:len(seen)] == seen
    assert door2.backend.pool.available() == door2.backend.pool.capacity


def test_disagg_parity_xla_seeded(model):
    """tests/test_frontdoor.py:291: disaggregated serving (a one-slot
    prefill engine handing detached prefixes to a two-slot decode engine)
    gives the colocated trace, with the reference's transfer counters and
    both pools drained."""
    want = _sync(model, (5, 9, 7, 12), seed=7, temperature=0.9)
    out = {}
    for pkg, D, R in (("ref", JDisagg, JRequest),
                      ("port", DisaggController, Request)):
        ctl = D(_engine(model, pkg, max_slots=1, temperature=0.9),
                _engine(model, pkg, temperature=0.9))
        rng = np.random.default_rng(0)
        reqs = [R(prompt=rng.integers(0, 256, L, dtype=np.int32),
                  max_new_tokens=5) for L in (5, 9, 7, 12)]
        ctl.generate(reqs, seed=7)
        out[pkg] = (ctl, [r.generated for r in reqs])
    (jctl, jt), (tctl, tt) = out["ref"], out["port"]
    assert tt == jt == want
    assert tctl.counters == jctl.counters
    assert tctl.xfer.counters == jctl.xfer.counters
    assert tctl.xfer.counters["prefixes_transferred"] == 4
    assert tctl.decode_engine.pool.live_blocks() == 0
    assert tctl.prefill_engine.pool.live_blocks() == 0
