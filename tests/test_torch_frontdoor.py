"""The port's async front door (streaming, fair admission, the SLA mapper,
shutdown with snapshot and restore, disaggregation behind the door) and
``launch/serve_async`` held against the reference on the CPU.

Reduced stablelm-1.6b (alpha 0.8) with the reference's weights carried
across, on tests/test_frontdoor.py's traces and geometry (page_size 8,
prefill_bucket 8, max_len 64).  The reference's cases that serve its
default ``attn_impl="xla"`` run here with both packages on
``bitstopper_xla``, at the reference case's trace, temperature and seed
(tests/test_torch_dense_frontdoor.py holds them on ``xla``).
Streamed tokens, admission logs and the ticks at which each stream got its
first token and finished must equal the reference door's."""

import asyncio
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.runtime import ManualClock as JManualClock
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving.frontdoor import AsyncFrontDoor as JDoor
from repro.serving.frontdoor import DisaggController as JDisagg
from repro.serving.frontdoor import SlaMapper as JSla
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.launch import serve_async
from repro_torch.models import transformer as TT
from repro_torch.runtime import ManualClock
from repro_torch.serving import PagedEngine, ServeConfig
from repro_torch.serving.frontdoor import (AsyncFrontDoor, DisaggController,
                                           SlaMapper)

# tests/test_frontdoor.py's geometry.
_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(_BASE, **kw)
    if pkg == "ref":
        return JEngine(jcfg, jparams, JServe(**kw))
    return PagedEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")


def _door(pkg, backend, **kw):
    return (JDoor if pkg == "ref" else AsyncFrontDoor)(backend, **kw)


def _sync(model, lens, max_new=5, seed=0, **kw):
    """The reference's synchronous colocated trace."""
    rng = np.random.default_rng(0)
    reqs = [JRequest(prompt=rng.integers(0, 256, L, dtype=np.int32),
                     max_new_tokens=max_new) for L in lens]
    _engine(model, "ref", **kw).generate(reqs, seed=seed)
    return [r.generated for r in reqs]


def _stream_all(door, rids):
    """tests/test_frontdoor.py's ``_stream_all``: drive the door to the end
    of a drain; each rid's streamed tokens."""
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


def _door_trace(model, pkg, lens, max_new=5, seed=0, backend=None, **kw):
    door = _door(pkg, backend if backend is not None
                 else _engine(model, pkg, **kw), seed=seed)
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


# (lens, max_new, seed, serving config of the door, of the synchronous
# reference): tests/test_frontdoor.py's streaming cases.
_STREAM_CASES = {
    "sampled": ((5, 9, 7), 5, 7, dict(temperature=0.9),
                dict(temperature=0.9)),
    "plain": ((5, 11, 7), 5, 0, dict(fused_decode=False),
              dict(fused_decode=False)),
    "fused": ((5, 11, 7), 5, 0, dict(fused_decode=True),
              dict(fused_decode=True)),
    "speculative": ((12, 9), 8, 0, dict(speculative="ngram", draft_k=3),
                    dict()),
    "oversubscribed_sampled": (
        (12, 9, 11), 16, 7,
        dict(max_slots=3, pool_blocks=10, oversubscribe=True,
             temperature=1.0),
        dict(max_slots=3, temperature=1.0)),
}


@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_streamed_tokens_match_reference(model, case):
    """Streamed tokens equal the reference door's and its synchronous
    trace; the admission log, the ticks and each stream's first-token and
    finish ticks equal the reference door's."""
    lens, max_new, seed, kw, sync_kw = _STREAM_CASES[case]
    want = _sync(model, lens, max_new=max_new, seed=seed, **sync_kw)
    jtoks, jdoor = _door_trace(model, "ref", lens, max_new, seed, **kw)
    ttoks, tdoor = _door_trace(model, "port", lens, max_new, seed, **kw)
    assert jtoks == want
    assert ttoks == want
    _same_door(tdoor, jdoor)
    assert tdoor.admission_log == list(range(len(lens)))
    assert tdoor.backend.counters == jdoor.backend.counters
    if case == "oversubscribed_sampled":
        assert tdoor.backend.counters["preemptions"] >= 1
    if case == "speculative":
        # Random prompts give the n-gram drafter nothing to match, in both
        # packages alike (the counters above are equal).
        assert tdoor.backend._drafter is not None


def test_fairness_admission_order(model):
    """Admission round-robins one request per non-empty SLO class, strict
    first; rids stay in arrival order.  The log, the tokens and the ticks
    equal the reference door's."""
    out = {}
    for pkg in ("ref", "port"):
        door = _door(pkg, _engine(model, pkg), seed=0)
        door.start()
        rng = np.random.default_rng(0)
        p = [rng.integers(0, 256, L, dtype=np.int32)
             for L in (5, 9, 7, 12, 6)]
        rids = [door.submit(p[0], 3, slo="besteffort"),
                door.submit(p[1], 3, slo="besteffort"),
                door.submit(p[2], 3, slo="besteffort"),
                door.submit(p[3], 3, slo="strict"),
                door.submit(p[4], 3, slo="standard")]
        out[pkg] = (rids, _stream_all(door, rids), door)
    assert out["port"][0] == [0, 1, 2, 3, 4]
    assert out["port"][2].admission_log == [3, 4, 0, 1, 2]
    assert out["port"][1] == out["ref"][1]
    _same_door(out["port"][2], out["ref"][2])


def test_sla_mapper_and_deadline_s(model):
    """The mapper quantizes up at the granularity, floors at one tick,
    follows the EMA of observed ticks and refuses a deadline <= 0, as the
    reference's does on a grid of inputs; a door maps ``deadline_s`` onto
    the request's ``deadline_ticks`` through it, refuses both forms at
    once, and serves the request as the reference door does."""
    for args in ((0.125, 0.25), (1e-3, 1e-2), (0.01, 0.03)):
        t, j = SlaMapper(*args), JSla(*args)
        for d in (1e-4, 0.01, 0.1, 0.125, 0.126, 0.25, 0.3749999, 0.5, 2.0):
            assert t.quantize(d) == j.quantize(d)
            assert t.ticks_for(d) == j.ticks_for(d)
        for dt in (0.0, -1.0, 0.125, 0.2, 0.07):
            t.observe_tick(dt)
            j.observe_tick(dt)
            assert t.tick_estimate == j.tick_estimate
            assert t.observed_ticks == j.observed_ticks
            assert t.ticks_for(0.5) == j.ticks_for(0.5)
    sla = SlaMapper(granularity=0.125)
    assert sla.quantize(0.1) == 0.125 and sla.quantize(0.126) == 0.25
    with pytest.raises(ValueError):
        sla.ticks_for(0.0)
    for bad in (dict(granularity=0.0), dict(default_tick_s=-1.0)):
        with pytest.raises(ValueError):
            SlaMapper(**bad)

    reqs = {}
    for pkg, Clock, Sla in (("ref", JManualClock, JSla),
                            ("port", ManualClock, SlaMapper)):
        door = _door(pkg, _engine(model, pkg),
                     clock=Clock(granularity=0.125),
                     sla=Sla(granularity=0.125, default_tick_s=0.25),
                     seed=0)
        door.start()
        rng = np.random.default_rng(0)
        rid = door.submit(rng.integers(0, 256, 5, dtype=np.int32),
                          max_new_tokens=32, deadline_s=0.5)
        with pytest.raises(ValueError, match="not both"):
            door.submit(rng.integers(0, 256, 5, dtype=np.int32),
                        deadline_s=0.5, deadline_ticks=3)
        _stream_all(door, [rid])
        reqs[pkg] = door.result(rid)
    t, j = reqs["port"], reqs["ref"]
    assert t.deadline_ticks == j.deadline_ticks == 2
    assert t.deadline_hit and j.deadline_hit
    assert t.generated == j.generated and len(t.generated) < 32


def test_shutdown_refusals(model):
    """After shutdown the door refuses submissions; an unknown mode is
    refused; a snapshot directory needs a snapshot-capable backend; a
    stream of an unknown rid raises."""
    door = AsyncFrontDoor(_engine(model, "port"), seed=0)
    door.start()
    door.shutdown("drain")
    with pytest.raises(RuntimeError, match="shutting down"):
        door.submit(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="mode"):
        door.shutdown("now")
    with pytest.raises(ValueError, match="slo"):
        AsyncFrontDoor(_engine(model, "port")).submit(
            np.zeros(4, np.int32), slo="gold")
    with pytest.raises(KeyError):
        asyncio.run(door.stream(99).__anext__())
    ctl = DisaggController(_engine(model, "port", max_slots=1),
                           _engine(model, "port"))
    with pytest.raises(ValueError, match="snapshot-capable"):
        AsyncFrontDoor(ctl, snapshot_dir="unused")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_snapshot_shutdown_restore_lossless(model, tmp_path, writer):
    """A snapshot shutdown once a stream holds 2 tokens (the reference
    test's), then a fresh port door on the directory restores, and every
    stream replays from token zero to the undisturbed synchronous trace.
    With ``writer="ref"`` the snapshot is a reference door's."""
    want = _sync(model, (5, 9, 7))
    snap = str(tmp_path / "snap")
    door = _door(writer, _engine(model, writer), snapshot_dir=snap, seed=0)
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
    assert door.interrupted
    assert any(partial.values())

    door2 = AsyncFrontDoor(_engine(model, "port"), snapshot_dir=snap, seed=0)
    assert door2.start() is True and door2.restored
    assert door2._next_rid == 3

    async def phase2():
        task = asyncio.create_task(door2.run())

        async def collect(rid):
            return [tok async for tok in door2.stream(rid)]

        gathered = asyncio.gather(*(collect(r) for r in rids))
        door2.shutdown("drain")
        toks = await gathered
        await task
        return toks

    full = asyncio.run(phase2())
    assert full == want
    for rid, seen in partial.items():
        assert full[rids.index(rid)][:len(seen)] == seen
    assert door2.backend.pool.available() == door2.backend.pool.capacity


def test_disagg_through_door(model):
    """The disaggregated controller behind the door: streamed tokens equal
    the synchronous colocated trace and the reference's disaggregated
    door's, with its ticks and transfer counters."""
    want = _sync(model, (5, 9, 7))
    out = {}
    for pkg, D in (("ref", JDisagg), ("port", DisaggController)):
        ctl = D(_engine(model, pkg, max_slots=1), _engine(model, pkg))
        out[pkg] = _door_trace(model, pkg, (5, 9, 7), backend=ctl)
    assert out["ref"][0] == want
    assert out["port"][0] == want
    tdoor, jdoor = out["port"][1], out["ref"][1]
    _same_door(tdoor, jdoor)
    assert tdoor.backend.counters == jdoor.backend.counters
    assert tdoor.backend.counters["prefixes_transferred"] == 3
    assert tdoor.backend.decode_engine.pool.live_blocks() == 0


def test_serve_async_demo_runs(capsys):
    """``serve_async --demo 3 --device cpu`` streams three requests to the
    end through its ``main``; ``--disagg`` streams the same tokens."""
    args = ["--demo", "3", "--device", "cpu", "--new-tokens", "6",
            "--max-prompt", "24"]
    colocated = serve_async.main(args)
    out = capsys.readouterr().out
    assert sorted(colocated) == [0, 1, 2]
    assert all(len(t) == 6 for t in colocated.values())
    assert "admission order: [0, 1, 2]" in out
    assert serve_async.main(args + ["--disagg"]) == colocated
    with pytest.raises(SystemExit):
        serve_async.main(args + ["--disagg", "--snapshot-dir", "unused"])


def test_serve_async_socket_talks_to_example_client():
    """The line-JSON server (``serve_async --device cpu``) streams to
    ``examples/stream_client.py`` as it is: the client's two requests each
    end with a final transcript equal to the tokens streamed (the client
    asserts it), the deadline-carrying one truncated; SIGTERM drains the
    server, which then exits."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    server = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve_async",
         "--device", "cpu", "--port", "0"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = server.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:"), line
        port = line.split(":")[1].split()[0]
        client = subprocess.run(
            [sys.executable, str(root / "examples" / "stream_client.py"),
             "--port", port, "--deadline-s", "0.001"],
            cwd=root, env=env, capture_output=True, text=True, timeout=120)
        assert client.returncode == 0, client.stderr
        assert "[A] rid 0 done:" in client.stdout
        assert "[B] rid 1 deadline:" in client.stdout
        server.send_signal(signal.SIGTERM)
        rest = server.communicate(timeout=60)[0]
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert server.returncode == 0
    assert "stopped after" in rest and "admitted 2 request(s)" in rest
