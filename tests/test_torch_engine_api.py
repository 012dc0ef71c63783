"""The port's engine API (prefill, extract, release, insert,
generate_step), prefill/decode disaggregation and traffic reports held
against the reference on the CPU.

Reduced stablelm-1.6b with the reference's weights carried across, on the
reference's own traces and geometry (tests/test_frontdoor.py: page_size 8,
prefill_bucket 8, max_len 64).  The reference's cases that serve its
default ``attn_impl="xla"`` run here with both packages on
``bitstopper_xla``, at the reference case's trace, temperature and seed
(tests/test_torch_dense_frontdoor.py holds them on ``xla``).  Tokens,
events and integer counters must be equal; scales agree within
``AMAX_RTOL``."""

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import InsufficientBlocks as JInsufficient
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving.engine import _amax_leaves as j_amax_leaves
from repro.serving.frontdoor import DisaggController as JDisagg
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import (InsufficientBlocks, PagedEngine, Prefix,
                                 Request, ServeConfig)
from repro_torch.serving.engine import _amax_arrays
from repro_torch.serving.frontdoor import DisaggController, TransferQueue

AMAX_RTOL = 1e-6      # a few f32 ulps: each package's own K/V projections

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


def _reqs(pkg, lens, max_new=5, vocab=256, seed=0):
    """tests/test_frontdoor.py's ``_reqs``."""
    R = JRequest if pkg == "ref" else Request
    rng = np.random.default_rng(seed)
    return [R(prompt=rng.integers(0, vocab, L, dtype=np.int32),
              max_new_tokens=max_new) for L in lens]


def _sync(model, lens, max_new=5, seed=0, **kw):
    """The reference's synchronous colocated trace."""
    reqs = _reqs("ref", lens, max_new)
    _engine(model, "ref", **kw).generate(reqs, seed=seed)
    return [r.generated for r in reqs]


def _disagg(model, pkg, decode_slots=2, **kw):
    D = JDisagg if pkg == "ref" else DisaggController
    return D(_engine(model, pkg, max_slots=1, **kw),
             _engine(model, pkg, max_slots=decode_slots, **kw))


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
# the engine API
# ---------------------------------------------------------------------------


def _api_loop(eng, reqs):
    """tests/test_frontdoor.py's loop: prefill each request to a Prefix,
    insert it into a free slot, loop generate_step.  Returns each rid's
    tokens as the API handed them out."""
    eng.begin(0)
    out, pending, live = {}, list(reqs), 0
    while pending or live:
        while pending and eng.free_slots():
            req = pending.pop(0)
            eng.insert(eng.prefill(req), eng.free_slots()[0])
            out[req.rid] = list(req.generated)    # the first token
            live += 1
        for ev in eng.generate_step():
            out.setdefault(ev["rid"], []).extend(ev["tokens"])
            if ev["finished"]:
                live -= 1
    return [out[r.rid] for r in reqs]


def test_engine_api_loop_matches_reference(model):
    """The prefill -> insert -> generate_step loop gives the reference's
    loop's tokens and its generate()'s, the same counters (the three API
    counters among them), the same scales, and a clean pool."""
    want = _sync(model, (5, 9, 7))
    jeng = _engine(model, "ref")
    jgot = _api_loop(jeng, _reqs("ref", (5, 9, 7)))
    teng = _engine(model, "port")
    treqs = _reqs("port", (5, 9, 7))
    tgot = _api_loop(teng, treqs)
    assert jgot == want
    assert tgot == want
    assert [r.generated for r in treqs] == want
    assert teng.counters == jeng.counters
    assert teng.counters["prefixes_prefilled"] == 3
    assert teng.counters["prefixes_inserted"] == 3
    assert teng.counters["prefix_transfers"] == 0
    assert teng.ticks == jeng.ticks
    assert teng.pool.available() == teng.pool.capacity
    assert teng.pool.snapshot() == jeng.pool.snapshot()
    _assert_grids_close(_amax("port", teng), _amax("ref", jeng))


def test_generate_step_events_match_reference_tick_by_tick(model):
    """generate_step's events equal the reference's at every tick on the
    reference's oversubscribed sampled trace (a preemption emits no event),
    with a fourth, besteffort request whose deadline lapses in the queue
    (a terminal event with no tokens)."""
    kw = dict(max_slots=3, pool_blocks=10, oversubscribe=True,
              temperature=1.0)
    engs = {pkg: _engine(model, pkg, **kw) for pkg in ("ref", "port")}
    for pkg, eng in engs.items():
        eng.begin(7)
        for r in _reqs(pkg, (12, 9, 11), max_new=16):
            eng.submit(r)
        R = JRequest if pkg == "ref" else Request
        eng.submit(R(prompt=np.arange(6, dtype=np.int32), max_new_tokens=4,
                     slo="besteffort", deadline_ticks=2))
    n_events = 0
    while engs["ref"].pending():
        want = engs["ref"].generate_step()
        got = engs["port"].generate_step()
        assert got == want, f"tick {engs['ref'].ticks}"
        n_events += len(got)
    assert not engs["port"].pending()
    assert n_events > 0
    t, j = engs["port"], engs["ref"]
    assert t.counters == j.counters
    assert t.counters["preemptions"] >= 1
    assert t.requests[3].shed_reason == "deadline"


def test_insert_into_occupied_slot_refused(model):
    """Inserting into a slot that serves a live request raises and leaves
    the resident request alone: it completes with the reference's
    tokens."""
    toks = {}
    for pkg in ("ref", "port"):
        eng = _engine(model, pkg)
        eng.begin(0)
        r0, r1 = _reqs(pkg, (5, 7), max_new=8)
        eng.insert(eng.prefill(r0), 0)
        p1 = eng.prefill(r1)
        with pytest.raises(RuntimeError, match="occupied slot"):
            eng.insert(p1, 0)
        eng.release(p1)
        while eng.pending():
            eng.step()
        assert len(r0.generated) == 8
        assert eng.pool.available() == eng.pool.capacity
        toks[pkg] = r0.generated
    assert toks["port"] == toks["ref"]


def test_insufficient_blocks_is_retryable_and_release_returns_refs(model):
    """A pool full right now raises the retryable InsufficientBlocks and
    keeps no reference; a request that could never fit is a ValueError;
    release() returns every reference of an attached prefix; once the
    resident request finishes the refused prefill succeeds.  The pool's
    free count follows the reference's at every step."""
    seen = {}
    for pkg, exc in (("ref", JInsufficient), ("port", InsufficientBlocks)):
        eng = _engine(model, pkg, pool_blocks=6)   # 5 usable blocks
        eng.begin(0)
        r1, r2 = _reqs(pkg, (12, 26), max_new=12)
        (r3,) = _reqs(pkg, (10,), max_new=4, seed=1)
        avail = [eng.pool.available()]
        eng.insert(eng.prefill(r1), 0)               # 3 of the 5 blocks
        avail.append(eng.pool.available())
        with pytest.raises(exc):
            eng.prefill(r2)                          # 4 context blocks
        avail.append(eng.pool.available())
        (huge,) = _reqs(pkg, (40,), max_new=16)
        with pytest.raises(ValueError, match="pool"):
            eng.prefill(huge)
        p3 = eng.prefill(r3)                         # 2 blocks, attached
        avail.append(eng.pool.available())
        eng.release(p3)
        assert p3.blocks == [] and p3.pool is None
        avail.append(eng.pool.available())
        while eng.pending():
            eng.step()
        avail.append(eng.pool.available())
        r2.rid = -1                                  # retried afresh
        p2 = eng.prefill(r2)
        eng.insert(p2, 0)
        while eng.pending():
            eng.step()
        avail.append(eng.pool.available())
        seen[pkg] = (avail, r1.generated, r2.generated)
    assert seen["port"] == seen["ref"]
    avail = seen["port"][0]
    assert avail[1] == avail[2] == avail[4] and avail[3] == avail[4] - 2
    assert avail[5] == avail[6] == avail[0]


def test_disagg_parity_sampled(model):
    """Disaggregated serving sampled at temperature 0.9, seed 7
    (tests/test_frontdoor.py's seeded disaggregation case on
    ``bitstopper_xla``): the reference's disaggregated tokens, which equal
    its colocated trace; the same transfer counters; both pools drain."""
    kw = dict(temperature=0.9)
    want = _sync(model, (5, 9, 7, 12), seed=7, **kw)
    out = {}
    for pkg in ("ref", "port"):
        ctl = _disagg(model, pkg, **kw)
        reqs = _reqs(pkg, (5, 9, 7, 12))
        ctl.generate(reqs, seed=7)
        out[pkg] = ([r.generated for r in reqs], ctl)
    assert out["ref"][0] == want
    assert out["port"][0] == want
    t, j = out["port"][1], out["ref"][1]
    assert t.xfer.counters == j.xfer.counters
    assert t.xfer.counters["prefixes_transferred"] == 4
    assert t.counters == j.counters
    assert t.decode_engine.pool.live_blocks() == 0
    _assert_grids_close(_amax("port", t.decode_engine),
                        _amax("ref", j.decode_engine))


def test_disagg_parity_fused(model):
    """Fused decode on the decode instance (the port's plain oracle on the
    CPU, the reference's Pallas kernel in interpret mode): the planes are
    rebuilt at insert from the transferred K rows under the merged scales,
    and the tokens equal the reference's disaggregated and colocated
    runs."""
    kw = dict(fused_decode=True)
    want = _sync(model, (5, 11, 7), **kw)
    out = {}
    for pkg in ("ref", "port"):
        ctl = _disagg(model, pkg, **kw)
        reqs = _reqs(pkg, (5, 11, 7))
        ctl.generate(reqs, seed=0)
        out[pkg] = ([r.generated for r in reqs], ctl)
    assert out["ref"][0] == want
    assert out["port"][0] == want
    t, j = out["port"][1], out["ref"][1]
    assert t.counters == j.counters
    _assert_grids_close(_amax("port", t.decode_engine),
                        _amax("ref", j.decode_engine))


def test_transfer_queue_and_controller_refusals(model):
    """The transfer queue takes detached prefixes only; the controller
    refuses one instance passed twice, a shared pool, and page sizes,
    temperatures or eos ids that differ, as the reference does."""
    q = TransferQueue()
    with pytest.raises(ValueError, match="DETACHED"):
        q.put(Prefix(req=Request(prompt=np.zeros(3, np.int32)),
                     chain=np.zeros(3, np.int32), length=3, last_token=0,
                     blocks=[1]), 1)
    assert len(q) == 0 and q.counters["prefixes_transferred"] == 0
    eng = _engine(model, "port")
    with pytest.raises(ValueError, match="distinct"):
        DisaggController(eng, eng)
    other = _engine(model, "port")
    other.pool = eng.pool
    with pytest.raises(ValueError, match="distinct"):
        DisaggController(eng, other)
    for field, a, b in (("page_size", 8, 16), ("temperature", 0.0, 0.9),
                        ("eos_id", None, 3)):
        with pytest.raises(ValueError, match=field):
            DisaggController(_engine(model, "port", max_slots=1,
                                     **{field: a}),
                             _engine(model, "port", **{field: b}))


def test_reference_prefix_inserts_into_port_decode_engine(model):
    """A prefix prefilled and extracted by the reference's engine inserts
    into the port's decode engine (either package's payload has one layout)
    and decodes to the reference's disaggregated tokens, with the merged
    scales of the reference's decode engine."""
    kw = dict(fused_decode=True)
    jctl = _disagg(model, "ref", **kw)
    jreqs = _reqs("ref", (5, 11, 7))
    jctl.generate(jreqs, seed=0)
    jcfg, _, jparams, _ = model
    mixed = DisaggController(
        JEngine(jcfg, jparams, JServe(**dict(_BASE, max_slots=1, **kw))),
        _engine(model, "port", **kw))
    treqs = _reqs("port", (5, 11, 7))
    mixed.generate(treqs, seed=0)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert mixed.xfer.counters == jctl.xfer.counters
    assert mixed.decode_engine.counters == jctl.decode_engine.counters
    _assert_grids_close(_amax("port", mixed.decode_engine),
                        _amax("ref", jctl.decode_engine))


# ---------------------------------------------------------------------------
# traffic reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scfg", [
    dict(_BASE),
    dict(max_len=512, max_slots=4, page_size=16),
    dict(max_len=100, max_slots=3, page_size=12, prefill_bucket=4),
])
def test_kv_bytes_contiguous_equiv_matches_reference(model, scfg):
    """The contiguous cache a ServeConfig would reserve: the reference's
    figure exactly (f32 rows)."""
    t = _engine(model, "port", **scfg)
    j = _engine(model, "ref", **scfg)
    assert t.kv_bytes_contiguous_equiv() == j.kv_bytes_contiguous_equiv()
    assert t.kv_bytes_contiguous_equiv() > t.kv_bytes_resident(peak=False)


def _hot(model, scale):
    """The model with layer 0's q and k projections scaled, so that the
    attention is peaked and LATS prunes (random weights attend nearly
    uniformly and prune nothing)."""
    jcfg, tcfg, jparams, _ = model
    tree = jax.tree.map(np.array, jparams)
    for key in ("wq", "wk"):
        tree["seg0"]["b0"]["attn"][key]["w"] *= scale
    return (jcfg, tcfg, jax.tree.map(jax.numpy.asarray, tree),
            TT.params_from_numpy(tree, tcfg))


@pytest.mark.parametrize("scale,lens", [(1.0, (8, 16, 24)),
                                        (16.0, (8, 16, 24, 40, 100))])
def test_sparsity_report_matches_reference(model, scale, lens):
    """tests/test_serving.py's prompts (8, 16, 24 tokens), and with peaked
    layer-0 attention longer ones on which LATS prunes: the reference's
    report exactly, per request and aggregated, and the reference test's
    range checks.  The port's layer-0 q and k differ from the reference's
    by at most an f32 ulp, which moves no INT12 value on these prompts, so
    rounds, block liveness and survivors are the same integers and every
    fraction built from them is equal, not close."""
    hot = model if scale == 1.0 else _hot(model, scale)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, L, dtype=np.int32) for L in lens]
    t = _engine(hot, "port").sparsity_report(prompts)
    j = _engine(hot, "ref").sparsity_report(prompts)
    assert t == j
    assert [r["prompt_len"] for r in t["per_request"]] == list(lens)
    for r in t["per_request"]:
        assert 0.0 < r["plane_fraction"] <= 1.0
        assert 0.0 < r["survivor_fraction"] <= 1.0
    if scale != 1.0:
        assert t["plane_fraction"] < 1.0 and t["block_alive_fraction"] < 1.0
    w = np.array([r["n_blocks"] for r in t["per_request"]], float)
    v = np.array([r["plane_fraction"] for r in t["per_request"]])
    assert t["plane_fraction"] == pytest.approx((v * w).sum() / w.sum())
    # A 2-D batch is a list of its rows.
    same = _engine(hot, "port").sparsity_report(np.stack([prompts[1]] * 2))
    assert same["per_request"][0] == t["per_request"][1]
