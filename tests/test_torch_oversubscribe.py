"""The port's oversubscribed, sampled PagedEngine held tick by tick against
the reference's on the CPU: reduced stablelm-1.6b (alpha 0.8) with the
reference's weights carried across, both engines begun at one seed and
stepped together.  After every tick the allocator state, block tables, fill
levels, tokens, counters and each request's ``preemptions``,
``shed_reason`` and ``deadline_hit`` must be equal.  The traces and
geometries are the reference's own oversubscription, speculative and QoS
tests' (tests/test_serving.py, tests/test_speculative.py,
tests/test_chaos.py)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import PagedEngine, Request, ServeConfig
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8))
    tcfg = reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=TConfig(alpha=0.8))
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


# tests/test_serving.py: worst-case reservations of the three requests
# cannot coexist in the pool, so a mid-decode claim must preempt.
_BASE = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)
_OS = dict(_BASE, max_slots=3, pool_blocks=10, oversubscribe=True)


def _trace(lens, max_new, seed=0, prefix=None, repetitive=False, **qos):
    """(prompt, max_new_tokens, qos fields) per request, drawn like the
    reference tests' ``_reqs``; ``repetitive`` prompts loop a period of 3
    tokens, as in tests/test_chaos.py, so that the n-gram drafter finds
    matches."""
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        if repetitive:
            p = np.tile(rng.integers(0, 256, 3, dtype=np.int32),
                        (L + 2) // 3)[:L]
        else:
            p = rng.integers(0, 256, L, dtype=np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append((p, max_new, dict(qos)))
    return out


def _lockstep(model, trace, seed=0, drafter=None, device="cpu", fused=False,
              **kw):
    """Serve the trace through both engines one tick at a time; returns the
    port's engine and requests.  The reference runs its plain oracle, which
    its own tests pin to its kernel."""
    jcfg, tcfg, jparams, tparams = model
    if device != "cpu":
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device)
    jeng = JEngine(jcfg, jparams, JServe(fused_decode=False, **kw))
    teng = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=fused, **kw),
                       device=device)
    if drafter is not None:
        jeng._drafter = teng._drafter = drafter
    jreqs = [jeng.submit(JRequest(prompt=p.copy(), max_new_tokens=n, **q))
             for p, n, q in trace]
    treqs = [teng.submit(Request(prompt=p.copy(), max_new_tokens=n, **q))
             for p, n, q in trace]
    jeng.begin(seed)
    teng.begin(seed)
    ticks = 0
    while jeng.pending() or teng.pending():
        jeng.step()
        teng.step()
        ticks += 1
        assert teng.pool.snapshot() == jeng.pool.snapshot(), ticks
        np.testing.assert_array_equal(teng.table, jeng.table)
        np.testing.assert_array_equal(teng.lengths, jeng.lengths)
        for t, j in zip(treqs, jreqs):
            assert (t.generated, t.preemptions, t.shed_reason,
                    t.deadline_hit) == (j.generated, j.preemptions,
                                        j.shed_reason, j.deadline_hit), ticks
        assert {k: jeng.counters[k] for k in teng.counters} == teng.counters
    assert teng.ticks == jeng.ticks == ticks
    return teng, treqs


def _drained(eng):
    assert eng.pool.available() == eng.pool.capacity
    assert eng.pool._reserved == 0
    assert (eng.table == 0).all()


@pytest.mark.parametrize("policy,temperature,seed", [
    ("fewest_tokens", 0.0, 0), ("fewest_tokens", 0.7, 7),
    ("fewest_tokens", 1.0, 7), ("lifo", 0.0, 0)])
def test_oversubscribed_preemption_lockstep(model, policy, temperature,
                                            seed):
    """tests/test_serving.py's ``_OS`` trace, greedy and sampled, under both
    victim policies: at least one preemption, every tick equal to the
    reference's, and the port's trace equal to its own uncontended run."""
    trace = _trace((12, 9, 11), 16)
    eng, reqs = _lockstep(model, trace, seed, temperature=temperature,
                          preempt_policy=policy, **_OS)
    assert eng.counters["preemptions"] >= 1
    assert sum(r.preemptions for r in reqs) == eng.counters["preemptions"]
    _drained(eng)
    _, tcfg, _, tparams = model
    plain = [Request(prompt=p.copy(), max_new_tokens=n) for p, n, _ in trace]
    PagedEngine(tcfg, tparams, ServeConfig(
        max_len=64, max_slots=3, prefill_bucket=8, page_size=8,
        temperature=temperature), device="cpu").generate(plain, seed)
    assert [r.generated for r in reqs] == [r.generated for r in plain]


def test_oversubscribed_shared_prefix_resume_lockstep(model):
    """A common system prompt: preemption decrefs the registered prefix
    blocks and the resume re-maps them (tests/test_serving.py)."""
    sys_prompt = np.random.default_rng(42).integers(0, 256, 16,
                                                    dtype=np.int32)
    trace = _trace((3, 7, 5), 16, seed=5, prefix=sys_prompt)
    eng, _ = _lockstep(model, trace, **dict(_BASE, pool_blocks=11,
                                            max_slots=3, oversubscribe=True))
    assert eng.counters["preemptions"] >= 1
    assert eng.counters["prefix_hit_tokens"] > 0
    _drained(eng)


def test_oversubscribed_ngram_speculative_lockstep(model):
    """n-gram speculative serving under oversubscription: draft blocks
    never preempt, drafts truncate instead."""
    eng, _ = _lockstep(model, _trace((12, 9, 11), 16), speculative="ngram",
                       draft_k=3, **_OS)
    assert eng.counters["preemptions"] >= 1
    assert eng.counters["spec_ticks"] > 0
    _drained(eng)


class RepeatDrafter:
    """Drafts the last token k times: nearly every draft is rejected."""

    def propose(self, ctx, k):
        return [int(ctx[-1])] * k


def test_oversubscribed_spec_rollback_spare_capacity_lockstep(model):
    """Draft-tail blocks claimed from reservations and from spare capacity
    roll back constantly; spare claims free outright, so no reservation is
    left when the pool drains."""
    eng, _ = _lockstep(model, _trace((12, 9, 11), 24),
                       drafter=RepeatDrafter(), speculative="ngram",
                       draft_k=6, **_OS)
    assert eng.counters["spec_proposed"] > eng.counters["spec_accepted"]
    _drained(eng)


class ReplayDrafter:
    """Drafts the tokens a recorded run generated after the same context:
    a perfect draft model of the sampled target."""

    def __init__(self, prompts, streams):
        self.runs = list(zip(prompts, streams))

    def propose(self, ctx, k):
        for prompt, gen in self.runs:
            n = len(ctx) - len(prompt)
            if (0 < n <= len(gen) and np.array_equal(ctx[:len(prompt)], prompt)
                    and list(ctx[len(prompt):]) == gen[:n]):
                return gen[n:n + k]
        return []


@pytest.mark.parametrize("speculative", ["ngram", "draft", "replay"])
def test_sampled_speculative_lockstep(model, speculative):
    """tests/test_speculative.py: seeded speculative serving equals the
    reference tick by tick and the port's own plain sampled trace.  On
    random weights neither drafter guesses a sampled token, so a drafter
    replaying the plain sampled run gets its drafts accepted."""
    trace = _trace((5, 11), 5)
    _, tcfg, _, tparams = model
    plain = [Request(prompt=p.copy(), max_new_tokens=n) for p, n, _ in trace]
    PagedEngine(tcfg, tparams, ServeConfig(temperature=1.0, **_BASE),
                device="cpu").generate(plain, 7)
    drafter = None
    if speculative == "replay":
        drafter = ReplayDrafter([p for p, _, _ in trace],
                                [r.generated for r in plain])
    eng, reqs = _lockstep(model, trace, 7, drafter=drafter, temperature=1.0,
                          speculative="ngram" if drafter else speculative,
                          draft_k=3, **_BASE)
    assert [r.generated for r in reqs] == [r.generated for r in plain]
    if speculative == "replay":
        assert eng.counters["spec_accepted"] > 0


def test_deadline_truncates_to_prefix_lockstep(model):
    """tests/test_chaos.py: a mid-decode deadline truncates the stream to
    a prefix of the undisturbed one."""
    base = dict(_BASE, max_len=48)
    eng, reqs = _lockstep(model, _trace((9,), 10, deadline_ticks=6), **base)
    assert 0 < len(reqs[0].generated) < 10
    assert reqs[0].deadline_hit and reqs[0].shed_reason is None
    assert eng.counters["deadline_truncated"] == 1
    _, tcfg, _, tparams = model
    full = [Request(prompt=p.copy(), max_new_tokens=n)
            for p, n, _ in _trace((9,), 10)]
    PagedEngine(tcfg, tparams, ServeConfig(**base), "cpu").generate(full)
    assert (reqs[0].generated
            == full[0].generated[:len(reqs[0].generated)])


def test_deadline_expiry_in_queue_sheds_lockstep(model):
    """One slot serializes the queue, so the tail's deadlines lapse before
    it starts: shed, not truncated."""
    eng, reqs = _lockstep(model, _trace((9, 9, 9), 8, deadline_ticks=2),
                          **dict(_BASE, max_len=32, max_slots=1))
    assert reqs[0].generated and reqs[0].deadline_hit
    assert all(r.shed_reason == "deadline" and not r.generated
               for r in reqs[1:])
    assert eng.counters["shed_deadline"] == eng.counters["requests_shed"] == 2


def test_watermark_shedding_lockstep(model):
    """Past the saturation watermark, never-started besteffort requests are
    shed; the standard head never is."""
    trace = _trace((9, 9, 9, 9), 8)
    for _, _, q in trace[1:]:
        q["slo"] = "besteffort"
    eng, reqs = _lockstep(model, trace, **dict(
        _BASE, max_slots=4, pool_blocks=6, oversubscribe=True,
        shed_watermark=0.5))
    shed = [r for r in reqs if r.shed_reason]
    assert shed and eng.counters["shed_watermark"] == len(shed)
    assert all(r.slo == "besteffort" and not r.generated for r in shed)
    assert reqs[0].shed_reason is None


def test_slo_aware_victim_selection_lockstep(model):
    """The besteffort slot is preempted first, although fewest_tokens alone
    would pick the standard one."""
    trace = _trace((9, 9, 9), 20)
    for (_, _, q), slo in zip(trace, ("strict", "besteffort", "standard")):
        q["slo"] = slo
    eng, reqs = _lockstep(model, trace, **dict(
        _BASE, max_slots=3, pool_blocks=10, oversubscribe=True,
        preempt_policy="fewest_tokens"))
    assert eng.counters["preemptions"] >= 1
    assert [r.preemptions > 0 for r in reqs] == [False, True, False]


def test_invalid_request_qos_rejected(model):
    _, tcfg, _, tparams = model
    eng = PagedEngine(tcfg, tparams, ServeConfig(**dict(_BASE, max_len=32)),
                      "cpu")
    with pytest.raises(ValueError, match="slo"):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=2, slo="platinum"))
    with pytest.raises(ValueError, match="deadline_ticks"):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=2, deadline_ticks=0))
    eng.submit(Request(prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=2, rid=5))
    with pytest.raises(ValueError, match="rid 5"):
        eng.submit(Request(prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=2, rid=5))


@pytest.mark.gpu
def test_sampled_oversubscribed_on_card_matches_reference(model):
    """On the card: the sampled ``_OS`` trace through the decode kernel,
    tick by tick equal to the reference, and one kernel launch per layer
    per decode tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_decode as pd
    before = pd.LAUNCHES
    eng, _ = _lockstep(model, _trace((12, 9, 11), 16), 7, device="cuda",
                       fused=None, temperature=0.7, **_OS)
    assert eng.cfg.fused_decode is True
    assert eng.counters["preemptions"] >= 1
    assert (pd.LAUNCHES - before
            == eng.counters["decode_steps"] * model[1].n_layers)
