"""The port's chaos harness held against the reference's on the CPU:
reduced stablelm-1.6b (alpha 0.8) with the reference's weights carried
across.  Each plan of the reference's chaos tests (tests/test_chaos.py) is
served through the reference's ``serve_with_chaos`` and the port's; the
tokens, the fault reports (crashes, restores, snapshots, fired and unfired
events) and the final engine counters must be equal.  Also: seeded plans
and their JSON equal the reference's, the injector's arming rules, and the
circuit breaker catching only the injected ``KernelFault``."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import transformer as JT
from repro.serving import FaultInjector as JInjector
from repro.serving import FaultPlan as JPlan
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro.serving import serve_with_chaos as jchaos
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.models import transformer as TT
from repro_torch.serving import (FaultEvent, FaultInjector, FaultPlan,
                                 HostCrash, PagedEngine, Request, ServeConfig,
                                 serve_with_chaos)
from repro_torch.serving import chaos as tchaos
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


def _trace(lens, max_new, seed=0, prefix_len=0, repetitive=False):
    """Prompts drawn as tests/test_chaos.py's ``_reqs`` draws them."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, prefix_len, dtype=np.int32)
    out = []
    for L in lens:
        if repetitive:
            tail = np.tile(rng.integers(0, 256, 3, dtype=np.int32),
                           (L + 2) // 3)[:L]
        else:
            tail = rng.integers(0, 256, L, dtype=np.int32)
        out.append(np.concatenate([prefix, tail]))
    return out


def _serve_both(model, tmp_path, scfg, prompts, max_new, plan, snap=True,
                device="cpu"):
    """The plan through both harnesses; returns ((tokens, report) of the
    reference, of the port)."""
    jcfg, tcfg, jparams, tparams = model
    if device != "cpu":
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device)
    runs = []
    for name, chaos, make, R, P in (
            ("ref", jchaos, lambda: JEngine(jcfg, jparams, JServe(**scfg)),
             JRequest, JPlan),
            ("port", serve_with_chaos,
             lambda: PagedEngine(tcfg, tparams, ServeConfig(**scfg),
                                 device=device), Request, FaultPlan)):
        out, rep = chaos(
            make, [R(prompt=p.copy(), max_new_tokens=max_new)
                   for p in prompts],
            seed=0, plan=P.scripted(plan),
            snapshot_dir=str(tmp_path / name) if snap else None)
        runs.append(([r.generated for r in out], rep))
    return runs


def _undisturbed(model, scfg, prompts, max_new):
    _, tcfg, _, tparams = model
    reqs = [Request(prompt=p.copy(), max_new_tokens=max_new)
            for p in prompts]
    PagedEngine(tcfg, tparams, ServeConfig(**scfg), device="cpu").generate(
        reqs, seed=0)
    return [r.generated for r in reqs]


# ---------------------------------------------------------------------------
# plans and the injector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_from_seed_and_json_match_reference(seed):
    """Seeded plans are the reference's event for event, and their JSON
    loads in either package."""
    got = FaultPlan.from_seed(seed, 9, 40)
    want = JPlan.from_seed(seed, 9, 40)
    assert [(e.kind, e.tick) for e in got.events] == \
        [(e.kind, e.tick) for e in want.events]
    assert got.to_json() == want.to_json()
    assert FaultPlan.from_json(want.to_json()) == got
    assert JPlan.from_json(got.to_json()) == want
    kinds = ("crash", "pool_dry")
    assert (FaultPlan.from_seed(seed, 5, 3, kinds).to_json()
            == JPlan.from_seed(seed, 5, 3, kinds).to_json())


def test_fault_plan_construction_and_validation():
    plan = FaultPlan.scripted([("crash", 3), FaultEvent("pool_dry", 0)])
    assert plan.events == (FaultEvent("crash", 3), FaultEvent("pool_dry", 0))
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert tchaos.KINDS == ("pool_dry", "kernel_fail", "drafter_fail",
                            "checkpoint_interrupt", "swap_fail", "crash")
    with pytest.raises(ValueError):
        FaultEvent("meteor_strike", 1)
    with pytest.raises(ValueError):
        FaultEvent("crash", -1)


def test_fault_injector_armed_fire_semantics():
    """tests/test_chaos.py's arming rules, consult for consult equal to the
    reference's injector."""
    events = [("crash", 3), ("crash", 5), ("kernel_fail", 0)]
    inj = FaultInjector(FaultPlan.scripted(events))
    ref = JInjector(JPlan.scripted(events))
    consults = [("crash", 2), ("kernel_fail", 2), ("kernel_fail", 99),
                ("crash", 4), ("crash", 4), ("crash", 7)]
    fired = [inj.fire(*c) for c in consults]
    assert fired == [ref.fire(*c) for c in consults]
    assert fired == [False, True, False, True, False, True]
    rep = inj.report()
    assert rep == ref.report()
    assert rep["fired"] == [("kernel_fail", 0, 2), ("crash", 3, 4),
                            ("crash", 5, 7)]
    assert rep["fired_by_kind"] == {"kernel_fail": 1, "crash": 2}
    assert rep["unfired"] == []


# ---------------------------------------------------------------------------
# the reference's plans through both harnesses
# ---------------------------------------------------------------------------


def test_chaos_storm_speculative_oversubscribed(model, tmp_path):
    """tests/test_chaos.py's storm: two crashes (the second inside a
    speculative tick, restored from the older snapshot because the newer
    write was interrupted), a drafter failure and a forced pool-dry, on an
    oversubscribed n-gram speculative engine."""
    scfg = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8,
                pool_blocks=12, oversubscribe=True, speculative="ngram",
                draft_k=3, snapshot_every=2)
    prompts = _trace((9, 12), 14, repetitive=True)
    plan = [("crash", 2), ("drafter_fail", 2), ("pool_dry", 3),
            ("checkpoint_interrupt", 4), ("crash", 4)]
    (jt, jr), (tt, tr) = _serve_both(model, tmp_path, scfg, prompts, 14,
                                     plan)
    assert tt == jt
    assert tr == jr
    assert tt == _undisturbed(model, scfg, prompts, 14)
    assert tr["crashes"] == tr["restores"] == 2
    assert tr["snapshots_interrupted"] == tr["staging_reclaimed"] == 1
    assert tr["engine_counters"]["drafter_failures"] >= 1
    assert tr["fired_by_kind"] == {"crash": 2, "drafter_fail": 1,
                                   "pool_dry": 1, "checkpoint_interrupt": 1}
    assert tr["unfired"] == []


_BREAKER = dict(max_len=48, max_slots=2, prefill_bucket=8, page_size=8,
                fused_decode=True, snapshot_every=1, prefix_sharing=True)


@pytest.fixture(scope="module")
def breaker_ref(model, tmp_path_factory):
    """The reference's breaker plan on its interpreted kernel: a kernel
    fault at tick 2, a crash at tick 4."""
    jcfg, _, jparams, _ = model
    out, rep = jchaos(
        lambda: JEngine(jcfg, jparams, JServe(**_BREAKER)),
        [JRequest(prompt=p.copy(), max_new_tokens=6)
         for p in _trace((6, 9), 6, prefix_len=8)],
        seed=0, plan=JPlan.scripted([("kernel_fail", 2), ("crash", 4)]),
        snapshot_dir=str(tmp_path_factory.mktemp("breaker_ref")))
    return [r.generated for r in out], rep


def _breaker_port(model, tmp_path, device):
    _, tcfg, jparams, tparams = model
    if device != "cpu":
        tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device)
    out, rep = serve_with_chaos(
        lambda: PagedEngine(tcfg, tparams, ServeConfig(**_BREAKER),
                            device=device),
        [Request(prompt=p.copy(), max_new_tokens=6)
         for p in _trace((6, 9), 6, prefix_len=8)],
        seed=0, plan=FaultPlan.scripted([("kernel_fail", 2), ("crash", 4)]),
        snapshot_dir=str(tmp_path))
    return [r.generated for r in out], rep


def test_kernel_circuit_breaker_bitstopper_fused(model, breaker_ref,
                                                 tmp_path):
    """tests/test_chaos.py's breaker plan with ``fused_decode=True``: the
    port on its kernel path (the plain version on the CPU), the reference
    on its interpreted kernel.  The fault degrades the engine to the
    oracle, the crash kills the degraded engine, and the restored engine
    (on the kernel again) serves the same tokens."""
    tt, tr = _breaker_port(model, tmp_path, "cpu")
    jt, jr = breaker_ref
    assert tt == jt
    assert tr == jr
    assert tr["engine_counters"]["degradations"] == 1
    assert tr["crashes"] == 1
    assert tr["fired_by_kind"] == {"kernel_fail": 1, "crash": 1}


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_kernel_circuit_breaker_on_card(model, breaker_ref, tmp_path):
    """The breaker plan through the real decode kernel: the reference's
    tokens and report, and the kernel launched on the fused ticks."""
    from repro_torch.kernels import paged_decode as pd
    before = pd.LAUNCHES
    tt, tr = _breaker_port(model, tmp_path, "cuda")
    jt, jr = breaker_ref
    assert tt == jt
    assert tr == jr
    assert pd.LAUNCHES > before


def test_kernel_fault_not_consulted_on_fallback_path(model):
    """With the plain oracle configured there is no kernel to fail: the
    injected kernel_fail stays unfired, and the breaker refuses to degrade
    an engine that is already plain."""
    scfg = dict(max_len=32, max_slots=2, prefill_bucket=8, page_size=8,
                fused_decode=False)
    (jt, jr), (tt, tr) = _serve_both(model, None, scfg, _trace((6,), 3), 3,
                                     [("kernel_fail", 0)], snap=False)
    assert tt == jt and len(tt[0]) == 3
    assert tr == jr
    assert tr["unfired"] == [("kernel_fail", 0)]
    assert tr["engine_counters"]["degradations"] == 0
    _, tcfg, _, tparams = model
    eng = PagedEngine(tcfg, tparams, ServeConfig(**scfg), device="cpu")
    with pytest.raises(RuntimeError, match="nothing simpler"):
        eng._degrade("a kernel fault")


def test_crash_without_snapshot_dir_is_fatal(model):
    _, tcfg, _, tparams = model
    jcfg, _, jparams, _ = model
    scfg = dict(max_len=32, max_slots=2, prefill_bucket=8, page_size=8)
    msgs = []
    for chaos, make, R, P in (
            (jchaos, lambda: JEngine(jcfg, jparams, JServe(**scfg)),
             JRequest, JPlan),
            (serve_with_chaos,
             lambda: PagedEngine(tcfg, tparams, ServeConfig(**scfg),
                                 device="cpu"), Request, FaultPlan)):
        with pytest.raises(RuntimeError, match="died at tick") as e:
            chaos(make, [R(prompt=p, max_new_tokens=3)
                         for p in _trace((6,), 3)],
                  seed=0, plan=P.scripted([("crash", 1)]))
        msgs.append(str(e.value))
    assert e.type is HostCrash
    assert msgs[0] == msgs[1]


def test_forced_pool_dry_preemption_is_lossless(model):
    """A pool_dry forces a preemption on an unreserved claim although the
    pool has room; the tokens equal an uncontended run's."""
    scfg = dict(max_len=48, max_slots=2, prefill_bucket=8, page_size=8,
                pool_blocks=16, oversubscribe=True)
    prompts = _trace((9, 9), 18)
    (jt, jr), (tt, tr) = _serve_both(model, None, scfg, prompts, 18,
                                     [("pool_dry", 4)], snap=False)
    assert tt == jt
    assert tr == jr
    assert tt == _undisturbed(model, dict(max_len=48, max_slots=2,
                                          prefill_bucket=8, page_size=8),
                              prompts, 18)
    assert tr["fired_by_kind"] == {"pool_dry": 1}
    assert tr["engine_counters"]["forced_preemptions"] == 1
    assert tr["engine_counters"]["preemptions"] >= 1


def test_kernel_error_propagates_without_degrading(model, monkeypatch):
    """The breaker catches only the consult's ``KernelFault``: an error
    raised inside the decode forward (here, by the kernel wrapper) reaches
    the caller, with an injector attached and a kernel_fail still pending,
    and the engine stays on the kernel."""
    from repro_torch.kernels import paged_decode as pd
    _, tcfg, _, tparams = model

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pd, "paged_bitstopper_decode", broken)
    eng = PagedEngine(tcfg, tparams, ServeConfig(
        max_len=32, max_slots=2, prefill_bucket=8, page_size=8,
        fused_decode=True), device="cpu")
    eng.chaos = FaultInjector(FaultPlan.scripted([("kernel_fail", 50)]))
    eng.submit(Request(prompt=_trace((6,), 3)[0], max_new_tokens=3))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run()
    assert eng.cfg.fused_decode is True
    assert eng.counters["degradations"] == 0
    assert eng.chaos.pending() == [("kernel_fail", 50)]
