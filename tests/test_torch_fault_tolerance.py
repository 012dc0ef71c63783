"""The port's runtime fault-tolerance policies (``repro_torch/runtime``),
held to the reference's tests (tests/test_fault_tolerance.py) and driven by
``ManualClock``: the heartbeat monitor, elastic mesh decisions, the
straggler EMA and the stuck-tick engine watchdog.  Building the device mesh
itself waits for mesh serving (ROADMAP A10)."""

import numpy as np
import pytest
import torch

from repro.runtime import ElasticMeshManager as JElastic
from repro.runtime import StragglerPolicy as JStraggler
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as TT
from repro_torch.runtime import (
    ClusterMonitor,
    ElasticMeshManager,
    EngineWatchdog,
    ManualClock,
    StragglerPolicy,
    StuckTickError,
    SystemClock,
)
from repro_torch.serving import PagedEngine, Request, ServeConfig


def test_clocks():
    clk = ManualClock(start=5.0)
    assert clk() == 5.0 and clk.advance(2.5) == 7.5 and clk() == 7.5
    with pytest.raises(ValueError, match="backwards"):
        clk.advance(-1.0)
    for cls in (ManualClock, SystemClock):
        with pytest.raises(ValueError, match="granularity"):
            cls(granularity=0.0)
    sysclk = SystemClock()
    t0 = sysclk()
    assert sysclk() >= t0 and sysclk.granularity == 1e-3


def test_cluster_monitor_timeouts_on_injected_clock():
    clk = ManualClock()
    mon = ClusterMonitor(n_nodes=4, timeout=10.0, clock=clk)
    assert mon.failed_nodes() == set() and mon.healthy_count() == 4

    clk.advance(9.0)
    for n in (0, 1, 2):                    # node 3 goes silent
        mon.heartbeat(n)
    assert mon.failed_nodes() == set()     # 9 s of silence < 10 s timeout
    clk.advance(2.0)
    assert mon.failed_nodes() == {3}
    assert mon.healthy_count() == 3

    mon.inject_failure(1)                  # a failure outranks heartbeats
    mon.heartbeat(1)
    assert mon.failed_nodes() == {1, 3}
    mon.recover(1)
    assert mon.failed_nodes() == {3}


@pytest.mark.parametrize("tp,per_node,nodes", [
    (4, 4, 3), (4, 4, 5), (8, 4, 3), (8, 4, 1), (2, 8, 7)])
def test_elastic_mesh_decisions_match_reference(tp, per_node, nodes):
    """Keep the model-parallel degree, shrink the data axis, refuse when
    the survivors cannot host one model replica: the reference's
    decisions and its refusal."""
    mgr = ElasticMeshManager(model_parallel=tp, devices_per_node=per_node)
    ref = JElastic(model_parallel=tp, devices_per_node=per_node)
    try:
        want = ref.decide(healthy_nodes=nodes)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="cannot host") as got:
            mgr.decide(healthy_nodes=nodes)
        assert str(got.value) == str(e)
        return
    got = mgr.decide(healthy_nodes=nodes)
    assert ((got.data, got.model, got.devices, got.dropped_nodes)
            == (want.data, want.model, want.devices, want.dropped_nodes))


def test_elastic_rebuild_mesh_waits_for_mesh_serving():
    mgr = ElasticMeshManager(model_parallel=4)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        mgr.rebuild_mesh(mgr.decide(healthy_nodes=2))


def test_straggler_policy_ema_and_reassignment():
    pol = StragglerPolicy(slack=2.0, ema_alpha=0.5)
    ref = JStraggler(slack=2.0, ema_alpha=0.5)
    assert pol.deadline() is None
    assert not pol.is_straggler(1e9)       # no EMA yet: nothing to compare
    pol.observe(1.0)
    assert pol.deadline() == pytest.approx(2.0)
    assert not pol.is_straggler(2.0) and pol.is_straggler(2.1)
    pol.observe(2.0)                       # ema -> 1.5, deadline -> 3.0
    assert pol.deadline() == pytest.approx(3.0)
    for t in (1.0, 2.0):
        ref.observe(t)
    assert (pol.ema, pol.deadline()) == (ref.ema, ref.deadline())
    # The donor is a pure function of (step, failed shard), the
    # reference's.
    healthy = [0, 1, 2, 5]
    picks = [StragglerPolicy.reassign_shard(3, healthy, s) for s in range(6)]
    assert picks == [JStraggler.reassign_shard(3, healthy, s)
                     for s in range(6)]
    assert all(p in healthy for p in picks)


class TickEngine:
    """Stub engine whose tick durations come from a script: the clock
    advances by the scripted amount inside step()."""

    def __init__(self, clk, durations):
        self.clk = clk
        self.durations = list(durations)
        self.stepped = 0

    def begin(self, seed=0):
        pass

    def pending(self):
        return bool(self.durations)

    def step(self):
        self.clk.advance(self.durations.pop(0))
        self.stepped += 1
        return self.pending()


def test_watchdog_warmup_never_flags():
    clk = ManualClock()
    # Three monster warm-up ticks, then steady state: with warmup=3 they
    # seed the EMA but are exempt from the deadline check.
    eng = TickEngine(clk, [50.0, 40.0, 30.0, 1.0, 1.0, 1.0])
    dog = EngineWatchdog(eng, StragglerPolicy(slack=2.0, ema_alpha=0.5),
                         clock=clk, warmup=3)
    dog.run(seed=0)
    assert eng.stepped == 6
    assert dog.ticks_seen == 6 and dog.last_tick_time == 1.0


def test_watchdog_raises_on_stuck_tick_before_ema_dilution():
    clk = ManualClock()
    eng = TickEngine(clk, [1.0, 1.0, 1.0, 1.0, 100.0, 1.0])
    pol = StragglerPolicy(slack=2.5, ema_alpha=0.1)
    dog = EngineWatchdog(eng, pol, clock=clk, warmup=2)
    with pytest.raises(StuckTickError, match="deadline"):
        dog.run(seed=0)
    assert eng.stepped == 5                # died on the monster tick
    # The monster tick was checked before it joined the EMA: the deadline
    # that caught it is still the steady-state one.
    assert pol.ema == pytest.approx(1.0)
    assert dog.last_tick_time == 100.0


def test_watchdog_rejects_bad_warmup():
    with pytest.raises(ValueError, match="warmup"):
        EngineWatchdog(TickEngine(ManualClock(), []), warmup=0)


def test_watchdog_drains_real_engine_losslessly():
    """The watchdog is a transparent wrapper: draining the port's
    PagedEngine under supervision (manual clock, constant tick time)
    serves the tokens of an unsupervised run."""
    cfg = reduced_config("stablelm-1.6b").replace(attn_impl="bitstopper_xla")
    params = TT.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    scfg = ServeConfig(max_len=32, max_slots=2, prefill_bucket=8,
                       page_size=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, L, dtype=np.int32)
               for L in (6, 9)]

    ref = [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]
    PagedEngine(cfg, params, scfg, device="cpu").generate(ref, seed=0)

    clk = ManualClock()
    eng = PagedEngine(cfg, params, scfg, device="cpu")
    real_step = eng.step

    def step():
        clk.advance(1.0)       # constant tick time: the EMA never trips
        return real_step()

    eng.step = step
    reqs = [Request(prompt=p.copy(), max_new_tokens=3) for p in prompts]
    for r in reqs:
        eng.submit(r)
    dog = EngineWatchdog(eng, StragglerPolicy(slack=2.5), clock=clk,
                         warmup=2)
    dog.run(seed=0)
    assert [r.generated for r in reqs] == [r.generated for r in ref]
    assert dog.ticks_seen == eng.ticks
