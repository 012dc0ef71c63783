"""Mesh training of MoE in the PyTorch port on the CPU: reduced
qwen2-moe-a2.7b (2 layers, d_model 64, 8 routed experts top-2 of 32
hidden units, 1 shared expert) trained under the reference's
``make_rules`` on a 2x2 (data, model) ``DeviceMesh`` of spawned gloo
ranks, in the EP branch (experts over "model", their hidden units over
"data") and the expert-TP branch (5 experts, which "model" does not
divide: the hidden units over "model", ``expert_dmodel`` over "data"),
held to single-device training, the reference's and the port's.

The reference's own sharded step fails (ROADMAP C5) and its mesh branches
drop per data shard (C11), so the yardstick is one device.  The port
gathers every data rank's routing ids and plans the whole batch at its
capacity, so where capacity binds its drops are one device's pair for
pair, and the data ranks' aux-loss shares sum to one device's loss.  With
microbatches the data ranks' rows are dealt microbatch-major, so a mesh
microbatch holds one device's and drops as it does (C15, repaired).

One module-scoped spawn (``tests/_torch_mesh_worker.py:moe_train_rank``)
runs every mesh case while the pytest process compiles the reference's
steps (``FAST_XLA``) and runs the port's single-device steps and Trainer.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.train import train_step as JS
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.checkpoint import store as TC
from repro_torch.launch.mesh import start_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding.api import AbstractMesh
from repro_torch.sharding.rules import make_rules, moe_train_branch
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer

import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

JOIN_S = 120.0
# Against the reference's single-device step (lr 1e-3 from step 1): loss
# 2e-4 (its sharded test's), grad norm 1e-5 relative, parameters 1e-4;
# three steps move every leaf by more than MOVED_MIN, five times that.
REF_LOSS_TOL = 2e-4
REF_GNORM_RTOL = 1e-5
REF_PARAM_ATOL = 1e-4
MOVED_MIN = 5e-4
# Against the port's single-device step: the TP, expert-TP and data sums
# reassociate float adds (measured on the CPU: loss 7e-8 and grad norm
# 4.5e-7 relative, parameters after three steps 4.3e-5, expert-TP's; Adam
# turns a last-bit gradient gap where |g| is near eps into up to lr times
# its relative size).
PORT_RTOL = 1e-6
PORT_PARAM_ATOL = 1e-4
GRAD_ATOL = 1e-6
AUX_RTOL = 1e-6
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
VARIANTS = list(W.MOE_TRAIN_VARIANTS)


def _reference_steps(variant, params, tokens, n):
    """The reference's single-device step, ``n`` times, from the port's
    parameters in its layout: (loss, grad norm, parameters) after each."""
    jcfg = jreduced(W.MOE_ARCH).replace(**W.MOE_TRAIN_VARIANTS[variant])
    jtcfg = JS.TrainConfig(optimizer=JAdamWConfig(lr=1e-3), warmup_steps=0)
    jp = jax.tree.map(jnp.asarray, params)
    state = {"params": jp, "opt": jinit_opt_state(jp, jtcfg.optimizer)}
    tok = jnp.asarray(tokens)
    step = jax.jit(JS.make_train_step(jcfg, jtcfg)).lower(
        state, tok).compile(compiler_options=FAST_XLA)
    out = []
    for _ in range(n):
        state, m = step(state, tok)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    jax.tree.map(np.asarray, state["params"])))
    return out


def _clone(params):
    return TS.trainable(TO.tree_map(lambda t: t.detach().clone(), params))


def _port_steps(cfg, params, tokens, n):
    tcfg = W.train_tcfg()
    p = _clone(params)
    state = {"params": p, "opt": TO.init_opt_state(p, tcfg.optimizer)}
    step = TS.make_train_step(cfg, tcfg)
    out = []
    for _ in range(n):
        state, m = step(state, torch.as_tensor(tokens))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    TO.tree_map(np.array, TT.params_to_numpy(
                        state["params"], cfg))))
    return out


def _bound(variant, params, tokens):
    """One device at MOE_BIND_FACTOR: loss, gradients, each MoE call's
    drops and aux loss."""
    cfg = W.moe_train_config(variant, moe_capacity_factor=W.MOE_BIND_FACTOR)
    with W.DropSpy() as log:
        loss, grads = TS.value_and_grad(_clone(params),
                                        torch.as_tensor(tokens), cfg,
                                        W.train_tcfg())
    return types.SimpleNamespace(
        loss=float(loss), drops=log.drops, aux=log.aux,
        grads=TO.tree_map(lambda t: t.detach().numpy(), grads))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tokens = np.random.default_rng(1).integers(0, 256, (4, 32))
    params = {v: TT.init_model(W.moe_train_config(v),
                               torch.Generator().manual_seed(0), "cpu")
              for v in VARIANTS}
    dirs = {"mesh": str(tmp_path_factory.mktemp("moe_mesh_trainer")),
            "single": str(tmp_path_factory.mktemp("moe_single_trainer"))}
    job = start_mesh(W.moe_train_rank, 2, 2, device="cpu", backend="gloo",
                     args=(params, tokens, dirs["mesh"]), timeout=JOIN_S)
    reference, single, bound = {}, {}, {}
    for v in VARIANTS:
        cfg = W.moe_train_config(v)
        reference[v] = _reference_steps(v, TT.params_to_numpy(params[v], cfg),
                                        tokens, W.TRAIN_STEPS)
        single[v] = _port_steps(cfg, params[v], tokens, W.TRAIN_STEPS)
        bound[v] = _bound(v, params[v], tokens)
    mb = W.MOE_MICROBATCHES
    cfg = W.moe_train_config("ep", moe_capacity_factor=W.MOE_BIND_FACTOR)
    tcfg = W.train_tcfg(microbatches=mb)
    p = _clone(params["ep"])
    with W.DropSpy() as log:
        TS.make_train_step(cfg, tcfg)(
            {"params": p, "opt": TO.init_opt_state(p, tcfg.optimizer)},
            torch.as_tensor(tokens))
    one_mb = types.SimpleNamespace(drops=log.drops, aux=log.aux)
    tcfg, trun, data = W.moe_trainer_config(W.TRAINER_STEPS + 1,
                                            dirs["single"])
    straight = Trainer(W.moe_train_config("ep"), tcfg, trun, data_cfg=data,
                       device="cpu")
    straight_state = straight.train()
    ranks = job.join()
    return types.SimpleNamespace(
        params=params, tokens=tokens, dirs=dirs, ranks=ranks,
        reference=reference, single=single, bound=bound, one_mb=one_mb,
        straight=straight, straight_state=straight_state)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=atol, err_msg=jax.tree_util.keystr(
                                       key))


# ---------------------------------------------------------------------------
# The branch each layout runs, and what training refuses
# ---------------------------------------------------------------------------

BRANCH_CASES = {
    "ep": ((2, 2), 8, {}, "ep"),
    "expert_tp": ((2, 2), 5, {}, "tp"),
    "expert_tp_asked": ((2, 2), 8, {"moe_ep": False}, "tp"),
    "ep_indivisible": ((2, 2), 5, {"moe_ep": True}, "whole"),
    "model_1": ((4, 1), 8, {}, "whole"),
    "resident": ((2, 2), 8, {"moe_resident": True}, "resident"),
    "resident_indivisible": ((2, 2), 6, {"moe_resident": True}, "whole"),
}


@pytest.mark.parametrize("case", list(BRANCH_CASES))
def test_train_branch_follows_the_axis_map(case):
    """The branch training runs comes from the spec the expert weights are
    cut by: experts over "model" EP, hidden units over "model" expert-TP,
    over data x model resident, neither (an indivisible forced EP, a
    "model" dim of 1, resident experts that data x model does not divide)
    every expert whole; the train step's specs put the experts over "data"
    in the resident branch alone."""
    shape, n_routed, kw, want = BRANCH_CASES[case]
    cfg = W.moe_train_config("ep", n_routed=n_routed)
    rules = make_rules(AbstractMesh(shape, ("data", "model")),
                       n_routed=n_routed, **kw)
    assert moe_train_branch(rules, n_routed, cfg.d_model,
                            cfg.d_expert) == want
    expert = TS.param_specs(cfg, rules)["seg0"][0]["b0"]["moe"]["wi_gate"][0]
    assert (expert == ("data", "model")) == (want == "resident"), expert


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_data_rank_dispatch_holds_only_its_runs_of_slots(factor):
    """A data rank's expert buffer: the whole batch's plan, but only its
    own tokens' run of each expert's slots, from the run's start and
    padded to the longest run; each row it holds equals the whole batch's
    buffer at the slot that one device gives it, and its pair rows equal
    the whole batch's rows of its tokens."""
    from repro_torch.models import moe as TM
    cfg = TM.MoEConfig(d_model=16, n_routed=4, top_k=2, d_expert=8,
                       capacity_factor=factor)
    rng = np.random.default_rng(3)
    T, n_data = 64, 2
    top_i = torch.as_tensor(np.stack([rng.permutation(4)[:2]
                                      for _ in range(T)]))
    x = torch.as_tensor(rng.normal(size=(T, 16)), dtype=torch.float32)
    p = {n: torch.as_tensor(rng.normal(size=sh), dtype=torch.float32)
         for n, sh in (("wi_gate", (4, 16, 8)), ("wi_up", (4, 16, 8)),
                       ("wo", (4, 8, 16)))}
    cap = TM._capacity(T, 2, 4, factor)
    whole, (order, e_idx, s_idx, valid) = TM.dispatch(x, top_i, cfg, 4, cap)
    rows = TM._pair_rows(p, x, None, top_i, cfg, 0, 4, cap)
    tok = torch.arange(T).repeat_interleave(2)[order]
    n = T // n_data
    for d in range(n_data):
        buf, (_, e_r, s_r, w_r) = TM.dispatch(x[d * n:(d + 1) * n], top_i,
                                              cfg, 4, cap, token_offset=d * n)
        mine = valid & (tok >= d * n) & (tok < (d + 1) * n)
        run = max(int((mine & (e_idx == e)).sum()) for e in range(4))
        assert buf.shape[1] == min(cap, max(8, -(-run // 8) * 8))
        assert torch.equal(w_r, mine)
        assert torch.equal(buf[e_r[mine], s_r[mine]],
                           whole[e_idx[mine], s_idx[mine]])
        got = TM._pair_rows(p, x[d * n:(d + 1) * n], None, top_i, cfg, 0, 4,
                            cap, token_offset=d * n)
        torch.testing.assert_close(got, rows[d * n:(d + 1) * n], rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# The mesh steps against single-device steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_mesh_steps_match_reference_single_device(run, variant):
    """Three steps on the 2x2 mesh: every rank's loss within 2e-4 of the
    reference's single-device step, its grad norm within 1e-5 relative,
    and the gathered parameters after the third within 1e-4."""
    for rank in run.ranks:
        got = rank["steps"][variant]
        for i, (loss, gnorm, _) in enumerate(run.reference[variant]):
            m = got["metrics"][i]
            np.testing.assert_allclose(m["loss"], loss, rtol=REF_LOSS_TOL,
                                       atol=REF_LOSS_TOL)
            np.testing.assert_allclose(m["grad_norm"], gnorm,
                                       rtol=REF_GNORM_RTOL)
        _assert_trees_close(got["params"], run.reference[variant][-1][2],
                            REF_PARAM_ATOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_mesh_steps_match_port_single_device(run, variant):
    """The same against the port's single-device step: loss and grad norm
    within 1e-6 relative, parameters within PORT_PARAM_ATOL; every rank
    reports the same metrics and gathers the same parameters."""
    first = run.ranks[0]["steps"][variant]
    for rank in run.ranks:
        got = rank["steps"][variant]
        assert got["metrics"] == first["metrics"]
        for i, (loss, gnorm, _) in enumerate(run.single[variant]):
            m = got["metrics"][i]
            assert abs(m["loss"] - loss) <= PORT_RTOL * abs(loss)
            assert abs(m["grad_norm"] - gnorm) <= PORT_RTOL * gnorm
        _assert_trees_close(got["params"], run.single[variant][-1][2],
                            PORT_PARAM_ATOL)
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_int8_ef_step_is_equal_on_every_rank(run, variant):
    """One int8_ef step after the three (``allreduce_int8_ef`` over every
    leaf, the experts', router's and shared expert's among them): a finite
    loss, and every rank gathers the same parameters and residuals, some
    of them nonzero."""
    first = run.ranks[0]["steps"][variant]["int8"]
    assert np.isfinite(first["loss"])
    assert any(np.abs(e).max() > 0 for e in TO.tree_leaves(first["state"][1]))
    for rank in run.ranks[1:]:
        got = rank["steps"][variant]["int8"]
        for a, b in zip(TO.tree_leaves(got["state"]),
                        TO.tree_leaves(first["state"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_mesh_steps_move_every_parameter(run, variant):
    """Every leaf of the gathered parameters (router, experts, shared
    expert among them) moved by more than MOVED_MIN in three steps, so a
    mesh step that left a leaf alone fails the tolerances above."""
    start = TT.params_to_numpy(run.params[variant],
                               W.moe_train_config(variant))
    got = dict(_leaves(run.ranks[0]["steps"][variant]["params"]))
    for key, w in _leaves(start):
        moved = np.abs(np.asarray(got[key]) - np.asarray(w)).max()
        assert moved > MOVED_MIN, (jax.tree_util.keystr(key), moved)


# ---------------------------------------------------------------------------
# Where capacity binds: drops and the aux loss
# ---------------------------------------------------------------------------


def _union(logs):
    return [sorted(set().union(*calls)) for calls in zip(*logs)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_capacity_binding_drops_and_aux_are_one_devices(run, variant):
    """At capacity factor 0.5 (pairs drop in every layer): the dropped
    (token, expert) pairs of each layer, put together over each data
    rank's "model" ranks (each plans its own experts for the whole
    batch), equal one device's pair for pair; the data ranks' aux shares
    sum to one device's aux loss within 1e-6 relative; the loss and every
    gradient gathered whole are one device's."""
    want = run.bound[variant]
    assert all(want.drops)
    for d in range(2):
        ranks = [r for r in run.ranks if r["coord"][0] == d]
        assert _union([r["bind"][variant]["drops"] for r in ranks]) == \
            want.drops
    for m in range(2):
        shares = [r["bind"][variant]["aux"] for r in run.ranks
                  if r["coord"][1] == m]
        total = [sum(x) for x in zip(*shares)]
        np.testing.assert_allclose(total, want.aux, rtol=AUX_RTOL, atol=0)
    for rank in run.ranks:
        got = rank["bind"][variant]
        assert abs(got["loss"] - want.loss) <= PORT_RTOL * abs(want.loss)
        _assert_trees_close(got["grads"], want.grads, GRAD_ATOL)


def test_microbatches_drop_other_pairs_c15(run):
    """ROADMAP C15, repaired (mesh microbatches used to drop other pairs
    than one device's): with two microbatches at capacity factor 0.5
    each data rank holds its rows dealt microbatch-major, so mesh
    microbatch i is one device's microbatch i in its order: every MoE
    call's dropped pairs (a data rank's "model" ranks together) equal one
    device's microbatched step's pair for pair, and the data ranks' aux
    shares sum to its aux loss within 1e-6 relative."""
    want = run.one_mb
    assert all(want.drops) and len(want.drops) == 2 * W.MOE_MICROBATCHES
    for d in range(2):
        logs = [r["microbatch"]["drops"] for r in run.ranks
                if r["coord"][0] == d]
        assert _union(logs) == want.drops
    for m in range(2):
        shares = [r["microbatch"]["aux"] for r in run.ranks
                  if r["coord"][1] == m]
        np.testing.assert_allclose([sum(x) for x in zip(*shares)],
                                   want.aux, rtol=AUX_RTOL, atol=0)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def test_moe_trainer_over_mesh_resumes_like_one_device(run):
    """``Trainer(rules=)`` on the MoE arch over the 2x2 mesh: a fresh init
    (its blocks drawn part by part) for two steps and a checkpoint, then a
    resume from it for the third: one device's straight three steps'
    losses and grad norms within 1e-6 relative, and the final checkpoint
    holds its parameters within PORT_PARAM_ATOL."""
    want = run.straight.metrics_log
    for rank in run.ranks:
        first, resumed = rank["trainer"]
        got = first + resumed
        assert [len(first), len(resumed)] == [W.TRAINER_STEPS, 1]
        for g_m, w_m in zip(got, want):
            for key in ("loss", "grad_norm"):
                assert abs(g_m[key] - w_m[key]) <= PORT_RTOL * abs(
                    w_m[key]), key
    cfg = W.moe_train_config("ep")
    ref = TS.state_to_numpy(run.straight_state, cfg)
    got, step = TC.load_checkpoint(jax.tree.map(np.zeros_like, ref),
                                   run.dirs["mesh"])
    assert step == W.TRAINER_STEPS + 1
    _assert_trees_close(got["params"], ref["params"], PORT_PARAM_ATOL)
