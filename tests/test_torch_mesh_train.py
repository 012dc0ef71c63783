"""Mesh training of the PyTorch port on the CPU: the train step under
training's rules (FSDP over "data", Megatron TP over "model") on a 2x2
(data, model) ``DeviceMesh`` of spawned gloo ranks, held to single-device
training, the port's and the reference's.

The reference's own sharded train step fails (ROADMAP C5,
``tests/test_sharding_multidev.py::test_train_step_sharded_matches_single_device``),
so the mesh step is held to its single-device step at that test's
tolerances (loss 2e-4, parameters 2e-3) and to the port's single-device
step at the gap measured here.  The layouts are held to the reference's
``make_rules`` leaf by leaf over abstract meshes, and
``allreduce_int8_ef`` to the reference's under its debug mesh (8 forced
host devices, a subprocess) on the same inputs.

One module-scoped spawn runs every mesh scenario
(``tests/_torch_mesh_worker.py:train_rank``) while the pytest process
compiles the reference's step (``FAST_XLA``) and runs both packages'
single-device steps and Trainer.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.checkpoint import store as JC
from repro.configs import reduced_config as jreduced
from repro.sharding import rules as JR
from repro.train import train_step as JS
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.checkpoint import store as TC
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import start_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding.api import AbstractMesh
from repro_torch.sharding.rules import make_rules
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer

import _torch_mesh_worker as W
from _torch_mesh_train_ref import (FAST_XLA, JOIN_S, MOVED_MIN,
                                   PORT_LOSS_RTOL, PORT_PARAM_ATOL,
                                   REF_GNORM_RTOL, REF_LOSS_TOL,
                                   REF_PARAM_ATOL)
from _torch_threads import one_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# The mesh's gradients against the port's own single-device step
# (measured: 2.8e-8, MQA's).
GRAD_ATOL = 1e-6
# The Trainer's runs, the same schedule (measured: 4.0e-6 after three
# steps).
TRAINER_PARAM_ATOL = 1e-5

# The reference's allreduce_int8_ef under its 2x2 debug mesh on the
# reference test's inputs (g a 16x16 normal from numpy seed 0, e zeros and
# then a small residual); prints the outputs as JSON.
_INT8 = """
    import json, jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_debug_mesh
    from repro.train.train_step import allreduce_int8_ef
    mesh = make_debug_mesh(2, 2)
    rng = np.random.default_rng(0)
    g = rng.normal(size=(16, 16)).astype(np.float32)
    e = (rng.normal(size=(16, 16)) * 1e-3).astype(np.float32)
    out, err = jax.jit(lambda g, e: allreduce_int8_ef(
        {"w": g}, {"w": e}, mesh, ("data",)))(jnp.asarray(g), jnp.asarray(e))
    print(json.dumps({"out": np.asarray(out["w"]).tolist(),
                      "err": np.asarray(err["w"]).tolist()}))
"""


def int8_inputs():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(16, 16)).astype(np.float32)
    e = (rng.normal(size=(16, 16)) * 1e-3).astype(np.float32)
    return g, e


def _reference_tcfg():
    """``W.train_tcfg()`` in the reference: lr 1e-3, no warm-up."""
    return JS.TrainConfig(optimizer=JAdamWConfig(lr=1e-3), warmup_steps=0)


def _reference_steps(params, tokens, n):
    """The reference's single-device step, ``n`` times, from the port's
    parameters in its layout: losses, grad norms and parameters after each
    step."""
    jcfg, jtcfg = jreduced(W.TRAIN_ARCH), _reference_tcfg()
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


def _reference_loss(key, params, tokens):
    """The reference's loss at ``params`` (its layout) for model ``key`` of
    ``W.HEAD_CASES``."""
    jcfg = jreduced(W.TRAIN_ARCH).replace(**W.HEAD_CASES[key])
    jp, tok = jax.tree.map(jnp.asarray, params), jnp.asarray(tokens)
    fn = jax.jit(lambda p, t: JS.loss_fn(p, t, jcfg, _reference_tcfg()))
    return float(fn.lower(jp, tok).compile(compiler_options=FAST_XLA)(
        jp, tok))


def _port_steps(params, tokens, n, cfg=None):
    cfg = cfg or reduced_config(W.TRAIN_ARCH)
    tcfg = W.train_tcfg()
    p = TS.trainable(TO.tree_map(lambda t: t.detach().clone(), params))
    state = {"params": p, "opt": TO.init_opt_state(p, tcfg.optimizer)}
    step = TS.make_train_step(cfg, tcfg)
    out = []
    for _ in range(n):
        state, m = step(state, torch.as_tensor(tokens))
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    TO.tree_map(np.array, TT.params_to_numpy(
                        state["params"], cfg))))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref_int8 = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_INT8)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    cfg = reduced_config(W.TRAIN_ARCH)
    params = TT.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
    dirs = {"trainer": str(tmp_path_factory.mktemp("mesh_trainer")),
            "single": str(tmp_path_factory.mktemp("single_trainer"))}
    g, e = int8_inputs()
    head_params = {key: TT.init_model(W.train_model_config(key),
                                      torch.Generator().manual_seed(0), "cpu")
                   for key in W.HEAD_CASES}
    t0 = time.monotonic()
    job = start_mesh(W.train_rank, 2, 2, device="cpu", backend="gloo",
                     args=(params, tokens, dirs, g, e, head_params),
                     timeout=JOIN_S)
    try:
        host = TT.params_to_numpy(params, cfg)
        reference = _reference_steps(host, tokens, W.TRAIN_STEPS)
        single = _port_steps(params, tokens, W.TRAIN_STEPS)
        heads = {}
        for key, p in head_params.items():
            hcfg = W.train_model_config(key)
            loss, grads = TS.value_and_grad(TS.trainable(TO.tree_map(
                lambda t: t.detach().clone(), p)), torch.as_tensor(tokens),
                hcfg, W.train_tcfg())
            heads[key] = types.SimpleNamespace(
                loss=float(loss), grads=TO.tree_map(
                    lambda t: t.detach().numpy(), grads),
                step=_port_steps(p, tokens, 1, hcfg)[0],
                reference=_reference_loss(key, TT.params_to_numpy(p, hcfg),
                                          tokens))
        tcfg, trun, data = W.trainer_config(W.TRAINER_STEPS + 1,
                                            dirs["single"])
        straight = Trainer(cfg, tcfg, trun, data_cfg=data, device="cpu")
        straight_state = straight.train()
        ranks = job.join()
    finally:
        try:
            out, err = ref_int8.communicate(
                timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            ref_int8.kill()
            raise
    assert ref_int8.returncode == 0, err
    return types.SimpleNamespace(
        cfg=cfg, params=params, tokens=tokens, dirs=dirs, ranks=ranks,
        reference=reference, single=single, heads=heads, straight=straight,
        straight_state=straight_state, ref_int8=json.loads(out))


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
# Layouts
# ---------------------------------------------------------------------------

LAYOUT_ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b", "deepseek-v3-671b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod 2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
MOE_KW = {"default": {}, "moe_ep": {"moe_ep": True},
          "expert_tp": {"moe_ep": False}, "moe_resident":
          {"moe_resident": True}}
_JSTATES: dict = {}


def _reference_state_shapes(arch):
    if arch not in _JSTATES:
        jcfg = jreduced(arch)
        tcfg = JS.TrainConfig(grad_compression="int8_ef")
        _JSTATES[arch] = jax.eval_shape(
            lambda k: JS.init_train_state(k, jcfg, tcfg),
            jax.random.PRNGKey(0))
    return _JSTATES[arch]


def _port_state_layout(arch, rules):
    """The port's state specs in the reference's layout: a scanned
    segment's per-layer specs (all equal) with its stacked axis
    prepended."""
    cfg = reduced_config(arch)
    tcfg = TS.TrainConfig(grad_compression="int8_ef")
    specs = TS.state_specs(cfg, tcfg, rules)

    def stack(tree):
        out = {}
        for key, val in tree.items():
            reps = (cfg.segments[int(key[3:])][1] if key.startswith("seg")
                    else 0)
            if reps and cfg.scan_layers and reps > 1:
                assert all(v == val[0] for v in val[1:]), key
                out[key] = jax.tree.map(
                    lambda s: (None,) + s if s else s, val[0],
                    is_leaf=lambda x: isinstance(x, tuple))
            else:
                out[key] = val
        return out

    return {"params": stack(specs["params"]), "err": stack(specs["err"]),
            "opt": {"m": stack(specs["opt"]["m"]),
                    "v": stack(specs["opt"]["v"]),
                    "step": specs["opt"]["step"]}}


def _flat_specs(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("moe", list(MOE_KW))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_layouts_match_reference(arch, mesh, fsdp, moe):
    """Every leaf of the train state (parameters, moments, error feedback,
    the step) has the reference's ``make_rules`` spec, under FSDP or not
    and each MoE placement, on a 2x2 mesh and a 2x2x2 mesh with "pod"."""
    shape, names = MESHES[mesh]
    n_routed = reduced_config(arch).n_routed
    kw = dict(fsdp=fsdp, n_routed=n_routed, **MOE_KW[moe])
    jrules = JR.make_rules(JAbstractMesh(shape, names), **kw)
    want = _flat_specs(jrules.tree_pspecs(_reference_state_shapes(arch)))
    got = _flat_specs(_port_state_layout(
        arch, make_rules(AbstractMesh(shape, names), **kw)))
    assert got == want


def test_reshard_layout_on_the_survivor_mesh_matches_reference():
    """The 1x2 mesh the elastic reshard lands on has the reference's
    layout for every parameter."""
    arch = W.TRAIN_ARCH
    jrules = JR.make_rules(JAbstractMesh((1, 2), ("data", "model")))
    want = _flat_specs(jrules.tree_pspecs(
        _reference_state_shapes(arch)["params"]))
    got = _flat_specs(_port_state_layout(
        arch, make_rules(AbstractMesh((1, 2), ("data", "model"))))["params"])
    assert got == want


@pytest.mark.parametrize("per_slot", [False, True])
def test_contiguous_cache_layouts_match_reference(per_slot):
    """``cache_pspecs`` routes a contiguous cache tree through
    ``CACHE_RULES`` as the reference routes it (a leaf with one more axis
    than its rule is scan-stacked), leaf for leaf on the reference's own
    stacked cache shapes."""
    from repro.models import transformer as JT
    from repro_torch.sharding.rules import cache_pspecs
    shapes = jax.eval_shape(lambda: JT.init_caches(
        jreduced(W.TRAIN_ARCH), 4, 32, per_slot=per_slot))
    jrules = JR.make_rules(JAbstractMesh((2, 2), ("data", "model")))
    rules = make_rules(AbstractMesh((2, 2), ("data", "model")))
    assert _flat_specs(cache_pspecs(rules, shapes)) == \
        _flat_specs(JR.cache_pspecs(jrules, shapes))


def test_production_mesh_needs_its_world():
    """``make_production_mesh`` builds the reference's (16, 16) or (2, 16,
    16) mesh over an initialized world of that size; without one it
    raises."""
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="initialized process group"):
            make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# The mesh step against single-device steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, W.TRAIN_STEPS])
def test_mesh_step_matches_reference_single_device(run, steps):
    """After one and after three steps on the 2x2 mesh: every rank's loss
    within 2e-4 of the reference's single-device step (the reference's own
    sharded-step tolerance), its grad norm within REF_GNORM_RTOL, and the
    gathered parameters within REF_PARAM_ATOL, below the 2e-3 the
    reference's test allows and below what one step moves them."""
    loss, gnorm, want = run.reference[steps - 1]
    for rank in run.ranks:
        m = rank["metrics"][steps - 1]
        np.testing.assert_allclose(m["loss"], loss, rtol=REF_LOSS_TOL,
                                   atol=REF_LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"], gnorm,
                                   rtol=REF_GNORM_RTOL)
        _assert_trees_close(rank["params"][steps], want, REF_PARAM_ATOL)


@pytest.mark.parametrize("steps", [1, W.TRAIN_STEPS])
def test_mesh_steps_move_every_parameter(run, steps):
    """Each step updates (lr 1e-3, no warm-up): after step n every leaf
    of the gathered parameters has moved by more than MOVED_MIN, ten times
    the tolerances above, so a mesh step that left the parameters alone
    would fail them."""
    start = TT.params_to_numpy(run.params, run.cfg)
    got = dict(_leaves(run.ranks[0]["params"][steps]))
    for key, w in _leaves(start):
        moved = np.abs(np.asarray(got[key]) - np.asarray(w)).max()
        assert moved > MOVED_MIN, (jax.tree_util.keystr(key), moved)


@pytest.mark.parametrize("steps", [1, W.TRAIN_STEPS])
def test_mesh_step_matches_port_single_device(run, steps):
    """The same against the port's single-device step: loss and grad norm
    within 1e-6 relative, parameters within PORT_PARAM_ATOL."""
    loss, gnorm, want = run.single[steps - 1]
    for rank in run.ranks:
        m = rank["metrics"][steps - 1]
        assert abs(m["loss"] - loss) <= PORT_LOSS_RTOL * abs(loss)
        assert abs(m["grad_norm"] - gnorm) <= PORT_LOSS_RTOL * abs(gnorm)
        _assert_trees_close(rank["params"][steps], want, PORT_PARAM_ATOL)


@pytest.mark.parametrize("key", list(W.HEAD_CASES))
def test_head_layouts_match_single_device(run, key):
    """The Megatron branches reduced stablelm's heads do not take (MQA's
    whole KV head read by each local q head, KV heads "model" does not
    divide, q heads it does not divide with wo's rows gathered): on the
    2x2 mesh the loss at the initial parameters within 1e-6 relative of
    the port's single-device loss and within 2e-4 of the reference's,
    every gradient gathered whole within GRAD_ATOL of one device's (the
    wk/wv gradients summed over "model" among them), and one step's loss,
    grad norm and parameters as one device's."""
    want = run.heads[key]
    w_loss, w_gnorm, w_params = want.step
    for rank in run.ranks:
        got = rank["heads"][key]
        assert abs(got["loss"] - want.loss) <= PORT_LOSS_RTOL * want.loss
        np.testing.assert_allclose(got["loss"], want.reference,
                                   rtol=REF_LOSS_TOL, atol=REF_LOSS_TOL)
        _assert_trees_close(got["grads"], want.grads, GRAD_ATOL)
        m = got["metrics"]
        assert abs(m["loss"] - w_loss) <= PORT_LOSS_RTOL * w_loss
        assert abs(m["grad_norm"] - w_gnorm) <= PORT_LOSS_RTOL * w_gnorm
        _assert_trees_close(got["params"], w_params, PORT_PARAM_ATOL)


def test_ranks_agree_bit_for_bit(run):
    """Every rank reports the same losses and grad norms, gathers the same
    parameters, and ranks that hold the same block of a leaf (replicated
    dims) hold the same bits: no replicated leaf drifts apart."""
    first = run.ranks[0]
    cfg = run.cfg
    specs = TS.state_specs(cfg, TS.TrainConfig(), make_rules(
        AbstractMesh((2, 2), ("data", "model"))))
    for rank in run.ranks[1:]:
        assert rank["metrics"] == first["metrics"]
        for a, b in zip(jax.tree.leaves(rank["params"]),
                        jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)
    by_block: dict = {}
    spec_leaves = TO.tree_leaves(specs)
    for rank in run.ranks:
        coord = dict(zip(("data", "model"), rank["coord"]))
        for i, (spec, leaf) in enumerate(zip(
                spec_leaves, TO.tree_leaves(rank["blocks"]))):
            idx = tuple(coord[e] if e else 0 for e in spec)
            by_block.setdefault((i, idx), []).append(leaf)
    shared = [v for v in by_block.values() if len(v) > 1]
    assert shared
    for copies in shared:
        for c in copies[1:]:
            np.testing.assert_array_equal(c, copies[0])


def test_int8_ef_step_is_equal_on_every_rank(run):
    """One int8_ef step on the mesh: finite, and every rank gathers the
    same parameters and error feedback."""
    first = run.ranks[0]["int8_step"]
    assert np.isfinite(first["loss"])
    for rank in run.ranks[1:]:
        got = rank["int8_step"]
        for a, b in zip(TO.tree_leaves([got["params"], got["err"]]),
                        TO.tree_leaves([first["params"], first["err"]])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# allreduce_int8_ef
# ---------------------------------------------------------------------------


def test_allreduce_int8_ef_matches_reference(run):
    """On the same g and e on every rank: output and residual within 1e-7
    of the reference's under its 2x2 debug mesh; the reference test's
    bounds (|out - g| <= 0.05, |err| <= max|g + e| / 127)."""
    g, e = int8_inputs()
    want_out = np.asarray(run.ref_int8["out"], np.float32)
    want_err = np.asarray(run.ref_int8["err"], np.float32)
    for rank in run.ranks:
        np.testing.assert_allclose(rank["int8"]["out"], want_out, atol=1e-7,
                                   rtol=0)
        np.testing.assert_allclose(rank["int8"]["err"], want_err, atol=1e-7,
                                   rtol=0)
        np.testing.assert_allclose(rank["int8"]["out"], g, atol=0.05)
        assert np.abs(rank["int8"]["err"]).max() <= \
            np.abs(g + e).max() / 127 + 1e-6


def test_allreduce_int8_ef_unequal_scales_c14(run):
    """ROADMAP C14, the reference's arithmetic: with g scaled by 1 + its
    data coordinate, each rank's int8 values are taken at its own scale but
    the sum is multiplied by the larger one, so the result is not the mean
    (3g/2) of the two ranks' gradients; it is sum(q) * max(s) / 2, equal on
    every rank, and each rank keeps its own residual."""
    g, e = int8_inputs()
    qs, ss = [], []
    for k in (1, 2):
        gf = g * k + e
        s = np.float32(max(np.abs(gf).max(), 1e-12) / np.float32(127))
        q = np.clip(np.round(gf / s), -127, 127).astype(np.int32)
        qs.append(q)
        ss.append(s)
    want = (qs[0] + qs[1]).astype(np.float32) * max(ss) / np.float32(2)
    for rank in run.ranks:
        np.testing.assert_allclose(rank["int8"]["unequal_out"], want,
                                   atol=1e-6, rtol=0)
        k = 1 + rank["coord"][0]
        np.testing.assert_allclose(
            rank["int8"]["unequal_err"],
            g * k + e - qs[k - 1].astype(np.float32) * ss[k - 1], atol=1e-6)
    bias = np.abs(want - 1.5 * g).max()
    assert bias > 0.1 * np.abs(g).max()


# ---------------------------------------------------------------------------
# The Trainer, checkpoints, the 1x2 resume, the elastic reshard
# ---------------------------------------------------------------------------


def test_trainer_over_mesh_matches_one_device(run):
    """The Trainer over the 2x2 mesh (data rank i reads shard i of each
    batch) gives one device's losses and grad norms within 1e-6
    relative."""
    for rank in run.ranks:
        got = rank["trainer"]["metrics"]
        assert len(got) == W.TRAINER_STEPS
        for g_m, w_m in zip(got, run.straight.metrics_log):
            for key in ("loss", "grad_norm"):
                assert abs(g_m[key] - w_m[key]) <= PORT_LOSS_RTOL * abs(
                    w_m[key]), key


def test_mesh_checkpoint_loads_in_both_packages(run):
    """The leader's step-2 checkpoint equals the gathered state bit for
    bit and loads in the reference's ``load_checkpoint`` and on one device
    (a single-device Trainer's checkpoint of the same tree alongside)."""
    cfg = run.cfg
    gathered = TS.state_to_numpy(TO.tree_map(
        torch.as_tensor, run.ranks[0]["trainer"]["gathered"]), cfg)
    like = jax.tree.map(np.zeros_like, gathered)
    ref_tree, ref_step = JC.load_checkpoint(like, run.dirs["trainer"],
                                            step=W.TRAINER_STEPS)
    tree, step = TC.load_checkpoint(like, run.dirs["trainer"],
                                    step=W.TRAINER_STEPS)
    assert ref_step == step == W.TRAINER_STEPS
    for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree),
                       jax.tree.leaves(gathered)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    state = TS.state_from_numpy(tree, cfg, "cpu")
    single, _ = TC.load_checkpoint(like, run.dirs["single"],
                                   step=W.TRAINER_STEPS + 1)
    assert int(state["opt"]["step"]) == W.TRAINER_STEPS
    assert int(single["opt"]["step"]) == W.TRAINER_STEPS + 1


def test_resume_on_a_1x2_mesh_continues(run):
    """Ranks 0 and 1 as a 1x2 mesh resume from the 2x2 mesh's checkpoint
    and run step 3: its loss is the straight single-device Trainer's third
    within 1e-6 relative, and the final checkpoint holds that Trainer's
    parameters within TRAINER_PARAM_ATOL."""
    for rank in run.ranks[:2]:
        got = rank["resume"]
        assert len(got) == 1
        want = run.straight.metrics_log[W.TRAINER_STEPS]
        assert abs(got[0]["loss"] - want["loss"]) <= \
            PORT_LOSS_RTOL * abs(want["loss"])
    assert run.ranks[2]["resume"] is None and run.ranks[3]["resume"] is None
    cfg = run.cfg
    want = TS.state_to_numpy(run.straight_state, cfg)
    like = jax.tree.map(np.zeros_like, want)
    got, step = TC.load_checkpoint(like, run.dirs["trainer"])
    assert step == W.TRAINER_STEPS + 1
    _assert_trees_close(got["params"], want["params"], TRAINER_PARAM_ATOL)


def test_elastic_reshard_2x2_to_1x2(run):
    """``ElasticMeshManager.reshard`` onto the 1x2 mesh: each rank's blocks
    are its slices of the host tree under the 1x2 layout, and gathered they
    equal the host tree exactly."""
    rules = make_rules(AbstractMesh((1, 2), ("data", "model")))
    host = TO.tree_map(lambda t: t.detach().numpy(), run.params)
    specs = rules.tree_pspecs(host)
    for rank in run.ranks[:2]:
        got = rank["reshard"]
        m = got["coord"][1]
        for leaf, block, whole, spec in zip(
                TO.tree_leaves(host), TO.tree_leaves(got["blocks"]),
                TO.tree_leaves(got["gathered"]), TO.tree_leaves(specs)):
            np.testing.assert_array_equal(whole, leaf)
            want = leaf
            for axis, e in enumerate(spec):
                if e == "model":
                    n = leaf.shape[axis] // 2
                    want = np.take(want, range(m * n, (m + 1) * n), axis)
            np.testing.assert_array_equal(block, want)
    assert run.ranks[2]["reshard"] is None


def _first_half(x):
    """The first half of a tensor's or an array's last axis (a stand-in
    for a rank's block)."""
    return x[..., :max(1, x.shape[-1] // 2)].copy() if isinstance(
        x, np.ndarray) else x[..., :max(1, x.shape[-1] // 2)].clone()


def test_init_place_keeps_the_draws():
    """``init_train_state(place=)``, as a mesh rank draws its state (each
    part cut as it is drawn): the same values as the whole init, cut
    afterwards, and moments shaped as the parameters kept."""
    cfg, tcfg = reduced_config(W.TRAIN_ARCH), W.train_tcfg()
    whole = TS.init_train_state(cfg, tcfg, torch.Generator().manual_seed(3),
                                "cpu")
    cut = TS.init_train_state(
        cfg, tcfg, torch.Generator().manual_seed(3), "cpu",
        place=lambda path, part: TO.tree_map(_first_half, part))
    for a, b, m in zip(TO.tree_leaves(cut["params"]),
                       TO.tree_leaves(whole["params"]),
                       TO.tree_leaves(cut["opt"]["m"])):
        torch.testing.assert_close(a, _first_half(b), rtol=0, atol=0)
        assert m.shape == a.shape


def test_load_checkpoint_place_reads_blocks(tmp_path):
    """``load_checkpoint(place=)``, as a mesh rank resumes: every leaf
    passes through ``place`` with its path as it is read, and the tree
    holds what ``place`` kept."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 6)).astype(np.float32),
            "b": [rng.normal(size=(2, 8)).astype(np.float32)],
            "step": np.asarray(7, np.int32)}
    TC.save_checkpoint(tree, str(tmp_path), 1)
    seen = []

    def place(path, leaf):
        seen.append(path)
        return _first_half(leaf) if leaf.ndim else leaf

    got, step = TC.load_checkpoint(jax.tree.map(np.zeros_like, tree),
                                   str(tmp_path), place=place)
    assert step == 1 and sorted(seen) == ["a", "b/0", "step"]
    np.testing.assert_array_equal(got["a"], tree["a"][:, :3])
    np.testing.assert_array_equal(got["b"][0], tree["b"][0][:, :4])
    assert int(got["step"]) == 7


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launch_train_mesh_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --mesh 2,2`` runs
    two reduced qwen2-moe steps (EP: 4 of its 8 experts a rank) on four
    spawned gloo ranks, the same loss on every rank, and one reduced
    mamba2-130m step (SSM blocks, their leaves read whole)."""
    ranks = launch_train.main(
        ["--arch", W.MOE_ARCH, "--steps", "2", "--batch", "4", "--seq",
         "16", "--ckpt-dir", str(tmp_path), "--device", "cpu", "--mesh",
         "2,2"])
    out = capsys.readouterr().out
    assert "the same loss on every rank: True" in out
    assert f"done: 2 steps of {W.MOE_ARCH} on a 2x2 mesh" in out
    assert [len(r["metrics"]) for r in ranks] == [2] * 4
    assert all(np.isfinite(m["loss"]) for m in ranks[0]["metrics"])
    assert TC.latest_step(str(tmp_path)) == 2
    ranks = launch_train.main(
        ["--arch", "mamba2-130m", "--steps", "1", "--batch", "4", "--seq",
         "16", "--ckpt-dir", str(tmp_path / "ssm"), "--device", "cpu",
         "--mesh", "2,2"])
    out = capsys.readouterr().out
    assert "the same loss on every rank: True" in out
    assert [len(r["metrics"]) for r in ranks] == [1] * 4
    assert np.isfinite(ranks[0]["metrics"][0]["loss"])
