"""Mesh training of the rest of the model zoo in the PyTorch port on the
CPU: reduced deepseek-v3 (MLA blocks, two with dense FFNs and two with
MoE FFNs in EP, and the MTP block), mamba2-130m (SSM blocks),
recurrentgemma-2b (RG-LRU blocks and MQA local attention) and qwen2-moe
in the resident expert layout (8 experts, 2 a rank), trained under the
reference's ``make_rules`` on a 2x2 (data, model) ``DeviceMesh`` of
spawned gloo ranks and held to one device's step in both packages
(``tests/_torch_mesh_train_ref.py``).

MLA splits its heads (``wq_b``/``wkv_b`` columns, ``wo`` rows) with the
latents entering the region; the SSM and RG-LRU blocks read their leaves
whole (their "model" blocks cut across the channels' parts), so the
"model" split is storage only; resident experts each see the whole batch.
The layouts of the SSM and RG-LRU archs are held to the reference's
``make_rules`` leaf by leaf (the other archs' in
``tests/test_torch_mesh_train.py``).

The resident layout also trains on a 2x2x2 (pod, data, model) mesh,
whose pods hold the same experts.  deepseek-v3's layers also train in
bf16, its published dtype, held to one device's f32 step no further than
one device's bf16 step is (``_torch_mesh_train_ref.py:assert_bf16_held``),
and its top-k routing in bf16 is checked to part from one device's only
at near-ties.

Two module-scoped spawns (``tests/_torch_mesh_worker.py:zoo_train_rank``
on the 2x2 mesh, ``pod_train_rank`` on the 2x2x2 one) run every case
while the pytest process compiles the reference's steps (``FAST_XLA``)
and runs the port's single-device steps and Trainer.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import reduced_config as jreduced
from repro.sharding import rules as JR
from repro.train import train_step as JS
from repro_torch.checkpoint import store as TC
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import start_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding.api import AbstractMesh
from repro_torch.sharding.rules import make_rules
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import Trainer

import _torch_mesh_train_ref as R
import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

CASES = list(W.ZOO_CASES)


def _init(case):
    return TT.init_model(W.held_config(case),
                         torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tokens = np.random.default_rng(1).integers(0, 256, (4, 32))
    params = {k: _init(c) for k, c in W.ZOO_CASES.items()}
    bf16 = {k: _init(c) for k, c in W.BF16_CASES.items()}
    bf16["bf16_routed"] = _init(W.BF16_ROUTED)
    dirs = {"mesh": str(tmp_path_factory.mktemp("zoo_mesh_trainer")),
            "single": str(tmp_path_factory.mktemp("zoo_single_trainer"))}
    job = start_mesh(W.zoo_train_rank, 2, 2, device="cpu", backend="gloo",
                     args=(dict(W.ZOO_CASES, **W.BF16_CASES),
                           dict(params, **bf16), tokens, dirs["mesh"]),
                     timeout=R.JOIN_S)
    pod = start_mesh(W.pod_train_rank, 2, 2, pod=2, device="cpu",
                     backend="gloo", args=(W.ZOO_CASES["resident"],
                                           params["resident"], tokens),
                     timeout=R.JOIN_S)
    one, ref, ctrl = {}, {}, {}
    for k, case in W.ZOO_CASES.items():
        one[k] = R.port_step(case, params[k], tokens,
                             bind=case[1].get("moe_resident", False))
        ref[k] = R.reference_step(case, params[k], tokens)
    for k, case in W.BF16_CASES.items():
        one[k] = R.port_step(case, bf16[k], tokens)
        ctrl[k] = R.f32_control(case, bf16[k], tokens)
    routes = W.routing_ids(W.BF16_ROUTED, bf16["bf16_routed"],
                           torch.as_tensor(tokens))
    case = W.ZOO_CASES[W.ZOO_TRAINER_CASE]
    tcfg, trun, data = W.held_trainer_config(case, W.TRAINER_STEPS + 1,
                                             dirs["single"])
    straight = Trainer(W.held_config(case), tcfg, trun, data_cfg=data,
                       device="cpu")
    straight_state = straight.train()
    ranks = job.join()
    return types.SimpleNamespace(
        params=params, tokens=tokens, dirs=dirs, ranks=ranks, one=one,
        ref=ref, ctrl=ctrl, routes=routes, pod=pod.join(),
        straight=straight, straight_state=straight_state)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

_MESHES = {"2x2": ((2, 2), ("data", "model")),
           "pod 2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _flat_specs(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(_MESHES))
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_layouts_match_reference(arch, mesh, fsdp):
    """Every parameter of the SSM and RG-LRU archs has the reference's
    ``make_rules`` spec (the "model" blocks the blocks gather whole), with
    FSDP or not, on a 2x2 mesh and on one with "pod"; recurrentgemma's
    unscanned tail segment leaf by leaf."""
    shape, names = _MESHES[mesh]
    jrules = JR.make_rules(JAbstractMesh(shape, names), fsdp=fsdp)
    jshapes = jax.eval_shape(
        lambda k: JS.init_train_state(k, jreduced(arch), JS.TrainConfig()),
        jax.random.PRNGKey(0))["params"]
    want = _flat_specs(jrules.tree_pspecs(jshapes))
    cfg = reduced_config(arch)
    specs = TS.param_specs(cfg, make_rules(AbstractMesh(shape, names),
                                           fsdp=fsdp))
    got = {}
    for key, val in specs.items():
        reps = cfg.segments[int(key[3:])][1] if key.startswith("seg") else 0
        if reps > 1 and cfg.scan_layers:
            assert all(v == val[0] for v in val[1:]), key
            val = jax.tree.map(lambda s: (None,) + s if s else s, val[0],
                               is_leaf=lambda x: isinstance(x, tuple))
        got.update({f"{key}/{k}": v for k, v in _flat_specs(val).items()})
    assert got == want


# ---------------------------------------------------------------------------
# The mesh step against one device's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_zoo_mesh_gradients_match_one_device(run, case):
    """At the initial parameters every rank's loss is one device's within
    PORT_LOSS_RTOL and every gradient gathered whole is one device's
    within GRAD_RTOL of its leaf's max."""
    for rank in run.ranks:
        got = rank["cases"][case]
        assert abs(got["loss"] - run.one[case]["loss"]) <= \
            R.PORT_LOSS_RTOL * abs(run.one[case]["loss"])
        R.assert_grads_close(got["grads"], run.one[case]["grads"])


@pytest.mark.parametrize("case", CASES)
def test_zoo_mesh_step_matches_one_device(run, case):
    """One step on the 2x2 mesh: loss and grad norm within PORT_LOSS_RTOL
    of the port's single-device step, within REF_LOSS_TOL and
    REF_GNORM_RTOL of the reference's; the gathered parameters within
    PORT_PARAM_ATOL and REF_PARAM_ATOL (2 lr where one device's clipped
    gradient is below FLAT_G)."""
    cfg = W.held_config(W.ZOO_CASES[case])
    for rank in run.ranks:
        R.assert_held(rank["cases"][case], run.one[case], run.ref[case], cfg)


@pytest.mark.parametrize("case", CASES)
def test_zoo_mesh_step_moves_every_parameter_and_ranks_agree(run, case):
    """Every leaf of the gathered parameters moved by more than MOVED_MIN
    in the step, so a mesh step that left a leaf alone fails the limits
    above, and every rank reports the same metrics and gathers the same
    parameters."""
    cfg = W.held_config(W.ZOO_CASES[case])
    first = run.ranks[0]["cases"][case]
    R.assert_moved(first["params"], run.params[case], cfg)
    for rank in run.ranks[1:]:
        got = rank["cases"][case]
        assert got["metrics"] == first["metrics"]
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)


def test_resident_drops_and_aux_are_one_devices(run):
    """Resident experts at capacity factor 0.5 (pairs drop in every
    layer): each rank plans its own two experts over the whole batch, and
    the dropped (token, expert) pairs of the four ranks together equal
    one device's pair for pair; the data ranks' aux shares sum to one
    device's aux loss within 1e-6 relative; the loss is one device's."""
    want = run.one["resident"]["bind"]
    assert all(want["drops"])
    union = [sorted(set().union(*calls)) for calls in zip(
        *(r["cases"]["resident"]["bind"]["drops"] for r in run.ranks))]
    assert union == want["drops"]
    for m in range(2):
        shares = [r["cases"]["resident"]["bind"]["aux"] for r in run.ranks
                  if r["coord"][1] == m]
        np.testing.assert_allclose([sum(x) for x in zip(*shares)],
                                   want["aux"], rtol=R.AUX_RTOL, atol=0)
    for rank in run.ranks:
        got = rank["cases"]["resident"]["bind"]["loss"]
        assert abs(got - want["loss"]) <= R.PORT_LOSS_RTOL * abs(
            want["loss"])


def test_resident_pod_mesh_step_matches_one_device(run):
    """Resident experts on a 2x2x2 (pod, data, model) mesh: the batch over
    ("pod", "data"), each pod's ranks holding the same experts and running
    its own rows, so the experts' gradients are summed over "pod".  Every
    rank's gradients, loss, grad norm and parameters after one step are
    one device's as on the 2x2 mesh (a pod that kept its own rows' part of
    the gradient fails the gradients), every leaf moved, and the two pods'
    copies agree."""
    case = "resident"
    cfg = W.held_config(W.ZOO_CASES[case])
    first = run.pod[0]["case"]
    assert len(run.pod) == 8
    for rank in run.pod:
        got = rank["case"]
        R.assert_grads_close(got["grads"], run.one[case]["grads"])
        R.assert_held(got, run.one[case], run.ref[case], cfg)
        assert got["metrics"] == first["metrics"]
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)
    R.assert_moved(first["params"], run.params[case], cfg)


@pytest.mark.parametrize("case", list(W.BF16_CASES))
def test_bf16_mesh_step_within_one_devices_rounding(run, case):
    """deepseek-v3's layers in bf16 (MLA, MoE in EP, MTP; its routing made
    continuous): on every rank the loss, grad norm, each leaf's gradient
    and the parameters after one step are no further from one device's
    f32 step from the same parameters than BF16_K times one device's bf16
    step is (or BF16_FLOOR); so the mesh's bf16 paths add no more than
    bf16 rounding does."""
    for rank in run.ranks:
        R.assert_bf16_held(rank["cases"][case], run.one[case],
                           run.ctrl[case])


def test_bf16_routing_parts_only_at_near_ties(run):
    """deepseek-v3 in bf16 with its top-2 of 8 routing: in the first MoE
    call whose routing ids on the mesh differ from one device's, every
    token routed otherwise has its k-th and (k+1)-th router probabilities
    on one device within TIE_RTOL of each other: bf16 rounding of the
    router's input, not the mesh, parts them (a token routed otherwise then
    moves the step by far more than rounding, so the published routing
    is not held to the bf16 limits above)."""
    for rank in run.ranks:
        got = rank["routes"]
        assert len(got) == len(run.routes)
        for (ids, _), (want, probs) in zip(got, run.routes):
            apart = np.nonzero((np.sort(ids, -1) != np.sort(want, -1))
                               .any(-1))[0]
            if len(apart) == 0:
                continue
            k = want.shape[-1]
            top = np.sort(probs, -1)[:, ::-1]
            margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
            assert (margin[apart] < R.TIE_RTOL).all(), margin[apart]
            break


def test_zoo_trainer_over_mesh_resumes_like_one_device(run):
    """``Trainer(rules=)`` on mamba2-130m over the 2x2 mesh: a fresh init
    for two steps and a checkpoint, then a resume for the third: one
    device's straight three steps' losses and grad norms within
    PORT_LOSS_RTOL, and the final checkpoint's parameters within 1e-4 of
    one device's (three steps of Adam over a flat update)."""
    want = run.straight.metrics_log
    for rank in run.ranks:
        first, resumed = rank["trainer"]
        assert [len(first), len(resumed)] == [W.TRAINER_STEPS, 1]
        for g_m, w_m in zip(first + resumed, want):
            for key in ("loss", "grad_norm"):
                assert abs(g_m[key] - w_m[key]) <= R.PORT_LOSS_RTOL * abs(
                    w_m[key]), key
    cfg = W.held_config(W.ZOO_CASES[W.ZOO_TRAINER_CASE])
    want_state = TS.state_to_numpy(run.straight_state, cfg)
    got, step = TC.load_checkpoint(jax.tree.map(np.zeros_like, want_state),
                                   run.dirs["mesh"])
    assert step == W.TRAINER_STEPS + 1
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want_state["params"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                                   rtol=0)
