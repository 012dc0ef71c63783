"""Sequence parallelism in the PyTorch port's mesh training on the CPU:
``make_rules(sequence_parallel=True)`` on a 2x2 (data, model)
``DeviceMesh`` of spawned gloo ranks, held to one device's step in both
packages (``tests/_torch_mesh_train_ref.py``) for reduced stablelm-1.6b
and each other block kind: qwen2-moe's experts in EP and resident,
mamba2-130m's SSM blocks, recurrentgemma-2b's RG-LRU blocks and MQA
local attention, deepseek-v3's MLA with MoE and its MTP block.

Between blocks the residual stream is a rank's half of the sequence; each
block gathers it (``sharding/api.py:seq_gather``, whose backward is a
reduce-scatter) and leaves by a reduce-scatter of its partial sums or its
part of a whole result (``leave_model``), so scans, windows and MoE
routing see the whole sequence.  Every weight not split over "model"
sums its gradient over "model" too: each rank's norms, router and whole
blocks see its part of the sequence only, and a leaf that got half its
gradient would still move, so the gradients are held leaf by leaf.  A
sequence that "model" does not divide stays whole, as ``MeshRules``
replicates an indivisible dim.

One module-scoped spawn (``tests/_torch_mesh_worker.py:zoo_train_rank``)
runs every case while the pytest process compiles the reference's steps
(``FAST_XLA``) and runs the port's single-device steps.
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import start_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding.api import (AbstractMesh, seq_parallel,
                                      seq_rules)
from repro_torch.sharding.rules import make_rules

import _torch_mesh_train_ref as R
import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

CASES = list(W.SP_CASES)


@pytest.fixture(scope="module")
def run():
    tokens = np.random.default_rng(1).integers(0, 256, (4, 32))
    params = {k: TT.init_model(W.held_config(c),
                               torch.Generator().manual_seed(0), "cpu")
              for k, c in W.SP_CASES.items()}
    job = start_mesh(W.zoo_train_rank, 2, 2, device="cpu", backend="gloo",
                     args=(W.SP_CASES, params, tokens, None),
                     timeout=R.JOIN_S)
    one, ref = {}, {}
    for k, case in W.SP_CASES.items():
        one[k] = R.port_step(case, params[k], tokens,
                             bind=case[1].get("moe_resident", False))
        ref[k] = R.reference_step(case, params[k], tokens)
    ranks = job.join()
    return types.SimpleNamespace(params=params, tokens=tokens, ranks=ranks,
                                 one=one, ref=ref)


def test_sequence_split_follows_divisibility():
    """``make_rules(sequence_parallel=True)`` splits the stream over a
    "model" dim of more than one rank that divides its length; otherwise
    the stream stays whole (a "model" dim of 1, an odd length, a stream
    with patches before its text, whose length is None here, the rules
    without it)."""
    def rules(shape, **kw):
        return make_rules(AbstractMesh(shape, ("data", "model")), **kw)

    assert seq_parallel(seq_rules(rules((2, 2), sequence_parallel=True), 32))
    assert not seq_parallel(seq_rules(rules((2, 2), sequence_parallel=True),
                                      31))
    assert not seq_parallel(seq_rules(rules((4, 1), sequence_parallel=True),
                                      32))
    assert not seq_parallel(seq_rules(rules((2, 2), sequence_parallel=True),
                                      None))
    assert not seq_parallel(seq_rules(rules((2, 2)), 32))


@pytest.mark.parametrize("case", CASES)
def test_sp_mesh_gradients_match_one_device(run, case):
    """At the initial parameters every rank's loss is one device's within
    PORT_LOSS_RTOL and every gradient gathered whole (norm scales, the
    router and the whole SSM/RG-LRU leaves, which sum over "model" under
    SP, among them) is one device's within GRAD_RTOL of its leaf's max."""
    for rank in run.ranks:
        got = rank["cases"][case]
        assert abs(got["loss"] - run.one[case]["loss"]) <= \
            R.PORT_LOSS_RTOL * abs(run.one[case]["loss"])
        R.assert_grads_close(got["grads"], run.one[case]["grads"])


@pytest.mark.parametrize("case", CASES)
def test_sp_mesh_step_matches_one_device(run, case):
    """One step on the 2x2 mesh under sequence parallelism: loss and grad
    norm within PORT_LOSS_RTOL of the port's single-device step, within
    REF_LOSS_TOL and REF_GNORM_RTOL of the reference's; the gathered
    parameters within PORT_PARAM_ATOL and REF_PARAM_ATOL (2 lr where one
    device's clipped gradient is below FLAT_G)."""
    cfg = W.held_config(W.SP_CASES[case])
    for rank in run.ranks:
        R.assert_held(rank["cases"][case], run.one[case], run.ref[case], cfg)


@pytest.mark.parametrize("case", CASES)
def test_sp_mesh_step_moves_every_parameter_and_ranks_agree(run, case):
    """Every leaf moved by more than MOVED_MIN in the step, and every rank
    reports the same metrics and gathers the same parameters."""
    cfg = W.held_config(W.SP_CASES[case])
    first = run.ranks[0]["cases"][case]
    R.assert_moved(first["params"], run.params[case], cfg)
    for rank in run.ranks[1:]:
        got = rank["cases"][case]
        assert got["metrics"] == first["metrics"]
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(first["params"])):
            np.testing.assert_array_equal(a, b)


def test_sp_resident_drops_and_aux_are_one_devices(run):
    """Resident experts under SP at capacity factor 0.5: routing sees the
    whole sequence, so the four ranks' dropped pairs together are one
    device's pair for pair, and the aux shares (each rank's part of the
    sequence, summed over "model") sum over the data ranks to one
    device's aux loss within 1e-6 relative."""
    want = run.one["qwen_resident"]["bind"]
    assert all(want["drops"])
    union = [sorted(set().union(*calls)) for calls in zip(
        *(r["cases"]["qwen_resident"]["bind"]["drops"] for r in run.ranks))]
    assert union == want["drops"]
    for m in range(2):
        shares = [r["cases"]["qwen_resident"]["bind"]["aux"]
                  for r in run.ranks if r["coord"][1] == m]
        np.testing.assert_allclose([sum(x) for x in zip(*shares)],
                                   want["aux"], rtol=R.AUX_RTOL, atol=0)


def test_indivisible_sequence_stays_whole(run):
    """A sequence of 31 positions, which a 2-way "model" dim does not
    divide: the sequence parallel rules train as the rules without it,
    bit for bit (loss, gradients, metrics and parameters)."""
    for rank in run.ranks:
        sp, plain = rank["odd"]["sp"], rank["odd"]["plain"]
        assert sp["loss"] == plain["loss"]
        assert sp["metrics"] == plain["metrics"]
        for a, b in zip(jax.tree.leaves([sp["grads"], sp["params"]]),
                        jax.tree.leaves([plain["grads"], plain["params"]])):
            np.testing.assert_array_equal(a, b)
