"""What ``tests/test_torch_mesh_train_zoo.py`` and
``tests/test_torch_mesh_train_sp.py`` hold a mesh step to, in the pytest
process: one device's step in both packages from the same parameters
(the reference's compiled once per config and batch shape), and the
tolerances, those of ``tests/test_torch_mesh_train.py`` too.

The reference's own sharded step fails (ROADMAP C5), so the yardstick is
one device.  Against it the mesh's loss, grad norm and gradients are held
to the gaps the dense mesh allows.
The parameters after one step are held to PORT_PARAM_ATOL, but where one
device's clipped gradient is below FLAT_G: there Adam's first update,
``lr * g / (|g| + eps)``, turns on the size of a gradient within float
rounding of zero (measured on the CPU: clipped gradients of 1e-9 to 3e-8
where the mesh's sums reassociate, updates up to 0.36 lr apart), and the
update is held to 2 lr, the most two signs can part it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as jreduced
from repro.train import train_step as JS
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

import _torch_mesh_worker as W

JOIN_S = 120.0
# The mesh against the reference's single-device step (lr 1e-3 from step
# 1), here and in tests/test_torch_mesh_train.py.  The reference's sharded
# test allows loss 2e-4 and parameters 2e-3; the gaps measured on the CPU
# for the dense mesh are loss 9.5e-7, grad norm 0 and parameters 3.6e-6
# (Adam turns a last-bit gradient gap where |g| is near eps into up to lr
# times its relative size), and one step moves every leaf by 1e-3 (its
# smallest: 0.999998e-3), so MOVED_MIN sits 25 times above
# REF_PARAM_ATOL: a step that left the parameters alone fails.
REF_LOSS_TOL = 2e-4
REF_GNORM_RTOL = 1e-5
REF_PARAM_ATOL = 2e-5
MOVED_MIN = 5e-4
# The mesh against the port's own single-device step: the TP and data
# sums reassociate float adds (measured for the dense mesh: loss 8.5e-8
# and grad norm 9.2e-8 relative, parameters after a step 6.9e-6, MQA's).
PORT_LOSS_RTOL = 1e-6
PORT_PARAM_ATOL = 2e-5
# Gradients of the mesh against one device's, over each leaf's max |g|
# (measured on the CPU: 1.4e-5 at most, a leaf of the zoo's; the port
# against the reference is held to 1e-4 in tests/test_torch_train.py).
GRAD_RTOL = 5e-5
AUX_RTOL = 1e-6
# A clipped gradient below FLAT_G (ten times Adam's eps) moves its
# parameter by an update that float rounding of the gradient can turn.
FLAT_G = 1e-7
LR = 1e-3
# One reference step compiled without LLVM's costly passes.
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

# bf16 (W.BF16_CASES): the mesh's bf16 step against one device's f32
# step from the same parameters (the control), no further than BF16_K
# times one device's bf16 step is, or than BF16_FLOOR (a quarter of
# bf16's unit roundoff 2^-8), relative: loss, grad norm and each leaf's
# gradient over its max; the share of parameter elements more than a
# bf16 grid step from the control's no more than BF16_K times one
# device's share.  Measured on the CPU, the mesh's gaps over one
# device's: at most 1.8 for a leaf's gradient, 0.10 and 0.53 for the loss
# and grad norm, 0.90 for the share (2501 elements of 212,848 against
# 2767).
BF16_K = 4.0
BF16_FLOOR = 2.0 ** -10
# The k-th and (k+1)-th router probabilities of a token whose top-k
# choice turns on bf16 rounding lie within TIE_RTOL of each other
# (measured: the mesh's first routing choice apart from one device's at
# 7.3e-3).
TIE_RTOL = 2.0 ** -6

_COMPILED: dict = {}


def reference_step(case, params, tokens):
    """The reference's single-device step from ``params`` (the port's
    layout): loss, grad norm and the parameters after it."""
    arch, _, kw = case
    jcfg = jreduced(arch).replace(**kw)
    jtcfg = JS.TrainConfig(optimizer=JAdamWConfig(lr=LR), warmup_steps=0)
    jp = jax.tree.map(jnp.asarray, TT.params_to_numpy(params,
                                                      W.held_config(case)))
    state = {"params": jp, "opt": jinit_opt_state(jp, jtcfg.optimizer)}
    tok = jnp.asarray(tokens)
    key = (arch, tuple(sorted(kw.items())), tokens.shape)
    if key not in _COMPILED:
        _COMPILED[key] = jax.jit(JS.make_train_step(jcfg, jtcfg)).lower(
            state, tok).compile(compiler_options=FAST_XLA)
    state, m = _COMPILED[key](state, tok)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": jax.tree.map(np.asarray, state["params"])}


def port_step(case, params, tokens, bind: bool = False):
    """The port's single-device value_and_grad and step from ``params``;
    with ``bind`` the loss, drops and aux at W.MOE_BIND_FACTOR too."""
    cfg, tcfg = W.held_config(case), W.train_tcfg()

    def clone():
        return TS.trainable(TO.tree_map(lambda t: t.detach().clone(),
                                        params))

    tok = torch.as_tensor(tokens)
    loss, grads = TS.value_and_grad(clone(), tok, cfg, tcfg)
    out = {"loss": float(loss),
           "grads": TO.tree_map(lambda t: t.detach().float().numpy(),
                                grads)}
    if bind:
        bcfg = cfg.replace(moe_capacity_factor=W.MOE_BIND_FACTOR)
        with W.DropSpy() as log, torch.no_grad():
            loss = TS.loss_fn(clone(), tok, bcfg, tcfg)
        out["bind"] = {"loss": float(loss), "drops": log.drops,
                       "aux": log.aux}
    p = clone()
    state = {"params": p, "opt": TO.init_opt_state(p, tcfg.optimizer)}
    state, m = TS.make_train_step(cfg, tcfg)(state, tok)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = TO.tree_map(np.array, TT.params_to_numpy(
        state["params"], cfg))
    return out


def f32_control(case, params, tokens):
    """:func:`port_step` of a bf16 case in f32 from its bf16 ``params``
    (exact in f32): the step bf16 rounding is measured against."""
    arch, rules_kw, kw = case
    f32 = {k: v for k, v in kw.items() if k not in W.BF16}
    return port_step((arch, rules_kw, f32),
                     TO.tree_map(lambda t: t.float(), params), tokens)


def _f32(a):
    """A leaf of ``params_to_numpy`` as float32 (bf16 leaves are their
    bits, uint16)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(k): _f32(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(got, want, rtol=GRAD_RTOL):
    """Gathered gradients (port layout) against one device's, each leaf
    within ``rtol`` of its max |g|."""
    got, want = TO.tree_leaves(got), TO.tree_leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-30)
        gap = float(np.abs(np.asarray(a) - b).max())
        assert gap <= rtol * scale, (i, gap, scale)


def assert_step_close(got, want, one, cfg, atol):
    """Parameters after one step (reference layout) against ``want``:
    within ``atol``, but where one device's clipped gradient (``one``, a
    :func:`port_step` result) is below FLAT_G, within 2 lr.  Returns how
    many elements took the flat allowance."""
    clip = min(1.0, 1.0 / one["metrics"]["grad_norm"])
    flat_g = _flat(TT.params_to_numpy(
        TO.tree_map(lambda g: torch.as_tensor(np.abs(g) * clip),
                    one["grads"]), cfg))
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys() == flat_g.keys()
    n_flat = 0
    for key, w in want.items():
        gap = np.abs(got[key] - w)
        flat = flat_g[key] < FLAT_G
        bad = (gap > atol) & ~flat | (gap > 2 * LR * (1 + 1e-6))
        assert not bad.any(), (key, float(gap.max()),
                               int(bad.sum()), float(flat_g[key][bad][0]))
        n_flat += int(((gap > atol) & flat).sum())
    return n_flat


def assert_moved(got, start, cfg):
    """Every leaf of ``got`` (reference layout) moved from ``start`` (the
    port's initial parameters) by more than MOVED_MIN."""
    start = _flat(TT.params_to_numpy(start, cfg))
    for key, w in _flat(got).items():
        moved = float(np.abs(w - start[key]).max())
        assert moved > MOVED_MIN, (key, moved)


def assert_held(rank_case, one, ref, cfg):
    """A rank's :func:`W.held_step` result against one device's step in
    the port (``one``) and in the reference (``ref``)."""
    got = rank_case
    assert abs(got["loss"] - one["loss"]) <= PORT_LOSS_RTOL * abs(
        one["loss"])
    m, om = got["metrics"], one["metrics"]
    for key in ("loss", "grad_norm"):
        assert abs(m[key] - om[key]) <= PORT_LOSS_RTOL * abs(om[key]), key
    np.testing.assert_allclose(m["loss"], ref["loss"], rtol=REF_LOSS_TOL,
                               atol=REF_LOSS_TOL)
    np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                               rtol=REF_GNORM_RTOL)
    return (assert_step_close(got["params"], one["params"], one, cfg,
                              PORT_PARAM_ATOL),
            assert_step_close(got["params"], ref["params"], one, cfg,
                              REF_PARAM_ATOL))


def assert_bf16_held(got, one, ctrl):
    """A rank's bf16 :func:`W.held_step` result (``got``) against the f32
    control ``ctrl`` no further than one device's bf16 step ``one`` is
    (BF16_K, BF16_FLOOR)."""
    def within(gap_got, gap_one, what):
        assert gap_got <= max(BF16_K * gap_one, BF16_FLOOR), (
            what, gap_got, gap_one)

    for key in ("loss", "grad_norm"):
        c = ctrl["metrics"][key]
        within(abs(got["metrics"][key] - c) / abs(c),
               abs(one["metrics"][key] - c) / abs(c), key)
    for i, (a, b, c) in enumerate(zip(*(TO.tree_leaves(x["grads"])
                                        for x in (got, one, ctrl)))):
        scale = max(float(np.abs(c).max()), 1e-30)
        within(float(np.abs(a - c).max()) / scale,
               float(np.abs(b - c).max()) / scale, ("grad", i))

    def off_grid(params):
        # Elements more than a bf16 grid step (at the control's value)
        # from the control's.
        n, flat = 0, _flat(params)
        for key, c in _flat(ctrl["params"]).items():
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(c),
                                                       1e-30))) - 7)
            n += int((np.abs(flat[key] - c) > step).sum())
        return n

    assert off_grid(got["params"]) <= BF16_K * off_grid(one["params"])
