"""The port's MoE FFN held against the reference on the CPU: routing, the
capacity rule, which (token, expert) pairs drop and every (expert, slot)
assignment exactly equal, outputs and the router's aux loss within 1e-5;
and reduced qwen2-moe-a2.7b (the same seeded weights in both packages)
served through PagedEngine beside the reference's engine, greedy and with
replayed speculative drafts, also where capacity binds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig as TConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import PagedEngine, Request, ServeConfig
from repro_torch.sharding.api import mesh_shape
from repro_torch.sharding.rules import moe_branch
from _torch_threads import one_thread  # noqa: F401

ARCH = "qwen2-moe-a2.7b"


def _t(a):
    return torch.as_tensor(np.array(a))


class _BufSpy:
    """Stands in for ``jnp`` inside the reference's moe module and keeps
    the dispatch buffer its first expert product reads."""

    def __init__(self):
        self.bufs = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "ecd,edh->ech" and len(self.bufs) % 2 == 0:
            self.bufs.append(np.asarray(ops[0]))
        elif spec == "ecd,edh->ech":
            self.bufs.append(None)
        return jnp.einsum(spec, *ops, **kw)


def _moe_params(cfg, seed):
    jp = JM.init_moe(jax.random.PRNGKey(seed), cfg)
    return jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp)


def _moe_inputs(case, D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 8, D)).astype(np.float32)
    if case == "pad_rows":
        # An engine batch: empty slots and pad tokens in a chunk carry one
        # repeated row each; they are routed and take capacity.
        x[2] = x[2, 0]
        x[1, 5:] = x[2, 0]
    return x


_CASES = {"free": 8.0, "binding": 1.0, "pad_rows": 1.0}


@pytest.mark.parametrize("case", list(_CASES))
def test_moe_ffn_matches_reference(case, monkeypatch):
    """top_i, the capacity, the drop mask and the whole dispatch buffer
    (so every (expert, slot) assignment) exactly equal; weights, out and
    aux within 1e-5.  Where capacity binds, pairs drop."""
    factor = _CASES[case]
    tcfg = reduced_config(ARCH).replace(moe_capacity_factor=factor)
    jcfg = jreduced(ARCH).replace(moe_capacity_factor=factor)
    jp, tp = _moe_params(jcfg.moe_config(), 1)
    x = _moe_inputs(case, jcfg.d_model)
    spy = _BufSpy()
    monkeypatch.setattr(JM, "jnp", spy)
    jout, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg.moe_config())
    monkeypatch.undo()

    mcfg = tcfg.moe_config()
    x2d = _t(x).reshape(-1, x.shape[-1])
    probs, top_p, top_i = TM._route_rows(tp, x2d, mcfg)
    aux = TM._aux_loss(probs, top_i, mcfg)
    jtop_p, jtop_i, jaux2 = JM._route(jp, jnp.asarray(x.reshape(x2d.shape)),
                                      jcfg.moe_config())
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p),
                               atol=1e-6, rtol=1e-6)
    T = x2d.shape[0]
    cap = TM._capacity(T, mcfg.top_k, mcfg.n_routed, mcfg.capacity_factor)
    assert cap == JM._capacity(T, mcfg.top_k, mcfg.n_routed,
                               mcfg.capacity_factor)
    buf, (order, e_idx, s_idx, valid) = TM.dispatch(
        x2d, top_i, mcfg, mcfg.n_routed, cap)
    np.testing.assert_array_equal(buf.numpy(), spy.bufs[0])
    # The drop mask in (token, k) order; each expert's filled slots in the
    # reference's buffer number its rows that fit.
    dropped = torch.zeros_like(valid)
    dropped[order] = ~valid
    dropped = dropped.reshape(T, mcfg.top_k).numpy()
    filled = (spy.bufs[0] != 0).any(-1).sum(-1)
    kept = np.bincount(e_idx[valid].numpy(), minlength=mcfg.n_routed)
    np.testing.assert_array_equal(filled, kept)
    n_drop = int(dropped.sum())
    assert (n_drop > 0) == (case != "free"), n_drop

    out, taux = TM.moe_ffn(tp, _t(x), mcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux2), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_CASES))
def test_moe_ffn_on_card_reads_nothing_back(case):
    """On the card the MoE FFN runs with no device-to-host sync (CUDA's
    sync debug mode turns one into an error), and its routing, plan and
    dispatch buffer equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mcfg = reduced_config(ARCH).replace(
        moe_capacity_factor=_CASES[case]).moe_config()
    _, tp = _moe_params(jreduced(ARCH).moe_config(), 1)
    x = _t(_moe_inputs(case, mcfg.d_model))
    cp = jax.tree.map(lambda a: a.cuda(), tp)
    cx = x.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = TM.moe_ffn(cp, cx, mcfg)
        _, _, top_i = TM._route_rows(cp, cx.reshape(-1, mcfg.d_model), mcfg)
        cap = TM._capacity(top_i.shape[0], mcfg.top_k, mcfg.n_routed,
                           mcfg.capacity_factor)
        buf, plan = TM.dispatch(cx.reshape(-1, mcfg.d_model), top_i, mcfg,
                                mcfg.n_routed, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, _, want_i = TM._route_rows(tp, x.reshape(-1, mcfg.d_model), mcfg)
    want_buf, want_plan = TM.dispatch(x.reshape(-1, mcfg.d_model), want_i,
                                      mcfg, mcfg.n_routed, cap)
    assert torch.equal(top_i.cpu(), want_i)
    assert torch.equal(buf.cpu(), want_buf)
    for a, b in zip(plan, want_plan):
        assert torch.equal(a.cpu(), b)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("T,k,E,f", [(64, 4, 60, 1.25), (4, 4, 60, 1.25),
                                     (20, 4, 60, 1.25), (256, 4, 60, 1.25),
                                     (16, 2, 8, 1.0), (48, 8, 256, 1.25)])
def test_capacity_matches_reference(T, k, E, f):
    """One 64-token prefill chunk of qwen2-moe-a2.7b gets 8 slots an
    expert for 256 rows over 60 experts (4.3 on average): capacity binds
    at full width."""
    assert TM._capacity(T, k, E, f) == JM._capacity(T, k, E, f)


def test_dispatch_is_stable_and_split_routing_equal():
    """Slots follow the (token, k) order within an expert (a stable
    sort); a verify's per-column routing gives the bits of the whole-call
    routing; a mesh picks the reference's branch."""
    cfg = reduced_config(ARCH).replace(moe_capacity_factor=1.0)
    mcfg = cfg.moe_config()
    top_i = torch.tensor([[0, 1]] * 12)
    order, e_idx, s_idx, valid = TM.dispatch_plan(top_i, 8, 8)
    rows = torch.arange(24)[order]
    assert rows[:12].tolist() == list(range(0, 24, 2))
    assert s_idx[:8].tolist() == list(range(8))
    assert valid.tolist() == [True] * 8 + [False] * 4 + [True] * 8 + \
        [False] * 4
    jp, tp = _moe_params(jreduced(ARCH).moe_config(), 2)
    x = _t(_moe_inputs("pad_rows", cfg.d_model, 5))
    whole, a1 = TM.moe_ffn(tp, x, mcfg)
    split, a2 = TM.moe_ffn(tp, x, mcfg, split=True)
    assert torch.equal(whole, split) and torch.equal(a1, a2)
    # A mesh with a "model" dim > 1 runs the reference's branch for the
    # config (tests/test_torch_mesh_moe.py holds each on a 2x2 mesh); the
    # stand-in carries what the choice reads of a DeviceMesh.
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.arange(4).reshape(2, 2))
    shape = mesh_shape(mesh)
    assert moe_branch(shape, mcfg.n_routed, mcfg.resident) == "ep"
    assert moe_branch(shape, mcfg.n_routed, True) == "resident"
    assert moe_branch(shape, 7, False) == "tp"


@pytest.fixture(scope="module")
def ref_params():
    """Reduced qwen2-moe's parameters, drawn by the port (seeded) and
    stacked into the reference's layout (the capacity factor does not
    change them)."""
    cfg = reduced_config(ARCH)
    params = TT.init_model(cfg, torch.Generator().manual_seed(0))
    seg = [jax.tree.map(lambda t: t.numpy(), u) for u in params["seg0"]]
    tree = {key: jax.tree.map(lambda t: t.numpy(), val)
            for key, val in params.items() if key != "seg0"}
    tree["seg0"] = jax.tree.map(lambda *xs: np.stack(xs), *seg)
    return jax.tree.map(jnp.asarray, tree)


def test_moe_block_and_model_aux_match_reference(ref_params):
    """``forward`` returns the router aux losses summed over the MoE
    layers (zeros before this slice)."""
    jcfg = jreduced(ARCH).replace(moe_capacity_factor=1.0)
    tcfg = reduced_config(ARCH).replace(moe_capacity_factor=1.0)
    jp = ref_params
    tp = TT.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    assert tp["seg0"][0]["b0"]["moe"]["wi_gate"].shape == (8, 64, 32)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(
        np.int32)
    jl, _, jaux = JT.forward(jp, jnp.asarray(tokens), jcfg)
    tl, _, taux = TT.forward(tp, _t(tokens), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# reduced qwen2-moe served through PagedEngine beside the reference
# ---------------------------------------------------------------------------

# The reference's tests/test_serving.py paged engine geometry.
_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)
_NEW = 8


class _Replay:
    """Drafts the tokens a recorded plain run generated after the same
    context."""

    def __init__(self, prompts, generated):
        self.runs = [(np.asarray(p), list(g))
                     for p, g in zip(prompts, generated)]

    def propose(self, context, k):
        for prompt, gen in self.runs:
            n = len(context) - len(prompt)
            if (0 < n <= len(gen) and np.array_equal(context[:len(prompt)],
                                                     prompt)
                    and list(context[len(prompt):]) == gen[:n]):
                return gen[n:n + k]
        return []


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, L, dtype=np.int32) for L in (5, 11, 14, 9)]


def _tree(caches):
    return {f"{seg}.{b}.{key}": np.asarray(val)
            for seg, units in caches.items()
            for b, layer in (units.items() if isinstance(units, dict)
                             else units[0].items())
            for key, val in layer.items()}


@pytest.fixture(scope="module", params=[8.0, 1.0], ids=["free", "binding"])
def served(request, ref_params):
    """The reference engine's plain and replayed-speculative runs, with
    each tick's tokens, tables, fill levels and allocator state."""
    factor = request.param
    jcfg = jreduced(ARCH).replace(attn_impl="bitstopper_xla",
                                  bitstopper=JConfig(alpha=0.8),
                                  moe_capacity_factor=factor)
    tcfg = reduced_config(ARCH).replace(attn_impl="bitstopper_xla",
                                        bitstopper=TConfig(alpha=0.8),
                                        moe_capacity_factor=factor)
    jparams = ref_params
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    runs = {}
    drafter = None
    for mode in ("plain", "spec"):
        kw = dict(speculative="draft", draft_k=4) if mode == "spec" else {}
        eng = JEngine(jcfg, jparams, JServe(fused_decode=False, **_KW, **kw),
                      **({"drafter": drafter} if drafter else {}))
        reqs = [eng.submit(JRequest(prompt=p.copy(), max_new_tokens=_NEW))
                for p in _prompts()]
        eng.begin(0)
        ticks = []
        while eng.pending():
            eng.step()
            ticks.append(([list(r.generated) for r in reqs],
                          eng.pool.snapshot(), eng.table.copy(),
                          eng.lengths.copy()))
        runs[mode] = (ticks, dict(eng.counters),
                      _tree(jax.tree.map(np.asarray, eng.caches)))
        drafter = _Replay(_prompts(), [r.generated for r in reqs])
    return tcfg, tparams, runs, drafter


@pytest.mark.parametrize("mode,fused", [("plain", True), ("plain", False),
                                        ("spec", True)])
def test_moe_engine_matches_reference(served, mode, fused, monkeypatch):
    """Tick by tick: tokens, tables, fill levels and allocator state equal
    the reference's; at the end the counters too, and every cache leaf
    of the pools (integers exactly, f32 K/V and scales within 1e-3).  Pairs drop where
    capacity binds, and replayed speculation gives the plain tokens."""
    tcfg, tparams, runs, drafter = served
    ticks, counters, jtree = runs[mode]
    drops = []
    plan = TM.dispatch_plan

    def spy(*a):
        res = plan(*a)
        drops.append(int((~res[3]).sum()))
        return res

    monkeypatch.setattr(TM, "dispatch_plan", spy)
    kw = dict(speculative="draft", draft_k=4) if mode == "spec" else {}
    eng = PagedEngine(tcfg, tparams, ServeConfig(fused_decode=fused, **_KW,
                                                 **kw),
                      device="cpu", drafter=drafter if kw else None)
    reqs = [eng.submit(Request(prompt=p.copy(), max_new_tokens=_NEW))
            for p in _prompts()]
    n = 0
    while eng.pending():
        eng.step()
        toks, snap, table, lengths = ticks[n]
        n += 1
        assert [r.generated for r in reqs] == toks, n
        assert eng.pool.snapshot() == snap, n
        np.testing.assert_array_equal(eng.table, table)
        np.testing.assert_array_equal(eng.lengths, lengths)
    assert n == len(ticks)
    assert dict(eng.counters) == counters
    got = _tree(TT.caches_to_numpy(eng.caches, tcfg))
    for key, val in jtree.items():
        if key.endswith((".table", ".length")):
            continue            # the last forward's attachment, held above
        if val.dtype.kind == "f":
            np.testing.assert_allclose(got[key], val, atol=1e-3, rtol=1e-3,
                                       err_msg=key)
        elif key.endswith(".kq"):
            # A last-bit K difference can flip a plane bit (ROADMAP C4).
            assert (got[key] != val).mean() < 1e-3, key
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)
    binding = tcfg.moe_capacity_factor == 1.0
    assert (sum(drops) > 0) == binding
    if mode == "spec":
        assert toks == runs["plain"][0][-1][0]
        assert eng.counters["spec_ticks"] > 0
        assert eng.counters["spec_accepted"] > 0


def test_serve_cli_moe_on_cpu(capsys):
    """``--arch qwen2-moe-a2.7b`` serves (the reduced config, as the
    reference's launcher does)."""
    tserve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                 "--new-tokens", "4", "--max-prompt", "20"])
    out = capsys.readouterr().out
    assert "3 requests / 12 new tokens" in out
    assert "'requests_finished': 3" in out


def test_speculative_moe_c9(ref_params):
    """ROADMAP C9: where capacity binds, a verify forward (B x (k+1)
    tokens, pad rows of idle slots included, with that call's capacity)
    drops pairs that decoding the same tokens keeps, so replayed
    speculation leaves the plain tokens in the reference and, following
    it, in the port, which gives the reference's tokens.  With a capacity
    no call can bind (n_routed / top_k), the port's speculation gives the
    plain tokens."""
    kw = dict(attn_impl="bitstopper_xla", moe_capacity_factor=1.0)
    jcfg = jreduced(ARCH).replace(bitstopper=JConfig(alpha=0.8), **kw)
    tcfg = reduced_config(ARCH).replace(bitstopper=TConfig(alpha=0.8), **kw)
    tparams = TT.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   tcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, L, dtype=np.int32) for L in (17, 13, 11)]
    new = (4, 9, 8)
    geo = dict(_KW, max_slots=4)

    def serve(make, Req, Cfg, params, cfg, drafter=None, **kw):
        spec = dict(speculative="draft", draft_k=4) if drafter else {}
        eng = make(cfg, params, Cfg(fused_decode=False, **geo, **spec),
                   **({"drafter": drafter} if drafter else {}), **kw)
        reqs = [Req(prompt=p.copy(), max_new_tokens=n)
                for p, n in zip(prompts, new)]
        eng.generate(reqs)
        return [r.generated for r in reqs]

    jplain = serve(JEngine, JRequest, JServe, ref_params, jcfg)
    jspec = serve(JEngine, JRequest, JServe, ref_params, jcfg,
                  _Replay(prompts, jplain))
    tplain = serve(PagedEngine, Request, ServeConfig, tparams, tcfg,
                   device="cpu")
    tspec = serve(PagedEngine, Request, ServeConfig, tparams, tcfg,
                  _Replay(prompts, tplain), device="cpu")
    assert jspec != jplain
    assert (tplain, tspec) == (jplain, jspec)
    free = tcfg.replace(moe_capacity_factor=tcfg.n_routed / tcfg.top_k)
    plain = serve(PagedEngine, Request, ServeConfig, tparams, free,
                  device="cpu")
    assert serve(PagedEngine, Request, ServeConfig, tparams, free,
                 _Replay(prompts, plain), device="cpu") == plain
