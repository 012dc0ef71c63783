"""MoE under a (data, model) mesh of the PyTorch port on the CPU: the
expert-parallel, resident and expert-TP branches of ``moe_ffn``, and
reduced qwen2-moe-a2.7b served by ``PagedEngine`` on a 2x2 gloo mesh, held
to single-device serving, the port's and the reference's.

One module-scoped spawn (``tests/_torch_mesh_worker.py:moe_rank``) runs the
function-level cases and every serving variant on the 2x2 mesh, while the
pytest process runs them on one device and a subprocess (8 forced host
devices, as ``tests/test_sharding_multidev.py`` runs it) runs the
reference's ``moe_ffn`` under its own 2x2 debug mesh and its
single-device serving.

EP and resident ``out`` must equal the port's single device bit for bit
(each pair is computed by one rank, at the single-device capacity, and
moved, not summed, across ranks).  Expert-TP sums partial products over
the ranks' hidden units in rank order: within ``TP_TOL`` of one device,
with equal tokens on the test traces.  Expert-TP needs a "model" dim that
does not divide ``n_routed`` (7 experts here); qwen2-moe's 60 experts
divide 2 and 4, so on the card it does not run, and it is held here only.
"""

import json
import os
import pickle
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.core.besf import BitStopperConfig as JConfig
from repro.serving import PagedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServe
from repro_torch.launch.mesh import start_mesh
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.sharding.rules import MOE_PARAM_RULES, make_serve_rules, \
    moe_branch

import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")
JOIN_S = 120.0
REF_TOL = 2e-4          # tests/test_sharding_multidev.py:85
TP_TOL = 1e-5           # expert-TP against one device (summed in rank order)

# The reference in subprocesses with 8 forced host devices, beside the
# spawn (``reference_main``): one for its moe_ffn, one per served variant.
_REF = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
import test_torch_mesh_moe as M
M.reference_main(*sys.argv[1:])
"""


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.numpy()


def _reference_params(host):
    """The port's seeded parameters (as host arrays) in the reference's
    layout (the segment stacked over its layers)."""
    tree = {k: v for k, v in host.items() if k != "seg0"}
    tree["seg0"] = jax.tree.map(lambda *xs: np.stack(xs), *host["seg0"])
    return jax.tree.map(jax.numpy.asarray, tree)


def _reference_serve(variant, jparams, mode, greedy=None):
    kw = dict(W.MOE_KW, fused_decode=False)
    extra = {}
    if mode == "sampled":
        kw["temperature"] = 0.8
    if mode == "spec":
        kw.update(speculative="draft", draft_k=4)
        extra["drafter"] = W.Replay(W.moe_prompts(), greedy)
    cfg = jreduced(W.MOE_ARCH).replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.8),
        moe_capacity_factor=W.MOE_FACTOR, **W.MOE_VARIANTS[variant])
    eng = JEngine(cfg, jparams, JServe(**kw), **extra)
    reqs = [JRequest(prompt=p, max_new_tokens=W.MOE_NEW)
            for p in W.moe_prompts()]
    eng.generate(reqs, seed=3 if mode == "sampled" else 0)
    return [list(map(int, r.generated)) for r in reqs]


def reference_main(part: str, src: str, dst: str) -> None:
    """The reference's side, run in a subprocess per ``part``: "fn" puts
    each function-level case (pickled in ``src``) through its ``moe_ffn``
    on one device and under its 2x2 debug mesh, with its routing, into the
    npz ``dst``; "ep" or "tp" serves that variant (its parameters pickled
    in ``src``) on its single device in every mode, the tokens to the JSON
    ``dst``.  (EP and resident differ in placement only: one run.)"""
    with open(src, "rb") as f:
        data = pickle.load(f)
    if part != "fn":
        jp = _reference_params(data)
        greedy = _reference_serve(part, jp, "greedy")
        with open(dst, "w") as f:
            json.dump({"greedy": greedy,
                       "sampled": _reference_serve(part, jp, "sampled"),
                       "spec": _reference_serve(part, jp, "spec", greedy)},
                      f)
        return
    import jax.numpy as jnp
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe as JM
    mesh = make_debug_mesh(2, 2)
    out = {}
    for name, (kw, p, x) in data.items():
        cfg = JM.MoEConfig(**kw)
        p = jax.tree.map(jnp.asarray, p)
        x = jnp.asarray(x)
        single, _ = JM.moe_ffn(p, x, cfg, mesh=None)
        meshed, _ = jax.jit(lambda p, x, cfg=cfg: JM.moe_ffn(
            p, x, cfg, mesh=mesh))(p, x)
        _, top_i, _ = JM._route(p, x.reshape(-1, x.shape[-1]), cfg)
        out[name + ".single"] = np.asarray(single)
        out[name + ".mesh"] = np.asarray(meshed)
        out[name + ".top_i"] = np.asarray(top_i)
    np.savez(dst, **out)


def _start_reference(part, src, dst):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen(
        [sys.executable, "-c", _REF.format(tests=_TESTS, src=_SRC), part,
         str(src), str(dst)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    fn = W.moe_fn_inputs()
    params = {v: TT.init_model(W.moe_model_config(v),
                               torch.Generator().manual_seed(0), "cpu")
              for v in W.MOE_VARIANTS}
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({name: (
            {k: getattr(cfg, k) for k in ("d_model", "n_routed", "top_k",
                                          "d_expert", "capacity_factor",
                                          "resident")},
            _host(p), x.numpy()) for name, (cfg, p, x) in fn.items()}, f)
    refs = {"fn": _start_reference("fn", tmp / "cases.pkl",
                                   tmp / "ref.npz")}
    for v in ("ep", "tp"):
        with open(tmp / f"{v}.pkl", "wb") as f:
            pickle.dump({k: (_host(t) if k != "seg0" else
                             [_host(u) for u in t])
                         for k, t in params[v].items()}, f)
        refs[v] = _start_reference(v, tmp / f"{v}.pkl", tmp / f"{v}.json")
    t0 = time.monotonic()
    job = start_mesh(W.moe_rank, 2, 2, device="cpu", backend="gloo",
                     args=(params,), timeout=JOIN_S)
    try:
        single = {}
        for v, p in params.items():
            res = {}
            for mode in W.MOE_MODES:
                res[mode] = W.moe_serve(
                    v, p, mode, greedy_tokens=(res["greedy"]["tokens"]
                                               if mode == "spec" else None))
            single[v] = res
        fn_single = {name: TM.moe_ffn(p, x, cfg)
                     for name, (cfg, p, x) in fn.items()}
        ranks = job.join()
    finally:
        errs = {}
        for part, ref in refs.items():
            try:
                _, errs[part] = ref.communicate(
                    timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
            except subprocess.TimeoutExpired:
                ref.kill()
                raise
    for part, ref in refs.items():
        assert ref.returncode == 0, errs[part]
    with np.load(tmp / "ref.npz") as z:
        ref_fn = dict(z)
    reference = {}
    for v in ("ep", "tp"):
        with open(tmp / f"{v}.json") as f:
            reference[v] = json.load(f)
    reference["resident"] = reference["ep"]
    return types.SimpleNamespace(fn=fn, fn_single=fn_single, ref_fn=ref_fn,
                                 single=single, reference=reference,
                                 ranks=ranks)


# ---------------------------------------------------------------------------
# the branch choice (in process)
# ---------------------------------------------------------------------------


def _mesh(data=2, model=2):
    return types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(data * model).reshape(data, model))


@pytest.mark.parametrize("shape,n_routed,resident,want", [
    ({"data": 2, "model": 2}, 8, False, "ep"),
    ({"data": 2, "model": 2}, 8, True, "resident"),
    ({"data": 2, "model": 2}, 7, False, "tp"),
    ({"data": 2, "model": 2}, 6, True, "ep"),
    ({"data": 2, "model": 4}, 6, False, "tp"),
    ({"data": 2, "model": 1}, 8, True, "single"),
    ({"data": 2, "model": 2}, 60, True, "resident"),
    ({"data": 2, "model": 2}, 0, False, "single"),
])
def test_moe_branch_is_the_references_choice(shape, n_routed, resident,
                                             want):
    """``moe_branch`` picks as ``repro/models/moe.py:153-166`` does, and
    the serving rules place the expert weights for that branch: experts
    over data x model (resident) or "model" (EP), hidden units over
    "model" (expert-TP)."""
    assert moe_branch(shape, n_routed, resident) == want
    rules = make_serve_rules(_mesh(shape["data"], shape["model"]), n_routed,
                             resident)
    spec = rules.pspec(MOE_PARAM_RULES["wi_gate"], (n_routed, 32, 16))
    wo = rules.pspec(MOE_PARAM_RULES["wo"], (n_routed, 16, 32))
    expect = {"ep": (("model", None, None), ("model", None, None)),
              "resident": ((("data", "model"), None, None),
                           (("data", "model"), None, None)),
              "tp": ((None, None, "model"), (None, "model", None)),
              "single": ((None, None, None), (None, None, None))}[want]
    assert (spec, wo) == expect


# ---------------------------------------------------------------------------
# moe_ffn at function level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ep", "resident", "tp"])
def test_moe_ffn_branches_equal_single_device(run, name):
    """On every rank, the whole call and a verify's split call: EP and
    resident bit-equal to the port's single device, expert-TP within
    TP_TOL; the aux loss equal (the router runs replicated)."""
    want, aux = run.fn_single[name]
    for rank in run.ranks:
        got = rank["fn"][name]
        assert torch.equal(got["aux"], aux)
        for key in ("out", "split"):
            if name == "tp":
                torch.testing.assert_close(got[key], want, atol=TP_TOL,
                                           rtol=TP_TOL)
            else:
                assert torch.equal(got[key], want), (name, key)


def _slots(top_i, rows, E):
    """Slot of each (token, k) pair of ``rows`` within its expert, in the
    (token, k) order a stable dispatch gives them."""
    seen = np.zeros(E, np.int64)
    slot = np.zeros(top_i.shape, np.int64)
    for t in rows:
        for j, e in enumerate(top_i[t]):
            slot[t, j] = seen[e]
            seen[e] += 1
    return slot


def _reference_drops(name, cfg, top_i, T):
    """The reference's drop mask under its 2x2 mesh: EP and expert-TP take
    each data shard's tokens at that shard's capacity, resident every
    token at the whole call's (``repro/models/moe.py:183-227``)."""
    shards = [range(T)] if name == "resident" else [range(T // 2),
                                                    range(T // 2, T)]
    drop = np.zeros(top_i.shape, bool)
    for rows in shards:
        cap = TM._capacity(len(rows), cfg.top_k, cfg.n_routed,
                           cfg.capacity_factor)
        slot = _slots(top_i, rows, cfg.n_routed)
        for t in rows:
            drop[t] = slot[t] >= cap
    return drop


def _port_drops(cfg, top_i):
    """The port's drop mask (every branch: the single-device capacity)."""
    T = top_i.shape[0]
    cap = TM._capacity(T, cfg.top_k, cfg.n_routed, cfg.capacity_factor)
    order, _, _, valid = TM.dispatch_plan(torch.as_tensor(top_i),
                                          cfg.n_routed, cap)
    drop = torch.empty_like(valid)
    drop[order] = ~valid
    return drop.reshape(top_i.shape).numpy()


@pytest.mark.parametrize("name", ["ep", "resident", "tp"])
def test_moe_ffn_branches_match_reference_mesh(run, name):
    """Each branch on every rank within 2e-4 of the reference's
    ``moe_ffn`` under ``make_debug_mesh(2, 2)`` (its own tolerance,
    tests/test_sharding_multidev.py); the routing exactly the reference's,
    and the drop masks equal (capacity does not bind here: none drop)."""
    cfg, p, x = run.fn[name]
    top_i = run.ref_fn[name + ".top_i"]
    _, _, port_i = TM._route_rows(p, x.reshape(-1, x.shape[-1]), cfg)
    np.testing.assert_array_equal(port_i.numpy(), top_i)
    want = run.ref_fn[name + ".mesh"].reshape(x.shape)
    for rank in run.ranks:
        np.testing.assert_allclose(rank["fn"][name]["out"].numpy(), want,
                                   atol=REF_TOL, rtol=REF_TOL)
    ref_drop = _reference_drops(name, cfg, top_i, top_i.shape[0])
    port_drop = _port_drops(cfg, top_i)
    np.testing.assert_array_equal(port_drop, ref_drop)
    assert not port_drop.any()


def test_c11_reference_ep_drops_per_data_shard(run):
    """ROADMAP C11.  Where capacity binds (factor 1, 128 tokens over 8
    experts), the reference's EP branch under its 2x2 mesh takes the
    capacity of each data shard's 64 tokens, so it drops other pairs than
    its own single device does and its ``out`` leaves its single-device
    one by far more than its tolerance; the port's mesh keeps the
    single-device capacity: its drops are its single device's (summed over
    the "model" ranks that own them) and its ``out`` is bit-equal."""
    cfg, p, x = run.fn["c11"]
    top_i = run.ref_fn["c11.top_i"]
    T = top_i.shape[0]
    ref_mesh = _reference_drops("ep", cfg, top_i, T)
    single = _port_drops(cfg, top_i)
    assert single.any() and ref_mesh.any()
    assert (ref_mesh != single).any()
    gap = np.abs(run.ref_fn["c11.mesh"] - run.ref_fn["c11.single"]).max()
    assert gap > 100 * REF_TOL, gap
    np.testing.assert_allclose(run.fn_single["c11"][0].numpy().reshape(
        run.ref_fn["c11.single"].shape), run.ref_fn["c11.single"],
        atol=REF_TOL, rtol=REF_TOL)
    want, _ = run.fn_single["c11"]
    by_coord = {r["coord"]: r["fn"]["c11"] for r in run.ranks}
    for d in range(2):
        assert (by_coord[(d, 0)]["dropped"] + by_coord[(d, 1)]["dropped"]
                == int(single.sum()))
    for got in by_coord.values():
        assert torch.equal(got["out"], want)


# ---------------------------------------------------------------------------
# reduced qwen2-moe served on the 2x2 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(W.MOE_VARIANTS))
@pytest.mark.parametrize("mode", W.MOE_MODES)
def test_moe_mesh_tokens_equal_single_device(run, variant, mode):
    """Every rank serves the reference's single-device tokens, and the
    port's: greedy, sampled (temperature 0.8, seed 3) and with replayed
    drafts, at capacity factor 1, where pairs drop."""
    want = run.reference[variant][mode]
    assert all(want)
    assert run.single[variant][mode]["tokens"] == want
    for rank in run.ranks:
        assert rank["serve"][variant][mode]["tokens"] == want, rank["coord"]


def _owners(variant, coord):
    """The mesh positions that share the experts of ``coord``'s data row
    (EP: its "model" row; resident: every rank; expert-TP: itself)."""
    d, _ = coord
    return {"ep": [(d, 0), (d, 1)],
            "resident": [(0, 0), (0, 1), (1, 0), (1, 1)],
            "tp": [coord]}[variant]


@pytest.mark.parametrize("variant", list(W.MOE_VARIANTS))
def test_moe_mesh_counters_and_drops_equal_single_device(run, variant):
    """Every counter on every rank equals single-device serving's, and the
    pairs capacity dropped, summed over the ranks that split the experts,
    are the single device's (some drop in every mode)."""
    by_coord = {r["coord"]: r["serve"][variant] for r in run.ranks}
    for mode in W.MOE_MODES:
        want = run.single[variant][mode]
        assert want["dropped"] > 0
        for coord, res in by_coord.items():
            assert res[mode]["counters"] == want["counters"], (coord, mode)
            got = sum(by_coord[c][mode]["dropped"]
                      for c in _owners(variant, coord))
            assert got == want["dropped"], (coord, mode)
    assert run.single[variant]["spec"]["counters"]["spec_accepted"] > 0


@pytest.mark.parametrize("variant", list(W.MOE_VARIANTS))
def test_moe_mesh_leaves_equal_single_device(run, variant):
    """Every rank's pool leaves equal the single-device leaves at its KV
    heads, in every mode: bit for bit under EP and resident.  Under
    expert-TP the second layer's K/V come from a residual stream within
    float rounding of one device's, so K, V and the scales are held within
    TP_TOL and the fill levels, tables and positions exactly; the packed
    planes quantize that K and are not compared there."""
    for mode in W.MOE_MODES:
        single = run.single[variant][mode]["leaves"]
        for rank in run.ranks:
            m = rank["coord"][1]
            got = rank["serve"][variant][mode]["leaves"]
            for layer, ref in zip(got, single, strict=True):
                for key, want in ref.items():
                    have = layer[key]
                    axis = W.heads_axis(key)
                    if axis is not None:
                        step = want.shape[axis] // 2
                        want = np.take(want, range(m * step,
                                                   (m + 1) * step), axis)
                    if variant != "tp" or want.dtype.kind in "iu" \
                            and key != "kq":
                        np.testing.assert_array_equal(have, want,
                                                      err_msg=key)
                    elif key != "kq":
                        np.testing.assert_allclose(have, want, atol=TP_TOL,
                                                   rtol=TP_TOL, err_msg=key)


@pytest.mark.parametrize("variant,share", [("ep", 2), ("resident", 4),
                                           ("tp", 2)])
def test_rank_holds_its_experts_only(run, variant, share):
    """A rank's engine holds its block of the routed experts, views of the
    weights it was handed: half of them under EP and expert-TP, a quarter
    resident."""
    whole = run.single[variant]["greedy"]["expert_bytes"]
    for rank in run.ranks:
        assert rank["serve"][variant]["greedy"]["expert_bytes"] \
            == whole // share


def test_serve_cli_mesh_moe_with_swap_and_chaos(run, tmp_path, capsys):
    """``launch/serve.py --mesh 1,2`` (after the 2x2 spawn has ended)
    serves reduced qwen2-moe with a swap tier on an oversubscribed pool
    through the chaos harness (a crash at tick 3, restored from the
    snapshot): the single-device launch's tokens, one preemption swapped
    out and in, and the snapshots one device writes, byte for byte."""
    from repro_torch.launch import serve as tserve
    cli = ["--device", "cpu", "--arch", W.MOE_ARCH, "--requests", "4",
           "--new-tokens", "12", "--max-prompt", "40", "--slots", "3",
           "--page-size", "8", "--oversubscribe", "--pool-blocks", "10",
           "--swap-host-bytes", str(1 << 22), "--fault-plan",
           '[["crash", 3]]']
    want = [r.generated for r in tserve.main(
        cli + ["--snapshot-dir", str(tmp_path / "one")])]
    got = [r.generated for r in tserve.main(
        cli + ["--snapshot-dir", str(tmp_path / "mesh"), "--mesh", "1,2"])]
    out = capsys.readouterr().out
    assert got == want and all(want)
    assert "the same tokens on every rank: True" in out
    assert "1 crashes / 1 restores" in out
    assert "'swap_outs': 1, 'swap_ins': 1" in out
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "mesh")) and names
    for name in names:
        for f in ("snapshot.json", "MANIFEST.json"):
            with open(tmp_path / "one" / name / f, "rb") as a, \
                    open(tmp_path / "mesh" / name / f, "rb") as b:
                assert a.read() == b.read(), (name, f)
