"""Mesh serving of the PyTorch port on the CPU: ``PagedEngine`` over a 2x2
(data, model) ``DeviceMesh`` of spawned gloo ranks, held to single-device
serving, the port's and the reference's.

Every rank runs the same host scheduler; the pools keep the rank's KV
heads and the paged reads run on its block of slots and heads.  The
invariant is the reference's (``tests/test_serving_sharded.py``,
docs/serving.md "Multi-device serving"): the served tokens equal
single-device serving's on every path.  The reference's own sharded
serving raises for the unscanned config (ROADMAP C10), so every scenario
is held to the reference's single-device tokens, which its own tests pin
to its sharded ones where it runs.

One module-scoped spawn runs every scenario on the 2x2 mesh (then one on
a 1x1 mesh of its rank 0), while the pytest process serves the same
scenarios on one device in both packages; the tests assert on the
results.  The reference
serves through its plain oracle, which its own tests pin to its kernel.
"""

import os
import subprocess
import sys
import textwrap
import time
import types

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
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import start_mesh
from repro_torch.models import attention as A
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                 ServeConfig, StaticBucketEngine)
from repro_torch.sharding.rules import (PAGED_CACHE_RULES, cache_pspecs,
                                        make_serve_rules)

import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHED = [n for n in W.SCENARIOS if n != "breaker"]
# The 2x2 spawn and the C10 subprocess each end within this (both take
# about 30 s alone on the CPU).
JOIN_S = 120.0
CLI = ["--device", "cpu", "--requests", "3", "--new-tokens", "4",
       "--max-prompt", "20", "--fused-decode", "on"]

# The reference under its own 2x2 debug mesh (8 forced host devices, so in
# a subprocess): the unscanned config and reduced qwen2-moe, the prelude's
# ServeConfig.  Each line: the arch, then the error or the tokens.
_C10 = """
    import jax, numpy as np
    from repro.configs import reduced_config
    from repro.core.besf import BitStopperConfig
    from repro.models import transformer as T
    from repro.serving import PagedEngine, Request, ServeConfig
    from repro.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2)
    for arch, kw in (("stablelm-1.6b", dict(scan_layers=False)),
                     ("qwen2-moe-a2.7b", {})):
        cfg = reduced_config(arch).replace(
            attn_impl="bitstopper_xla",
            bitstopper=BitStopperConfig(alpha=0.85), **kw)
        params = T.init_model(jax.random.PRNGKey(0), cfg)
        eng = PagedEngine(cfg, params, ServeConfig(
            max_len=64, max_slots=2, prefill_bucket=4, page_size=8,
            fused_decode=False, mesh=mesh))
        rng = np.random.default_rng(3)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab, n,
                                            dtype=np.int32),
                        max_new_tokens=6) for n in (5, 9, 7)]
        try:
            eng.generate(reqs, seed=0)
            print(arch, "TOKENS", [list(map(int, r.generated)) for r in reqs])
        except ValueError as e:
            print(arch, "ValueError", str(e).splitlines()[0])
"""


def _jconfig(key):
    return jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.85),
        **W.model_kw(key))


def _reference_tokens(scen, jparams):
    """The reference's plain single-device run of a scenario's stream."""
    cfg = _jconfig(scen.get("model", "base"))
    kw = dict(W.serve_kw(scen), fused_decode=False, speculative="off")
    kw.pop("pool_blocks", None)
    kw.pop("oversubscribe", None)
    eng = JEngine(cfg, jparams, JServe(**kw))
    reqs = [JRequest(prompt=p, max_new_tokens=W.NEW_TOKENS)
            for p in W.prompts(cfg.vocab, scen)]
    eng.generate(reqs, seed=0)
    return [list(map(int, r.generated)) for r in reqs]


def _reference_params(params, key):
    """The port's seeded parameters in the reference's layout: a scanned
    segment stacked over its layers."""
    def host(tree):
        return jax.tree.map(lambda t: t.numpy(), tree)
    tree = {k: host(v) for k, v in params.items() if k != "seg0"}
    units = [host(u) for u in params["seg0"]]
    tree["seg0"] = (jax.tree.map(lambda *xs: np.stack(xs), *units)
                    if W.model_config(key).scan_layers else units)
    return jax.tree.map(jax.numpy.asarray, tree)


def _reference_moe_tokens(params):
    """The reference's single-device serving of the prelude's trace by
    reduced qwen2-moe, on the port's seeded parameters (stacked)."""
    def host(tree):
        return jax.tree.map(lambda t: t.numpy(), tree)
    tree = {k: host(v) for k, v in params.items() if k != "seg0"}
    tree["seg0"] = jax.tree.map(lambda *xs: np.stack(xs),
                                *[host(u) for u in params["seg0"]])
    cfg = jreduced("qwen2-moe-a2.7b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.85))
    eng = JEngine(cfg, jax.tree.map(jax.numpy.asarray, tree),
                  JServe(fused_decode=False, **W.SERVE_KW))
    reqs = [JRequest(prompt=p, max_new_tokens=W.NEW_TOKENS)
            for p in W.prompts(cfg.vocab, {})]
    eng.generate(reqs, seed=0)
    return [list(map(int, r.generated)) for r in reqs]


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    c10 = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_C10)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    params = {key: TT.init_model(W.model_config(key),
                                 torch.Generator().manual_seed(0), "cpu")
              for key in ("base", "mqa", "unscanned")}
    params["moe"] = TT.init_model(W.c10_moe_config(),
                                  torch.Generator().manual_seed(0), "cpu")
    t0 = time.monotonic()
    job = start_mesh(W.run_rank, 2, 2, device="cpu", backend="gloo",
                     args=(params,), timeout=JOIN_S)
    try:
        single = {n: W.serve(W.SCENARIOS[n],
                             params[W.SCENARIOS[n].get("model", "base")])
                  for n in MESHED}
        # One reference run per stream (speculation, oversubscription and
        # the kernel do not change the reference's tokens; its own tests
        # hold each to its plain run).
        jparams = {key: _reference_params(params[key], key)
                   for key in ("base", "mqa", "unscanned")}
        streams = {}
        for n in MESHED:
            scen = W.SCENARIOS[n]
            key = W.stream_key(scen)
            if key not in streams:
                streams[key] = _reference_tokens(
                    scen, jparams[scen.get("model", "base")])
        reference = {n: streams[W.stream_key(W.SCENARIOS[n])]
                     for n in W.SCENARIOS}
        moe_single = {name: TM.moe_ffn(p, x, cfg)[0] for name, (cfg, p, x)
                      in W.moe_fn_inputs().items() if name != "c11"}
        api_single = W.disagg_serve("base", params["base"], None,
                                    None)["tokens"]
        c10_moe = _reference_moe_tokens(params["moe"])
        ranks = job.join()
    finally:
        try:
            out, err = c10.communicate(
                timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            c10.kill()
            raise
    return types.SimpleNamespace(single=single, reference=reference,
                                 ranks=ranks, one=ranks[0]["one"],
                                 c10=(c10.returncode, out, err),
                                 moe_single=moe_single,
                                 api_single=api_single, c10_moe=c10_moe)


def _heads_axis(name):
    axes = PAGED_CACHE_RULES[name]
    return axes.index("kv_heads") if "kv_heads" in axes else None


def _block(a, axis, i, n):
    step = a.shape[axis] // n
    return np.take(a, range(i * step, (i + 1) * step), axis=axis)


@pytest.mark.parametrize("name", MESHED)
def test_mesh_tokens_equal_single_device(run, name):
    """Every rank serves the reference's single-device tokens, and the
    port's; none is empty."""
    want = run.reference[name]
    assert all(want), (name, want)
    assert run.single[name]["tokens"] == want
    for r, rank in enumerate(run.ranks):
        assert rank["scenarios"][name]["tokens"] == want, (name, r)


@pytest.mark.parametrize("name", MESHED)
def test_mesh_leaves_equal_single_device(run, name):
    """Every rank's pool leaves equal the single-device leaves at its KV
    heads bit for bit (whole where "model" does not divide the heads);
    ``table`` and ``length`` whole (every rank keeps every slot's)."""
    single = run.single[name]["leaves"]
    for rank in run.ranks:
        m = rank["coord"][1]
        got = rank["scenarios"][name]["leaves"]
        assert len(got) == len(single)
        for layer, ref in zip(got, single):
            assert set(layer) == set(ref)
            for key, want in ref.items():
                have = layer[key]
                axis = _heads_axis(key)
                if axis is not None and want.shape[axis] % 2 == 0:
                    want = _block(want, axis, m, 2)
                assert have.dtype == want.dtype, (name, key)
                np.testing.assert_array_equal(have, want, err_msg=key)


def test_mesh_counters_equal_single_device(run):
    """Every counter, the speculative ones and the growth bailouts among
    them, is equal on every rank and equal to single-device serving."""
    for name in MESHED:
        want = run.single[name]["counters"]
        for rank in run.ranks:
            assert rank["scenarios"][name]["counters"] == want, name
    spec = run.single["speculative-pattern"]["counters"]
    assert spec["spec_ticks"] > 0 and spec["spec_proposed"] > 0
    assert run.single["shared-prefix"]["counters"]["prefix_hit_tokens"] > 0


def test_pools_split_over_model_and_mqa_stays_whole(run):
    """Local Hkv is Hkv / 2 on the plane pool; MQA's single KV head is not
    split (its pools stay whole on every rank)."""
    n_kv = W.model_config("base").n_kv_heads
    for rank in run.ranks:
        base = rank["scenarios"]["greedy-fused"]["leaves"][0]
        assert base["kq"].shape[-2] == n_kv // 2
        assert base["k"].shape[2] == n_kv // 2
        mqa = rank["scenarios"]["mqa"]["leaves"][0]
        assert mqa["k"].shape[2] == 1 and mqa["k_amax"].shape == (1,)


def test_breaker_fault_on_one_rank_degrades_every_rank(run):
    """A kernel fault injected into rank 1's fused decode degrades every
    rank at the same tick, with the greedy tokens."""
    want = run.reference["greedy-fused"]
    for rank in run.ranks:
        res = rank["scenarios"]["breaker"]
        assert res["tokens"] == want
        assert res["counters"]["degradations"] == 1
        assert res["fused"] is False


def test_one_by_one_mesh_gives_single_device_tokens(run):
    res = run.one["scenarios"]["greedy-fused"]
    assert run.one["coord"] == (0, 0)
    assert res["tokens"] == run.single["greedy-fused"]["tokens"]
    assert res["counters"] == run.single["greedy-fused"]["counters"]


def test_serve_cli_mesh_on_cpu(run, capsys):
    """``launch/serve.py --mesh 1,2`` (two spawned ranks splitting the KV
    heads; after the 2x2 spawn has ended, so the two do not compete)
    serves the single-device launch's tokens."""
    want = [r.generated for r in tserve.main(CLI)]
    got = [r.generated for r in tserve.main(CLI + ["--mesh", "1,2"])]
    assert got == want
    assert all(want)
    with pytest.raises(SystemExit):
        tserve.main(CLI + ["--mesh", "2"])
    assert "--mesh expects 'dp,tp'" in capsys.readouterr().err


def test_engine_api_refuses_under_a_mesh(run):
    """The engine API's ``extract``/``insert`` no longer refuse a mesh
    (its refusal went with ROADMAP A10 "Mesh state"): a single-device
    engine's prefill inserted into a mesh decode engine, and a mesh
    engine's prefill extracted into a single-device decode engine, both
    give single-device disaggregated serving's tokens on every rank."""
    assert all(run.api_single)
    for rank in run.ranks:
        assert rank["api"]["in"] == run.api_single
        assert rank["api"]["out"] == run.api_single


def test_rebuild_mesh_over_surviving_ranks(run):
    """``ElasticMeshManager.rebuild_mesh`` makes a 1x2 mesh of ranks 0 and
    1 on a world of 4; its "model" group reduces over its members, and a
    tensor split over its "model" dim gathers back whole."""
    for r, rank in enumerate(run.ranks):
        sub = rank["survivors"]
        assert sub["shape"] == (1, 2)
        if r < 2:
            assert sub["coord"] == (0, r) and sub["sum"] == 1 + 2
            assert sub["gathered"] is True
        else:
            assert sub["coord"] is None and sub["sum"] is None


def test_c10_reference_raises_where_the_port_serves(run):
    """ROADMAP C10: under its 2x2 debug mesh the reference raises
    ValueError at the first prefill for reduced stablelm-1.6b with
    ``scan_layers=False`` and for reduced qwen2-moe-a2.7b; the port serves
    both on its 2x2 mesh with the reference's single-device tokens (MoE
    through its expert-parallel branch, ``models/moe.py``)."""
    rc, out, err = run.c10
    assert rc == 0, err
    lines = dict(line.split(" ", 1) for line in out.strip().splitlines())
    for arch in ("stablelm-1.6b", "qwen2-moe-a2.7b"):
        assert lines[arch].startswith("ValueError"), lines[arch]
        assert "with_sharding_constraint" in lines[arch]
    want = run.reference["unscanned"]
    assert all(run.c10_moe)
    for rank in run.ranks:
        assert rank["scenarios"]["unscanned"]["tokens"] == want
        assert rank["c10_moe"] == run.c10_moe


# ---------------------------------------------------------------------------
# In-process: rules and refusals (a stand-in mesh carries the dim names and
# shape, all that the rules and ServeConfig read)
# ---------------------------------------------------------------------------


def _mesh(data=2, model=2):
    return types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(data * model).reshape(data, model))


@pytest.mark.parametrize("kind", ["f32 planes", "bf16", "planeless"])
def test_paged_cache_rules_cover_every_leaf(kind):
    """Every leaf of a paged cache is matched by a ``PAGED_CACHE_RULES``
    entry: pool leaves split over "model", per-slot leaves whole (their
    slots split over "data" only at the attention call)."""
    cfg = W.model_config("base").replace(fused_decode=True)
    page, dtype = 8, torch.float32
    if kind == "bf16":
        dtype = torch.bfloat16
    if kind == "planeless":
        page = 12
    layout = A.PagedLayout(pool_blocks=12, page_size=page,
                           max_blocks_per_req=4)
    caches = TT.init_caches(cfg, 2, dtype=dtype, paged=layout)
    specs = cache_pspecs(make_serve_rules(_mesh()), caches)
    want = {"k": "model", "v": "model", "kq": "model", "k_amax": "model",
            "v_amax": "model", "table": None, "length": None, "pos": None}
    seen = set()
    for unit_c, unit_s in zip(caches["seg0"], specs["seg0"]):
        for leaf, spec in unit_s["b0"].items():
            assert leaf in PAGED_CACHE_RULES, leaf
            assert len(spec) == unit_c["b0"][leaf].ndim
            assert ((want[leaf] in spec) if want[leaf]
                    else all(s is None for s in spec)), (leaf, spec)
            seen.add(leaf)
    base = {"k", "v", "pos", "table", "length"}
    assert seen == (base if kind == "planeless"
                    else base | {"kq", "k_amax", "v_amax"})


def test_pspec_divisibility_fallback():
    rules = make_serve_rules(_mesh(2, 4))
    assert rules.pspec(("batch", "kv_heads"), (4, 8)) == ("data", "model")
    assert rules.pspec(("batch", "kv_heads"), (3, 1)) == (None, None)
    assert rules.pspec(("batch", "ffn", "vocab"), (4, 8, 8)) == (
        "data", None, None)
    assert rules.pspec(("heads",)) == ("model",)
    assert rules._mesh_size(("data", "model")) == 8


def test_serve_config_refuses_other_mesh_dims():
    bad = types.SimpleNamespace(mesh_dim_names=("dp", "tp"))
    with pytest.raises(ValueError, match="'data'/'model'"):
        ServeConfig(mesh=bad)
    ServeConfig(mesh=types.SimpleNamespace(mesh_dim_names=("model",)))
    # The memory hierarchy and snapshots run under a mesh
    # (tests/test_torch_mesh_state.py); their refusal is gone.
    for kw in (dict(oversubscribe=True, swap_host_bytes=1 << 20),
               dict(prefix_host_bytes=1 << 20), dict(prefix_store_dir="x"),
               dict(snapshot_every=2)):
        assert ServeConfig(mesh=_mesh(), **kw).mesh is not None


def test_contiguous_and_static_engines_refuse_a_mesh():
    cfg = W.model_config("base")
    scfg = ServeConfig(mesh=_mesh(), **W.SERVE_KW)
    for engine in (ContinuousBatchingEngine, StaticBucketEngine):
        with pytest.raises(ValueError, match="PagedEngine feature"):
            engine(cfg, None, scfg, device="cpu")


def test_moe_ffn_refuses_a_model_dim(run):
    """A "model" dim > 1 is no longer refused (ROADMAP A10 "Mesh MoE"):
    on every rank of the 2x2 mesh the EP and resident branches give the
    single-device ``out`` bit for bit, expert-TP within 1e-5 (its partial
    products summed in rank order); a mesh of "data" alone runs the
    single-device path."""
    for rank in run.ranks:
        for name, want in run.moe_single.items():
            got = rank["moe_branches"][name]
            if name == "tp":
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            else:
                assert torch.equal(got, want), name
    cfg = reduced_config("qwen2-moe-a2.7b")
    params = TT.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    p = params["seg0"][0]["b0"]["moe"]
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    whole, aux = TM.moe_ffn(p, x, cfg.moe_config())
    dp, aux_dp = TM.moe_ffn(p, x, cfg.moe_config(), mesh=_mesh(2, 1))
    assert torch.equal(whole, dp) and torch.equal(aux, aux_dp)
