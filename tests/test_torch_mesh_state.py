"""State under a (data, model) mesh of the PyTorch port on the CPU: swap,
the prefix store and its host tier, crash snapshots and restore, and the
engine API's extract/insert, on ``PagedEngine`` over a 2x2 gloo mesh,
held to single-device serving, the port's and the reference's.

Records that outlive an engine or cross engines are whole: prefix records
(disk and host tier), snapshots and ``extract`` payloads hold the bytes a
single-device engine writes, so the store a mesh flushed warms a single
device and the reverse, a 2x2 snapshot restores on one device and on a 1x2
mesh of the surviving ranks, and a single device's prefill inserts into a
mesh decode engine and the reverse.  Swap records stay private to a rank.
After every splice and restore a rank's pool leaves equal one device's at
its KV heads, bit for bit.

One module-scoped spawn (``tests/_torch_mesh_worker.py:state_rank``) runs
every scenario for reduced stablelm-1.6b, scanned and unscanned.  Before
it the pytest process writes the single-device prefix store the mesh warms
from; while it runs, the pytest process serves the same scenarios on one
device and a subprocess serves each trace plain on the reference's
single-device engine, which its own tests pin to its swap, store, chaos and disaggregated runs
(and its mesh only re-places leaves after a host splice,
``repro/serving/engine.py:1645-1648``).
"""

import filecmp
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
from repro_torch.models import transformer as TT

import _torch_mesh_worker as W
from _torch_threads import one_thread  # noqa: F401

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_TESTS), "src")
JOIN_S = 120.0
MODELS = W.STATE_MODELS
# The plain single-device ServeConfig of each trace (the reference's run).
PLAIN = {
    "swap": dict(max_len=64, max_slots=3, prefill_bucket=8, page_size=8),
    "store": W.STORE_KW,
    "tier": {k: v for k, v in W.TIER_KW.items()
             if k not in ("pool_blocks", "prefix_host_bytes")},
    "chaos": dict(W.CHAOS_KW, fused_decode=False),
}
# Each mesh scenario and the trace whose plain tokens it must serve.
TOKENS = {"swap": "swap", "store_cold": "store", "store_warm": "store",
          "store_to_single": "store", "tier": "tier", "chaos": "chaos",
          "restore_1x2": "chaos", "restore_single": "chaos",
          "disagg_in": "chaos", "disagg_out": "chaos"}


# The reference's single-device runs, in a subprocess beside the spawn:
# the parameters pickled in as host arrays, the tokens out as JSON.
_REF = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
import test_torch_mesh_state as S
S.reference_main(sys.argv[1], sys.argv[2])
"""


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.numpy()


def _reference_params(host, key):
    """The port's parameters (as host arrays) in the reference's layout: a
    scanned segment stacked over its layers."""
    tree = {k: v for k, v in host.items() if k != "seg0"}
    units = host["seg0"]
    tree["seg0"] = (jax.tree.map(lambda *xs: np.stack(xs), *units)
                    if W.model_config(key).scan_layers else units)
    return jax.tree.map(jax.numpy.asarray, tree)


def reference_main(src: str, dst: str) -> None:
    """Serve every trace plain on the reference's single device, for each
    model of the pickled parameters in ``src``; the tokens to ``dst``."""
    with open(src, "rb") as f:
        hosts = pickle.load(f)
    out = {}
    for key, host in hosts.items():
        jparams = _reference_params(host, key)
        out[key] = {trace: _reference_tokens(key, jparams, trace)
                    for trace in PLAIN}
    with open(dst, "w") as f:
        json.dump(out, f)


def _reference_tokens(key, jparams, trace):
    cfg = jreduced("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=JConfig(alpha=0.85),
        **W.model_kw(key))
    eng = JEngine(cfg, jparams, JServe(**PLAIN[trace]))
    reqs = [JRequest(prompt=p, max_new_tokens=W.STATE_NEW[trace])
            for p in W.state_prompts(trace)]
    eng.generate(reqs, seed=0)
    return [list(map(int, r.generated)) for r in reqs]


def _single(key, params, d) -> dict:
    """Every scenario on one device (the store it warms the mesh from is
    written before the spawn)."""
    out = {}
    eng, toks = W.state_serve(key, params, "swap", fused_decode=True,
                              **W.SWAP_KW)
    out["swap"] = {"tokens": toks, "counters": dict(eng.counters),
                   "leaves": W.leaves_of(eng),
                   "memory": eng.memory_report()}
    eng, toks = W.state_serve(key, params, "store", fused_decode=True,
                              prefix_store_dir=d["single_store"],
                              **W.STORE_KW)
    out["store_warm"] = {"tokens": toks, "counters": dict(eng.counters),
                         "leaves": W.leaves_of(eng)}
    eng, toks = W.state_serve(key, params, "tier", fused_decode=False,
                              prefix_store_dir=d["single_tier"],
                              **W.TIER_KW)
    out["tier"] = {"tokens": toks, "counters": dict(eng.counters),
                   "flushed": eng.flush_prefixes(),
                   "memory": eng.memory_report(),
                   "leaves": W.leaves_of(eng)}
    toks, rep, leaves = W.chaos_serve(key, params, d["single_snaps"])
    out["chaos"] = {"tokens": toks, "report": rep, "leaves": leaves}
    out["snapshot"] = W.snapshot_at(key, params)
    out["disagg"] = W.disagg_serve(key, params, None, None)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("state")
    dirs = {key: {n: str(root / key / n) for n in (
        "single_store", "store", "tier", "snaps", "single_tier",
        "single_snaps")} for key in MODELS}
    params = {key: TT.init_model(W.model_config(key),
                                 torch.Generator().manual_seed(0), "cpu")
              for key in MODELS}
    single = {}
    for key in MODELS:
        eng, toks = W.state_serve(key, params[key], "store",
                                  fused_decode=True,
                                  prefix_store_dir=dirs[key]["single_store"],
                                  **W.STORE_KW)
        single[key] = {"store_cold": {"tokens": toks,
                                      "flushed": eng.flush_prefixes(),
                                      "leaves": W.leaves_of(eng)}}
    with open(root / "params.pkl", "wb") as f:
        pickle.dump({key: _host(p) for key, p in params.items()}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF.format(tests=_TESTS, src=_SRC),
         str(root / "params.pkl"), str(root / "ref.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    t0 = time.monotonic()
    job = start_mesh(W.state_rank, 2, 2, device="cpu", backend="gloo",
                     args=(params, dirs), timeout=JOIN_S)
    try:
        for key in MODELS:
            single[key].update(_single(key, params[key], dirs[key]))
        ranks = job.join()
    finally:
        try:
            _, err = ref.communicate(
                timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            ref.kill()
            raise
    assert ref.returncode == 0, err
    with open(root / "ref.json") as f:
        reference = json.load(f)
    for key in MODELS:
        s, snap = single[key], ranks[0][key]["snapshot"]
        # The mesh's flushed store warms one device; its 2x2 snapshot
        # restores one device.
        eng, toks = W.state_serve(key, params[key], "store",
                                  fused_decode=True,
                                  prefix_store_dir=dirs[key]["store"],
                                  **W.STORE_KW)
        s["store_to_single"] = {"tokens": toks,
                                "counters": dict(eng.counters),
                                "leaves": W.leaves_of(eng)}
        toks, leaves = W.restore_serve(key, params[key], snap)
        s["restore_single"] = {"tokens": toks, "leaves": leaves}
    return types.SimpleNamespace(single=single, reference=reference,
                                 ranks=ranks, dirs=dirs)


def _mesh_result(run, key, rank, name):
    if name == "restore_1x2":
        toks, leaves = rank["sub"][key]
        return {"tokens": toks, "leaves": leaves}
    return rank[key][name]


@pytest.mark.parametrize("key", MODELS)
@pytest.mark.parametrize("name", list(TOKENS))
def test_mesh_state_tokens_equal_single_device(run, key, name):
    """Every rank (the 1x2 mesh's two for its restore), and each
    single-device run fed by a mesh record, serves the reference's
    single-device tokens of the trace, and the port's."""
    want = run.reference[key][TOKENS[name]]
    assert all(want)
    if name in ("store_to_single", "restore_single"):
        assert run.single[key][name]["tokens"] == want
        return
    ranks = run.ranks[:2] if name == "restore_1x2" else run.ranks
    for rank in ranks:
        assert _mesh_result(run, key, rank, name)["tokens"] == want, (
            rank["coord"])
    single = {"store_warm": "store_warm", "store_cold": "store_cold",
              "swap": "swap", "tier": "tier", "chaos": "chaos",
              "disagg_in": "disagg", "disagg_out": "disagg",
              "restore_1x2": "restore_single"}[name]
    assert run.single[key][single]["tokens"] == want


# Each mesh scenario's single-device counterpart for its final pools.
LEAVES = {"swap": "swap", "store_cold": "store_cold",
          "store_warm": "store_warm", "tier": "tier", "chaos": "chaos",
          "disagg_in": "disagg", "restore_1x2": "restore_single"}


@pytest.mark.parametrize("key", MODELS)
@pytest.mark.parametrize("name", list(LEAVES))
def test_mesh_state_leaves_equal_single_device(run, key, name):
    """After swap-ins, warm starts from whole records, a crash and restore,
    a splice of an inserted payload and a restore on a 1x2 mesh, every
    rank's pool leaves (``k_amax`` and ``v_amax`` among them) equal the
    single-device counterpart's at its KV heads, bit for bit."""
    single = run.single[key][LEAVES[name]]["leaves"]
    ranks = run.ranks[:2] if name == "restore_1x2" else run.ranks
    for rank in ranks:
        m = rank["coord"][1]
        got = _mesh_result(run, key, rank, name)["leaves"]
        for layer, ref in zip(got, single, strict=True):
            assert set(layer) == set(ref)
            for leaf, want in ref.items():
                axis = W.heads_axis(leaf)
                if axis is not None:
                    step = want.shape[axis] // 2
                    want = np.take(want, range(m * step, (m + 1) * step),
                                   axis)
                np.testing.assert_array_equal(layer[leaf], want,
                                              err_msg=f"{name} {leaf}")


def _same_tree(a: str, b: str) -> list[str]:
    """Relative paths of every file under ``a`` and ``b``, asserting the
    two trees hold the same files with the same bytes."""
    files = []
    for base, _, names in os.walk(a):
        files += [os.path.relpath(os.path.join(base, n), a) for n in names]
    other = []
    for base, _, names in os.walk(b):
        other += [os.path.relpath(os.path.join(base, n), b) for n in names]
    assert sorted(files) == sorted(other)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files


@pytest.mark.parametrize("key", MODELS)
@pytest.mark.parametrize("what", ["store", "tier", "snapshots"])
def test_mesh_disk_records_byte_equal_single_device(run, key, what):
    """What the mesh wrote to disk (written once, by its leader) holds the
    files a single device writes on the same trace, byte for byte: the
    flushed prefix store, the host tier's spills and flush, and every
    chaos snapshot (one write of them interrupted in both)."""
    d = run.dirs[key]
    mesh, single = {"store": ("store", "single_store"),
                    "tier": ("tier", "single_tier"),
                    "snapshots": ("snaps", "single_snaps")}[what]
    files = _same_tree(d[mesh], d[single])
    want = {"store": "record.npz", "tier": "record.npz",
            "snapshots": "snapshot.json"}[what]
    assert any(f.endswith(want) for f in files)


@pytest.mark.parametrize("key", MODELS)
def test_mesh_snapshot_and_payloads_equal_single_device(run, key):
    """The snapshot every rank takes (its scales gathered from the ranks'
    heads) is the single-device snapshot at the same tick, and the
    payloads a mesh prefill engine extracts hold the single-device
    payloads' bytes, field by field."""
    want_snap = run.single[key]["snapshot"]
    want = run.single[key]["disagg"]["payloads"]
    assert want
    for rank in run.ranks:
        assert rank[key]["snapshot"] == want_snap
        got = rank[key]["disagg_out"]["payloads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for gl, wl in zip(g["layers"], w["layers"], strict=True):
                assert set(gl) == set(wl)
                for field in wl:
                    assert gl[field].dtype == wl[field].dtype
                    np.testing.assert_array_equal(gl[field], wl[field])
            for ga, wa in zip(g["amax"], w["amax"], strict=True):
                np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("key", MODELS)
def test_mesh_state_counters_equal_single_device(run, key):
    """Every rank's counters and reports equal one device's: the swap tier
    swapped out and in, the tier spilled and warmed, the warm starts hit
    the store, the chaos run crashed, restored and lost one snapshot
    write; ``memory_report`` gives the whole engine's bytes and, per rank,
    half its device bytes."""
    s = run.single[key]
    assert s["swap"]["counters"]["swap_outs"] >= 1
    assert s["swap"]["counters"]["swap_ins"] >= 1
    assert s["tier"]["counters"]["prefix_spills"] >= 1
    assert s["tier"]["counters"]["prefix_store_hits"] >= 1
    assert s["store_warm"]["counters"]["prefix_store_hits"] >= 1
    assert (s["store_to_single"]["counters"]
            == s["store_warm"]["counters"])
    assert s["chaos"]["report"]["restores"] == 1
    assert s["chaos"]["report"]["snapshots_interrupted"] == 1
    for rank in run.ranks:
        r = rank[key]
        for name in ("swap", "tier", "store_warm"):
            assert r[name]["counters"] == s[name]["counters"], name
        assert r["chaos"]["report"] == s["chaos"]["report"]
        for name in ("disagg_in", "disagg_out"):
            assert r[name]["counters"] == s["disagg"]["counters"], name
        assert r["store_cold"]["flushed"] == s["store_cold"]["flushed"]
        assert r["tier"]["flushed"] == s["tier"]["flushed"]
        for name in ("swap", "tier"):
            mem, want = r[name]["memory"], s[name]["memory"]
            assert {k: v for k, v in mem.items()
                    if not k.startswith("rank_")} == want
            assert mem["rank_device_bytes_peak"] * 2 \
                == want["device_bytes_peak"]
        assert r["swap"]["memory"]["rank_host_swap_bytes"] == 0
