"""What a rank of ``tests/test_torch_mesh.py``'s 2x2 mesh runs, and the
single-device runs it is held to.  Imports torch and the port only: the
ranks are spawned processes, and the JAX reference stays in the pytest
process."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig
from repro_torch.models.attention import host_array
from repro_torch.runtime.fault_tolerance import ElasticMeshManager
from repro_torch.serving import (FaultInjector, FaultPlan, PagedEngine,
                                 Request, ServeConfig)
from repro_torch.sharding.api import gather_shards, local_shard, mesh_group
from repro_torch.sharding.rules import make_serve_rules

# The reference's tests/test_serving_sharded.py prelude: reduced
# stablelm-1.6b on bitstopper_xla at alpha 0.85, 2 slots, pages of 8,
# prompts of 5, 9 and 7 tokens from default_rng(3), 6 new tokens, seed 0.
SERVE_KW = dict(max_len=64, max_slots=2, prefill_bucket=4, page_size=8)
PROMPT_LENS = (5, 9, 7)
NEW_TOKENS = 6
SCENARIOS = {
    "greedy-fallback": dict(fused=False),
    "greedy-fused": dict(fused=True),
    "seeded": dict(fused=False, temperature=0.8),
    "shared-prefix": dict(fused=False, shared_prefix=12),
    "speculative": dict(fused=False, speculative="ngram"),
    # Repeated-pattern prompts, so that the n-gram drafter proposes and
    # verify forwards run (the prelude's random prompts give no draft).
    "speculative-pattern": dict(fused=True, speculative="ngram",
                                pattern=True),
    # Context-sized reservations on 10 blocks; at these lengths nothing is
    # preempted, as in the reference's run of the same trace.
    "oversubscribed": dict(fused=False, oversub=True),
    "mqa": dict(fused=False, model="mqa"),
    "unscanned": dict(fused=False, model="unscanned"),
    # A kernel fault injected into rank 1's fused decode at tick 4.
    "breaker": dict(fused=True, fault_rank=1, fault_tick=4),
}
LEAVES = ("k", "v", "kq", "k_amax", "v_amax", "pos", "table", "length")


def model_kw(key: str) -> dict:
    """The config changes of model ``key`` (also applied to the
    reference's config)."""
    return {"base": {}, "mqa": {"n_kv_heads": 1},
            "unscanned": {"scan_layers": False}}[key]


def model_config(key: str):
    return reduced_config("stablelm-1.6b").replace(
        attn_impl="bitstopper_xla", bitstopper=BitStopperConfig(alpha=0.85),
        **model_kw(key))


def prompts(vocab: int, scen: dict) -> list[np.ndarray]:
    rng = np.random.default_rng(3)
    if scen.get("pattern"):
        return [np.resize(rng.integers(0, vocab, 3, dtype=np.int32), n + 8)
                for n in PROMPT_LENS]
    prefix = rng.integers(0, vocab, scen.get("shared_prefix", 0),
                          dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n,
                                                 dtype=np.int32)])
            for n in PROMPT_LENS]


def stream_key(scen: dict) -> tuple:
    """What fixes a scenario's tokens: the model, the temperature and the
    prompts.  Speculation, oversubscription and the kernel are lossless
    (the reference's own tests hold each to its plain run)."""
    return (scen.get("model", "base"), scen.get("temperature", 0.0),
            scen.get("shared_prefix", 0), bool(scen.get("pattern")))


def serve_kw(scen: dict) -> dict:
    kw = dict(SERVE_KW, fused_decode=scen["fused"],
              temperature=scen.get("temperature", 0.0),
              speculative=scen.get("speculative", "off"))
    if scen.get("oversub"):
        kw.update(pool_blocks=10, oversubscribe=True)
    return kw


def serve(scen: dict, params, mesh=None, device="cpu", chaos=None) -> dict:
    """Serve a scenario; its tokens, counters and every layer's cache
    leaves (host arrays, in layer order)."""
    cfg = model_config(scen.get("model", "base"))
    eng = PagedEngine(cfg, params, ServeConfig(mesh=mesh, **serve_kw(scen)),
                      device=device)
    eng.chaos = chaos
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts(cfg.vocab, scen)]
    eng.generate(reqs, seed=0)
    layers = [unit[b] for seg in sorted(eng.caches)
              for unit in eng.caches[seg] for b in sorted(unit)]
    return {"tokens": [list(r.generated) for r in reqs],
            "counters": dict(eng.counters),
            "fused": eng.cfg.fused_decode,
            "leaves": [{k: host_array(c[k]) for k in LEAVES if k in c}
                       for c in layers]}


def _refusals(mesh, device, params) -> dict:
    """The engine API's refusals under a mesh: name -> (type, message)."""
    eng = PagedEngine(model_config("base"), params,
                      ServeConfig(mesh=mesh, **SERVE_KW), device=device)
    out = {}
    for name, call in (("snapshot", eng.snapshot),
                       ("restore", lambda: eng.restore({})),
                       ("extract", lambda: eng.extract(None)),
                       ("insert", lambda: eng.insert(None, 0))):
        try:
            call()
            out[name] = (None, "")
        except Exception as e:                    # noqa: BLE001
            out[name] = (type(e).__name__, str(e))
    return out


def _survivor_mesh() -> dict:
    """``ElasticMeshManager.rebuild_mesh`` over the surviving ranks: a 1x2
    mesh of ranks 0 and 1; an all-reduce over its "model" group and a
    gather over its own process group (which every rank makes together)
    by its members."""
    mgr = ElasticMeshManager(model_parallel=2, devices_per_node=1)
    sub = mgr.rebuild_mesh(mgr.decide(healthy_nodes=2))
    mesh_group(sub)
    coord = sub.get_coordinate()
    total = gathered = None
    if coord is not None:
        t = torch.tensor([dist.get_rank() + 1])
        dist.all_reduce(t, group=sub.get_group("model"))
        total = int(t)
        rules = make_serve_rules(sub)
        x = torch.arange(8.0).reshape(2, 4)
        spec = rules.pspec((None, "heads"), x.shape)
        gathered = torch.equal(
            gather_shards(rules, local_shard(rules, x, spec), spec), x)
    return {"coord": None if coord is None else tuple(coord),
            "shape": tuple(sub.mesh.shape), "sum": total,
            "gathered": gathered}


def _one_by_one(device, params) -> dict | None:
    """The greedy fused scenario on a 1x1 mesh of rank 0 alone (a sub-mesh
    of the world, whose process groups every rank makes together); None
    on the other ranks."""
    one = DeviceMesh("cpu", torch.tensor([[0]]),
                     mesh_dim_names=("data", "model"))
    mesh_group(one)
    if one.get_coordinate() is None:
        return None
    return {"coord": tuple(one.get_coordinate()),
            "scenarios": {"greedy-fused": serve(SCENARIOS["greedy-fused"],
                                                params, one, device)}}


def run_rank(mesh, device, params_by_model) -> dict:
    """Rank body: every scenario on the mesh, the engine API's refusals,
    a mesh rebuilt over surviving ranks and a 1x1 mesh."""
    rank = dist.get_rank()
    out = {"coord": tuple(mesh.get_coordinate()), "scenarios": {}}
    for name, scen in SCENARIOS.items():
        chaos = None
        if scen.get("fault_rank") == rank:
            chaos = FaultInjector(FaultPlan.scripted(
                [("kernel_fail", scen["fault_tick"])]))
        out["scenarios"][name] = serve(
            scen, params_by_model[scen.get("model", "base")], mesh, device,
            chaos)
    out["refusals"] = _refusals(mesh, device, params_by_model["base"])
    out["survivors"] = _survivor_mesh()
    out["one"] = _one_by_one(device, params_by_model["base"])
    return out
