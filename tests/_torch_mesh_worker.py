"""What a rank of the 2x2 mesh of ``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_state.py``, ``tests/test_torch_mesh_moe.py`` and
the ``tests/test_torch_mesh_train*.py`` files runs, and the single-device
runs it is held to.  Imports torch and the
port only: the ranks are spawned processes, and the JAX reference stays
in the pytest process or its subprocesses."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import reduced_config
from repro_torch.core.besf import BitStopperConfig
from repro_torch.data import shard_rows
from repro_torch.models.attention import host_array
from repro_torch.models.moe import RoutingLog
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


def c10_moe_config():
    """Reduced qwen2-moe-a2.7b at the prelude's settings (the reference's
    C10 case)."""
    return reduced_config(MOE_ARCH).replace(
        attn_impl="bitstopper_xla", bitstopper=BitStopperConfig(alpha=0.85))


def c10_moe_serve(params, mesh=None, device="cpu") -> list:
    """The prelude's trace served by reduced qwen2-moe: its tokens."""
    eng = PagedEngine(c10_moe_config(), params,
                      ServeConfig(mesh=mesh, fused_decode=False, **SERVE_KW),
                      device=device)
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS)
            for p in prompts(256, {})]
    eng.generate(reqs, seed=0)
    return [list(r.generated) for r in reqs]


def moe_branches(mesh) -> dict:
    """``moe_ffn`` on the mesh for the EP, resident and expert-TP
    function-level cases: name -> out."""
    from repro_torch.models.moe import moe_ffn
    return {name: moe_ffn(p, x, cfg, mesh=mesh)[0]
            for name, (cfg, p, x) in moe_fn_inputs().items()
            if name != "c11"}


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
    """Rank body: every scenario on the mesh, the MoE branches, the engine
    API both ways (disaggregated serving from a single-device prefill
    engine into a mesh decode engine and the reverse), reduced qwen2-moe
    on the prelude's trace, a mesh rebuilt over surviving ranks and a 1x1
    mesh."""
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
    out["moe_branches"] = moe_branches(mesh)
    out["api"] = {"in": disagg_serve("base", params_by_model["base"], None,
                                     mesh, device)["tokens"],
                  "out": disagg_serve("base", params_by_model["base"], mesh,
                                      None, device)["tokens"]}
    out["c10_moe"] = c10_moe_serve(params_by_model["moe"], mesh, device)
    out["survivors"] = _survivor_mesh()
    out["one"] = _one_by_one(device, params_by_model["base"])
    return out


# ---------------------------------------------------------------------------
# State under the mesh (tests/test_torch_mesh_state.py): the memory
# hierarchy, snapshots and restore, and the engine API's extract/insert.
# ---------------------------------------------------------------------------

# tests/test_swap.py's oversubscribed shape and budget, and its store
# geometry (prefill chunks of one 8-token page) at one slot, where a warm
# start leaves the order of writes as the cold run had it (ROADMAP C5).
SWAP_KW = dict(max_len=64, max_slots=3, prefill_bucket=8, page_size=8,
               pool_blocks=10, oversubscribe=True, swap_host_bytes=1 << 22)
STORE_KW = dict(max_len=64, max_slots=1, prefill_bucket=8, page_size=8,
                prefill_chunk=8)
# tests/test_prefix_store.py's host tier: a snug pool under two slots and
# a tier of 16 KiB, so evicted prefix blocks spill to the tier and on to
# disk.
TIER_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8,
               prefill_chunk=8, pool_blocks=8, prefix_host_bytes=1 << 14)
CHAOS_KW = dict(max_len=64, max_slots=2, prefill_bucket=4, page_size=8,
                fused_decode=True)
# A crash after the tick-4 snapshot, whose write an interrupt kills first:
# the restore takes the tick-2 snapshot.
CHAOS_PLAN = (("checkpoint_interrupt", 4), ("crash", 5))
CHAOS_EVERY = 2
RESTORE_AT = 6                      # ticks on the 2x2 mesh before the
                                    # snapshot the 1x2 mesh restores
# Disaggregation serves the chaos trace: a one-slot prefill engine and a
# two-slot decode engine, the chaos engine's geometry.
DISAGG_KW = dict(max_len=64, page_size=8, prefill_bucket=4,
                 fused_decode=True)
STATE_MODELS = ("base", "unscanned")


def state_prompts(kind: str) -> list[np.ndarray]:
    """The prompts of a state scenario (vocab 256)."""
    if kind == "swap":                     # tests/test_swap.py's greedy
        rng = np.random.default_rng(0)
        return [rng.integers(0, 256, n, dtype=np.int32) for n in (12, 9, 11)]
    if kind in ("store", "tier"):          # a system prompt, then tails
        sys_prompt = np.random.default_rng(42).integers(0, 256, 16,
                                                        dtype=np.int32)
        rng = np.random.default_rng(3 if kind == "store" else 8)
        lens = (6, 9, 4) if kind == "store" else (9, 11, 10, 9, 11)
        out = [np.concatenate([sys_prompt, rng.integers(0, 256, n,
                                                        dtype=np.int32)])
               for n in lens]
        # The tier's trace ends with its first prompt again, whose blocks
        # have left the pool by then: it warms from the tier.
        return out if kind == "store" else out + [out[0]]
    rng = np.random.default_rng(0)         # the chaos and disaggregation
    return [rng.integers(0, 256, n, dtype=np.int32)  # trace: tests/
            for n in (5, 11, 7)]                     # test_frontdoor.py's


STATE_NEW = {"swap": 16, "store": 8, "tier": 16, "chaos": 6}


def state_requests(kind: str) -> list:
    return [Request(prompt=p, max_new_tokens=STATE_NEW[kind])
            for p in state_prompts(kind)]


def heads_axis(name: str):
    """The KV-heads axis of a pool leaf (None for a whole leaf)."""
    from repro_torch.sharding.rules import PAGED_CACHE_RULES
    axes = PAGED_CACHE_RULES[name]
    return axes.index("kv_heads") if "kv_heads" in axes else None


def leaves_of(eng) -> list[dict]:
    """Every layer's cache leaves as host arrays, in layer order."""
    layers = [unit[b] for seg in sorted(eng.caches)
              for unit in eng.caches[seg] for b in sorted(unit)]
    return [{k: host_array(c[k]) for k in LEAVES if k in c} for c in layers]


def state_engine(key, params, mesh, device="cpu", **kw):
    return PagedEngine(model_config(key), params,
                       ServeConfig(mesh=mesh, **kw), device=device)


def state_serve(key, params, kind, mesh=None, device="cpu", seed=0, **kw):
    """Serve a scenario's requests; (engine, tokens)."""
    eng = state_engine(key, params, mesh, device, **kw)
    reqs = state_requests(kind)
    eng.generate(reqs, seed=seed)
    return eng, [list(r.generated) for r in reqs]


def chaos_serve(key, params, snap_dir, mesh=None, device="cpu"):
    """The chaos scenario: the disagg prompts through ``serve_with_chaos``
    under ``CHAOS_PLAN`` with a snapshot every ``CHAOS_EVERY`` ticks.
    Returns (tokens, report, the last engine's leaves)."""
    from repro_torch.serving import serve_with_chaos
    made = []

    def make():
        made.append(state_engine(key, params, mesh, device, **CHAOS_KW))
        return made[-1]

    reqs, rep = serve_with_chaos(make, state_requests("chaos"), seed=0,
                                 plan=FaultPlan.scripted(list(CHAOS_PLAN)),
                                 snapshot_dir=snap_dir,
                                 snapshot_every=CHAOS_EVERY)
    return [list(r.generated) for r in reqs], rep, leaves_of(made[-1])


def snapshot_at(key, params, mesh=None, device="cpu"):
    """The chaos prompts served for ``RESTORE_AT`` ticks on an undisturbed
    engine: its snapshot there."""
    eng = state_engine(key, params, mesh, device, **CHAOS_KW)
    for r in state_requests("chaos"):
        eng.submit(r)
    eng.begin(0)
    while eng.ticks < RESTORE_AT:
        eng.step()
    return eng.snapshot()


def restore_serve(key, params, snap, mesh=None, device="cpu"):
    """A fresh engine restored from ``snap`` and run to the end: its tokens
    by rid and its leaves."""
    eng = state_engine(key, params, mesh, device, **CHAOS_KW)
    eng.restore(snap)
    eng.run(0)
    return ([list(eng.requests[rid].generated) for rid in sorted(
        eng.requests)], leaves_of(eng))


def disagg_serve(key, params, prefill_mesh, decode_mesh, device="cpu"):
    """Disaggregated serving: a one-slot prefill engine hands detached
    prefixes to a two-slot decode engine.  Returns the tokens, the
    payloads the prefill engine extracted, the decode engine's leaves and
    both engines' counters."""
    from repro_torch.serving.frontdoor import DisaggController
    pre = state_engine(key, params, prefill_mesh, device, max_slots=1,
                       **DISAGG_KW)
    dec = state_engine(key, params, decode_mesh, device, max_slots=2,
                       **DISAGG_KW)
    payloads = []
    real = pre.extract

    def extract(prefix):
        out = real(prefix)
        payloads.append(out.payload)
        return out

    pre.extract = extract
    ctl = DisaggController(pre, dec)
    reqs = state_requests("chaos")
    ctl.generate(reqs, seed=0)
    return {"tokens": [list(r.generated) for r in reqs],
            "payloads": payloads, "leaves": leaves_of(dec),
            "counters": ctl.counters}


def state_rank(mesh, device, params_by_model, dirs) -> dict:
    """Rank body of the state spawn: every scenario on the 2x2 mesh for
    each model, then the restore of a 2x2 snapshot on a 1x2 mesh of the
    first two ranks.  ``dirs[key]`` holds the directories: "single_store"
    (written by a single-device engine before the spawn), and the mesh's
    own "store", "tier" and "snaps"."""
    out = {"coord": tuple(mesh.get_coordinate())}
    for key in STATE_MODELS:
        params, d = params_by_model[key], dirs[key]
        res = {}
        eng, toks = state_serve(key, params, "swap", mesh, device,
                                fused_decode=True, **SWAP_KW)
        res["swap"] = {"tokens": toks, "counters": dict(eng.counters),
                       "leaves": leaves_of(eng),
                       "memory": eng.memory_report()}
        # The store: cold on the mesh, flushed (the record set a single
        # device warms from after the spawn); warm from a single device's.
        eng, toks = state_serve(key, params, "store", mesh, device,
                                fused_decode=True, prefix_store_dir=d["store"],
                                **STORE_KW)
        flushed = eng.flush_prefixes()
        res["store_cold"] = {"tokens": toks, "flushed": flushed,
                             "leaves": leaves_of(eng)}
        eng, toks = state_serve(key, params, "store", mesh, device,
                                fused_decode=True,
                                prefix_store_dir=d["single_store"],
                                **STORE_KW)
        res["store_warm"] = {"tokens": toks, "counters": dict(eng.counters),
                             "leaves": leaves_of(eng)}
        eng, toks = state_serve(key, params, "tier", mesh, device,
                                fused_decode=False, prefix_store_dir=d["tier"],
                                **TIER_KW)
        res["tier"] = {"tokens": toks, "counters": dict(eng.counters),
                       "flushed": eng.flush_prefixes(),
                       "memory": eng.memory_report(),
                       "leaves": leaves_of(eng)}
        toks, rep, leaves = chaos_serve(key, params, d["snaps"], mesh, device)
        res["chaos"] = {"tokens": toks, "report": rep, "leaves": leaves}
        res["snapshot"] = snapshot_at(key, params, mesh, device)
        res["disagg_in"] = disagg_serve(key, params, None, mesh, device)
        res["disagg_out"] = disagg_serve(key, params, mesh, None, device)
        out[key] = res
    # The 2x2 snapshot restored on a 1x2 mesh of the surviving ranks 0-1.
    mgr = ElasticMeshManager(model_parallel=2, devices_per_node=1)
    sub = mgr.rebuild_mesh(mgr.decide(healthy_nodes=2))
    mesh_group(sub)
    out["sub"] = None
    if sub.get_coordinate() is not None:
        out["sub"] = {key: restore_serve(key, params_by_model[key],
                                         out[key]["snapshot"], sub, device)
                      for key in STATE_MODELS}
    return out


# ---------------------------------------------------------------------------
# MoE under the mesh (tests/test_torch_mesh_moe.py): the three branches at
# function level, and reduced qwen2-moe served through PagedEngine.
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# Serving variants: the branch a 2x2 mesh runs for each.  Reduced
# qwen2-moe has 8 routed experts: "model" divides them (EP), and so does
# data x model (resident, when asked for); 7 experts run expert-TP.
MOE_VARIANTS = {"ep": {}, "resident": {"moe_resident": True},
                "tp": {"n_routed": 7}}
# The reference's tests/test_serving.py paged geometry; capacity factor 1,
# where capacity binds (pairs drop) at these batches.
MOE_KW = dict(max_len=64, max_slots=2, prefill_bucket=8, page_size=8)
MOE_NEW = 8
MOE_FACTOR = 1.0
MOE_MODES = ("greedy", "sampled", "spec")
# Function-level cases: tests/test_sharding_multidev.py's shapes (d_model
# 32, top 2 of experts of 16 hidden units, x [2, 16, 32]) at capacity
# factor 8, where nothing drops; "c11" routes 2 x 64 tokens at factor 1.
FN_CASES = {"ep": dict(n_routed=8),
            "resident": dict(n_routed=8, resident=True),
            "tp": dict(n_routed=7),
            "c11": dict(n_routed=8, capacity_factor=1.0)}


def moe_model_config(variant: str):
    return reduced_config(MOE_ARCH).replace(
        attn_impl="bitstopper_xla", bitstopper=BitStopperConfig(alpha=0.8),
        moe_capacity_factor=MOE_FACTOR, **MOE_VARIANTS[variant])


def moe_prompts() -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n, dtype=np.int32) for n in (5, 11, 14, 9)]


class Replay:
    """Drafts the tokens a recorded plain run generated after the same
    context (either package's engine calls ``propose``)."""

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


class DropSpy(RoutingLog):
    """The package's :class:`RoutingLog` read on the host: every MoE
    call's dropped (token, expert) pairs among the experts its plan covers
    (this rank's: another rank's pairs are not its to drop; tokens
    numbered as the plan routes them, the whole batch's in mesh training)
    and its aux loss (a data rank's share in mesh training); ``dropped``
    counts the pairs over every call."""

    @property
    def drops(self) -> list:
        return self.pairs()

    @property
    def aux(self) -> list[float]:
        return [float(a) for _, a in self.routes]

    @property
    def dropped(self) -> int:
        return sum(self.counts())


def moe_serve(variant, params, mode, mesh=None, device="cpu",
              greedy_tokens=None) -> dict:
    """Serve the MoE prompts in ``mode``; tokens, counters, the dropped
    pairs of this rank's experts, the pool leaves and the expert bytes
    the engine holds."""
    cfg = moe_model_config(variant)
    kw = dict(MOE_KW, fused_decode=True)
    drafter = None
    if mode == "sampled":
        kw["temperature"] = 0.8
    if mode == "spec":
        kw.update(speculative="draft", draft_k=4)
        drafter = Replay(moe_prompts(), greedy_tokens)
    eng = PagedEngine(cfg, params, ServeConfig(mesh=mesh, **kw),
                      device=device, drafter=drafter)
    reqs = [Request(prompt=p, max_new_tokens=MOE_NEW) for p in moe_prompts()]
    with DropSpy() as spy:
        eng.generate(reqs, seed=3 if mode == "sampled" else 0)
    experts = sum(t.numel() * t.element_size() for unit in eng.params["seg0"]
                  for t in (unit["b0"]["moe"][k]
                            for k in ("wi_gate", "wi_up", "wo")))
    return {"tokens": [list(r.generated) for r in reqs],
            "counters": dict(eng.counters), "dropped": spy.dropped,
            "leaves": leaves_of(eng), "expert_bytes": experts}


def moe_fn_inputs():
    """The function-level cases: (MoEConfig, parameters, x) by name, drawn
    from seeds by the port's init."""
    from repro_torch.models.moe import MoEConfig, init_moe
    out = {}
    for i, (name, kw) in enumerate(FN_CASES.items()):
        cfg = MoEConfig(**(dict(d_model=32, top_k=2, d_expert=16,
                                capacity_factor=8.0) | kw))
        g = torch.Generator().manual_seed(10 + i)
        p = init_moe(g, cfg)
        S = 64 if name == "c11" else 16
        out[name] = (cfg, p, torch.randn(2, S, 32, generator=g))
    return out


def moe_rank(mesh, device, params_by_variant) -> dict:
    """Rank body of the MoE spawn: each function-level case through
    ``moe_ffn`` on the mesh (whole call and a verify's split call), then
    every serving variant in every mode."""
    from repro_torch.models.moe import moe_ffn
    out = {"coord": tuple(mesh.get_coordinate()), "fn": {}, "serve": {}}
    for name, (cfg, p, x) in moe_fn_inputs().items():
        with DropSpy() as spy:
            y, aux = moe_ffn(p, x, cfg, mesh=mesh)
        ys, _ = moe_ffn(p, x, cfg, mesh=mesh, split=True)
        out["fn"][name] = {"out": y, "aux": aux, "split": ys,
                           "dropped": spy.dropped}
    for variant, params in params_by_variant.items():
        res = {}
        for mode in MOE_MODES:
            res[mode] = moe_serve(
                variant, params, mode, mesh, device,
                res["greedy"]["tokens"] if mode == "spec" else None)
        out["serve"][variant] = res
    return out


# ---------------------------------------------------------------------------
# Training on the mesh (tests/test_torch_mesh_train.py): the train step
# under make_rules, allreduce_int8_ef, the Trainer, a 1x2 resume and the
# elastic reshard.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS = 3
# The Trainer's run: the launcher's data at a reduced size.
TRAINER_DATA = dict(seq_len=32, global_batch=4, seed=0)
TRAINER_STEPS = 2
# Head layouts whose Megatron branches a 2-way "model" dim takes beside
# reduced stablelm's 4 q / 4 KV heads (config changes, applied to the
# reference's config too): MQA's one KV head, whole on every rank (each
# local q head reads it; the wk/wv gradients summed over "model"); 6 q
# heads over 3 KV heads, which "model" does not divide (a rank's q heads
# read two KV heads); 3 q heads, which it does not divide (the heads
# whole, wo's rows gathered).
HEAD_CASES = {"mqa": {"n_kv_heads": 1},
              "kv_whole": {"n_heads": 6, "n_kv_heads": 3},
              "q_whole": {"n_heads": 3, "n_kv_heads": 1}}


def train_model_config(case: str | None = None):
    return reduced_config(TRAIN_ARCH).replace(**HEAD_CASES.get(case, {}))


def train_tcfg(**kw):
    """The mesh tests' TrainConfig: lr 1e-3 from the first step (no
    warm-up), so that every step moves the parameters."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig
    return TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=0, **kw)


def trainer_config(steps: int, ckpt_dir: str, int8: bool = False):
    """The Trainer's TrainConfig, TrainerConfig and DataConfig."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import TrainerConfig
    cfg = reduced_config(TRAIN_ARCH)
    tcfg = train_tcfg(total_steps=4,
                      grad_compression="int8_ef" if int8 else "none")
    return (tcfg, TrainerConfig(steps=steps, ckpt_every=100,
                                ckpt_dir=ckpt_dir, log_every=0),
            DataConfig(vocab=cfg.vocab, **TRAINER_DATA))


def _host(tree):
    """``tree``'s tensors as numpy arrays (bf16 ones as float32)."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t: (t.detach().cpu().float() if t.dtype ==
                               torch.bfloat16 else t.detach().cpu()
                               ).numpy().copy(), tree)


def train_rank(mesh, device, params, tokens, dirs, g, e,
               head_params) -> dict:
    """A rank of the 2x2 training mesh: three train steps from ``params``
    (full, seeded) on its rows of ``tokens``, the gathered parameters
    after steps 1 and 3 and its own blocks; one int8_ef step;
    ``allreduce_int8_ef`` on the same ``g``/``e`` everywhere and on
    ``g`` scaled by 1 + its data coordinate; the Trainer over the mesh
    (its checkpoint written by the leader), a 1x2 mesh resuming from it,
    and a host tree resharded onto the 1x2 mesh; then, for each of
    ``HEAD_CASES`` (its ``head_params``), the loss and the gathered
    gradients at its initial parameters and one step."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.api import (gather_state, mesh_group,
                                          shard_state, use_rules)
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer
    cfg = reduced_config(TRAIN_ARCH)
    tcfg = train_tcfg()
    rules = make_rules(mesh, n_routed=cfg.n_routed)
    specs = TS.state_specs(cfg, tcfg, rules)
    full = {"params": params, "opt": O.init_opt_state(params, tcfg.optimizer)}
    state = shard_state(rules, full, specs)
    state["params"] = TS.trainable(state["params"])
    d = mesh.get_coordinate()[0]
    rows = tokens.shape[0] // mesh.mesh.shape[0]
    local = torch.as_tensor(tokens[d * rows:(d + 1) * rows])
    step = TS.make_train_step(cfg, tcfg)
    out = {"coord": tuple(mesh.get_coordinate()), "metrics": [],
           "params": {}}
    with use_rules(rules):
        for i in range(TRAIN_STEPS):
            state, m = step(state, local)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, TRAIN_STEPS):
                out["params"][i + 1] = O.tree_map(np.array, T.params_to_numpy(
                    gather_state(rules, state["params"], specs["params"]),
                    cfg))
        out["blocks"] = _host(state)
        # One int8_ef step from here (err zeros).
        tcfg8 = train_tcfg(grad_compression="int8_ef")
        state["err"] = O.tree_map(torch.zeros_like, state["params"])
        state, m = TS.make_train_step(cfg, tcfg8)(state, local)
        out["int8_step"] = {"loss": float(m["loss"]),
                            "params": _host(gather_state(
                                rules, state["params"], specs["params"])),
                            "err": _host(gather_state(rules, state["err"],
                                                      specs["params"]))}
    # allreduce_int8_ef, the reference's test inputs, then unequal scales.
    tg, te = {"w": torch.as_tensor(g)}, {"w": torch.as_tensor(e)}
    o, r = TS.allreduce_int8_ef(tg, te, mesh, ("data",))
    o2, r2 = TS.allreduce_int8_ef({"w": tg["w"] * (1 + d)}, te, mesh,
                                  ("data",))
    out["int8"] = {"out": o["w"].numpy(), "err": r["w"].numpy(),
                   "unequal_out": o2["w"].numpy(),
                   "unequal_err": r2["w"].numpy()}
    # The Trainer over the mesh; then a 1x2 mesh of ranks 0 and 1 resumes.
    tcfg_t, run, data = trainer_config(TRAINER_STEPS, dirs["trainer"])
    tr = Trainer(cfg, tcfg_t, run, data_cfg=data, device=device, rules=rules)
    st = tr.train()
    out["trainer"] = {"metrics": tr.metrics_log,
                      "gathered": _host(gather_state(rules, st, tr.specs))}
    mgr = ElasticMeshManager(model_parallel=2, devices_per_node=1)
    sub = mgr.rebuild_mesh(mgr.decide(healthy_nodes=2))
    mesh_group(sub)
    host = O.tree_map(lambda t: t.detach().clone(), params)
    blocks = mgr.reshard(sub, host, n_routed=cfg.n_routed)
    out["resume"] = out["reshard"] = None
    if blocks is not None:
        sub_rules = make_rules(sub, n_routed=cfg.n_routed)
        sub_specs = sub_rules.tree_pspecs(host)
        out["reshard"] = {
            "coord": tuple(sub.get_coordinate()),
            "blocks": _host(blocks),
            "gathered": _host(gather_state(sub_rules, blocks, sub_specs))}
        tcfg_t, run, data = trainer_config(TRAINER_STEPS + 1,
                                           dirs["trainer"])
        tr = Trainer(cfg, tcfg_t, run, data_cfg=data, device=device,
                     rules=sub_rules)
        tr.train()
        out["resume"] = tr.metrics_log
    out["heads"] = {key: heads_case(mesh, key, p, local)
                    for key, p in head_params.items()}
    return out


def heads_case(mesh, key: str, params, tokens) -> dict:
    """Model ``key`` of ``HEAD_CASES`` on the mesh from its full
    ``params``, on this rank's rows ``tokens``: the loss and every
    gradient gathered whole at the initial parameters, then one step's
    metrics and the gathered parameters after it."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.api import gather_state, shard_state, use_rules
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    cfg, tcfg = train_model_config(key), train_tcfg()
    rules = make_rules(mesh, n_routed=cfg.n_routed)
    specs = TS.param_specs(cfg, rules)
    p = TS.trainable(shard_state(rules, params, specs))
    with use_rules(rules):
        loss, grads = TS.value_and_grad(p, tokens, cfg, tcfg, specs)
        state = {"params": p, "opt": O.init_opt_state(p, tcfg.optimizer)}
        state, m = TS.make_train_step(cfg, tcfg)(state, tokens)
        return {"loss": float(loss),
                "grads": _host(gather_state(rules, grads, specs)),
                "metrics": {k: float(v) for k, v in m.items()},
                "params": O.tree_map(np.array, T.params_to_numpy(
                    gather_state(rules, state["params"], specs), cfg))}


# ---------------------------------------------------------------------------
# MoE training on the mesh (tests/test_torch_mesh_train_moe.py): the EP and
# expert-TP branches under make_rules, drops and aux loss where capacity
# binds, microbatches over rows dealt microbatch-major (C15) and the
# Trainer.
# ---------------------------------------------------------------------------

# Reduced qwen2-moe's 8 routed experts: a 2-way "model" dim divides them
# (EP, 4 a rank); 5 it does not (expert-TP, each expert's 32 hidden units
# 16 a rank).
MOE_TRAIN_VARIANTS = {"ep": {}, "tp": {"n_routed": 5}}
# A capacity factor at which a step of the test's batch drops pairs.
MOE_BIND_FACTOR = 0.5
MOE_MICROBATCHES = 2


def moe_train_config(variant: str, **kw):
    return reduced_config(MOE_ARCH).replace(**MOE_TRAIN_VARIANTS[variant],
                                            **kw)


def moe_trainer_config(steps: int, ckpt_dir: str):
    """The MoE Trainer's TrainConfig, TrainerConfig and DataConfig."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import TrainerConfig
    cfg = moe_train_config("ep")
    return (train_tcfg(total_steps=4),
            TrainerConfig(steps=steps, ckpt_every=100, ckpt_dir=ckpt_dir,
                          log_every=0),
            DataConfig(vocab=cfg.vocab, **TRAINER_DATA))


def moe_train_rank(mesh, device, params_by_variant, tokens, ckpt_dir) -> dict:
    """A rank of the 2x2 mesh training reduced qwen2-moe: for each variant
    of ``MOE_TRAIN_VARIANTS`` (EP, expert-TP) TRAIN_STEPS steps from its
    full ``params`` on this rank's rows of ``tokens`` (metrics, the
    gathered parameters after the last), then from the same parameters
    at capacity factor MOE_BIND_FACTOR the loss and gathered gradients
    with each MoE call's drops and aux share; one EP step at that factor
    in MOE_MICROBATCHES microbatches on the rank's rows dealt
    microbatch-major (``data/pipeline.py:shard_rows``; its drops and aux
    shares); last the Trainer over the mesh (2 steps and a checkpoint,
    then a resume for a third).  After
    each variant's steps, one int8_ef step (``allreduce_int8_ef`` over the
    MoE leaves): its loss and the gathered parameters and residuals."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.api import gather_state, shard_state, use_rules
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer
    d = mesh.get_coordinate()[0]
    rows = tokens.shape[0] // mesh.mesh.shape[0]
    local = torch.as_tensor(tokens[d * rows:(d + 1) * rows])
    out = {"coord": tuple(mesh.get_coordinate()), "steps": {}, "bind": {}}
    tcfg = train_tcfg()
    for variant, params in params_by_variant.items():
        cfg = moe_train_config(variant)
        rules = make_rules(mesh, n_routed=cfg.n_routed)
        specs = TS.param_specs(cfg, rules)
        p = TS.trainable(shard_state(rules, params, specs))
        state = {"params": p, "opt": O.init_opt_state(p, tcfg.optimizer)}
        step = TS.make_train_step(cfg, tcfg)
        metrics = []
        with use_rules(rules):
            for _ in range(TRAIN_STEPS):
                state, m = step(state, local)
                metrics.append({k: float(v) for k, v in m.items()})
            out["steps"][variant] = {
                "metrics": metrics,
                "params": O.tree_map(np.array, T.params_to_numpy(
                    gather_state(rules, state["params"], specs), cfg))}
            # One int8_ef step from here (err zeros): allreduce_int8_ef
            # over the MoE leaves.
            state["err"] = O.tree_map(torch.zeros_like, state["params"])
            state, m = TS.make_train_step(
                cfg, train_tcfg(grad_compression="int8_ef"))(state, local)
            out["steps"][variant]["int8"] = {
                "loss": float(m["loss"]),
                "state": _host(gather_state(rules, [state["params"],
                                                    state["err"]],
                                            [specs, specs]))}
            bcfg = moe_train_config(variant,
                                    moe_capacity_factor=MOE_BIND_FACTOR)
            p = TS.trainable(shard_state(rules, params, specs))
            with DropSpy() as log:
                loss, grads = TS.value_and_grad(p, local, bcfg, tcfg, specs)
            out["bind"][variant] = {
                "loss": float(loss), "drops": log.drops, "aux": log.aux,
                "grads": _host(gather_state(rules, grads, specs))}
            if variant == "ep":
                state = {"params": p, "opt": O.init_opt_state(
                    p, tcfg.optimizer)}
                mb = train_tcfg(microbatches=MOE_MICROBATCHES)
                dealt = torch.as_tensor(tokens[shard_rows(
                    tokens.shape[0], d, mesh.mesh.shape[0],
                    MOE_MICROBATCHES)])
                with DropSpy() as log:
                    TS.make_train_step(bcfg, mb)(state, dealt)
                out["microbatch"] = {"drops": log.drops, "aux": log.aux}
    cfg = moe_train_config("ep")
    rules = make_rules(mesh, n_routed=cfg.n_routed)
    runs = []
    for steps in (TRAINER_STEPS, TRAINER_STEPS + 1):
        tcfg_t, run, data = moe_trainer_config(steps, ckpt_dir)
        tr = Trainer(cfg, tcfg_t, run, data_cfg=data, device=device,
                     rules=rules)
        tr.train()
        runs.append(tr.metrics_log)
    out["trainer"] = runs
    return out


# ---------------------------------------------------------------------------
# The rest of mesh training (tests/test_torch_mesh_train_zoo.py and
# tests/test_torch_mesh_train_sp.py): MLA with MoE and MTP, SSM, RG-LRU,
# resident experts and sequence parallelism, each held to one device.
# ---------------------------------------------------------------------------

# Each case: (arch, make_rules keywords, config changes).  deepseek-v3's
# MLA layers (2 dense, 2 MoE in EP) with its MTP block; mamba2-130m's SSM
# blocks; recurrentgemma-2b's RG-LRU blocks and MQA local attention;
# qwen2-moe's 8 experts resident, 2 a rank.
ZOO_CASES = {
    "deepseek": ("deepseek-v3-671b", {}, {}),
    "mamba": ("mamba2-130m", {}, {}),
    "rgemma": ("recurrentgemma-2b", {}, {}),
    "resident": (MOE_ARCH, {"moe_resident": True}, {}),
}
SP = {"sequence_parallel": True}
# Sequence parallelism over the dense arch and each other block kind:
# qwen2-moe's EP and resident experts, SSM, RG-LRU with MQA local
# attention, MLA with MoE and MTP.
SP_CASES = {
    "stablelm": (TRAIN_ARCH, SP, {}),
    "qwen_ep": (MOE_ARCH, SP, {}),
    "qwen_resident": (MOE_ARCH, dict(SP, moe_resident=True), {}),
    "mamba": ("mamba2-130m", SP, {}),
    "rgemma": ("recurrentgemma-2b", SP, {}),
    "deepseek": ("deepseek-v3-671b", SP, {}),
}
# deepseek-v3's layers above at its published dtype (bf16 parameters and
# compute), held to one device's bf16 step beside one device's f32 step
# from the same parameters, which says how far bf16 rounding alone moves
# a step.  Every token is routed to both of 2 experts (EP, one a rank),
# so that the routing is continuous: a top-k choice at a near-tie turns
# on the last bit of a bf16 score, and a token routed otherwise moves the
# loss by far more than rounding (BF16_ROUTED).
BF16 = {"dtype": "bfloat16", "param_dtype": "bfloat16"}
BF16_CASES = {"deepseek_bf16": ("deepseek-v3-671b", {},
                                dict(BF16, n_routed=2, top_k=2))}
# deepseek-v3 in bf16 with its own top-2 of 8 routing: the routing ids of
# a loss pass, compared with one device's (measured on the CPU: one token
# routed otherwise in the first MoE call apart, then the mesh's loss
# 0.114 from one device's, where one device's bf16 and f32 losses are
# 0.0056 apart).
BF16_ROUTED = ("deepseek-v3-671b", {}, BF16)
# The zoo's Trainer case: mamba2-130m, 2 steps and a checkpoint, then a
# resume for a third.
ZOO_TRAINER_CASE = "mamba"


def held_config(case):
    """A case's model config (its changes applied to the reference's
    config too)."""
    arch, _, kw = case
    return reduced_config(arch).replace(**kw)


def held_rules(mesh, case, cfg):
    from repro_torch.sharding.rules import make_rules
    return make_rules(mesh, n_routed=cfg.n_routed, **case[1])


def held_step(mesh, case, params, tokens, bind: bool = False) -> dict:
    """Case ``case`` on the mesh from its full ``params``, on this rank's
    rows ``tokens``: the loss and every gradient gathered whole at the
    initial parameters, then one step's metrics and the gathered
    parameters after it; with ``bind``, the loss, drops and aux shares at
    capacity factor MOE_BIND_FACTOR too."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.api import gather_state, shard_state, use_rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    cfg, tcfg = held_config(case), train_tcfg()
    rules = held_rules(mesh, case, cfg)
    specs = TS.param_specs(cfg, rules)
    p = TS.trainable(shard_state(rules, params, specs))
    out = {}
    with use_rules(rules):
        loss, grads = TS.value_and_grad(p, tokens, cfg, tcfg, specs)
        out["loss"], out["grads"] = float(loss), _host(gather_state(
            rules, grads, specs))
        if bind:
            bcfg = cfg.replace(moe_capacity_factor=MOE_BIND_FACTOR)
            with DropSpy() as log:
                loss, _ = TS.value_and_grad(p, tokens, bcfg, tcfg, specs)
            out["bind"] = {"loss": float(loss), "drops": log.drops,
                           "aux": log.aux}
        state = {"params": p, "opt": O.init_opt_state(p, tcfg.optimizer)}
        state, m = TS.make_train_step(cfg, tcfg)(state, tokens)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = O.tree_map(np.array, T.params_to_numpy(
        gather_state(rules, state["params"], specs), cfg))
    return out


def held_trainer_config(case, steps: int, ckpt_dir: str):
    """A held case's Trainer: TrainConfig, TrainerConfig and DataConfig."""
    from repro_torch.data import DataConfig
    from repro_torch.train.trainer import TrainerConfig
    return (train_tcfg(total_steps=4),
            TrainerConfig(steps=steps, ckpt_every=100, ckpt_dir=ckpt_dir,
                          log_every=0),
            DataConfig(vocab=held_config(case).vocab, **TRAINER_DATA))


def routing_ids(case, params, tokens, rules=None) -> list:
    """The routing ids ``top_i`` of each MoE plan in a no-grad loss pass
    of ``case`` from its full ``params`` on ``tokens`` (this rank's rows;
    under ``rules`` a plan routes the whole batch), each beside its MoE
    call's router probabilities of this rank's rows ``[T, E]``."""
    from repro_torch.sharding.api import shard_state, use_rules
    from repro_torch.train import train_step as TS
    cfg, tcfg = held_config(case), train_tcfg()
    with RoutingLog() as log, torch.no_grad():
        if rules is None:
            TS.loss_fn(params, tokens, cfg, tcfg)
        else:
            specs = TS.param_specs(cfg, rules)
            with use_rules(rules):
                TS.loss_fn(shard_state(rules, params, specs), tokens, cfg,
                           tcfg, specs)
    return [(t.cpu().numpy().copy(),
             p.reshape(-1, p.shape[-1]).float().cpu().numpy().copy())
            for (t, _, _), (p, _) in zip(log.plans, log.routes)]


def zoo_train_rank(mesh, device, cases, params, tokens, ckpt_dir) -> dict:
    """A rank of the 2x2 mesh for the zoo's cases (``cases``, a dict of
    ``ZOO_CASES``', ``BF16_CASES``' or ``SP_CASES``' entries):
    :func:`held_step` of each on this rank's rows of ``tokens`` (the bound
    run for resident experts); where ``params`` holds "bf16_routed", the
    routing ids of BF16_ROUTED from those parameters; with ``ckpt_dir``,
    the Trainer on ZOO_TRAINER_CASE over the mesh, 2 steps and a
    checkpoint, then a resume for a third; without
    it, the sequence parallel stablelm case on a sequence one shorter,
    which "model" does not divide (the stream whole), beside the same
    without sequence parallelism."""
    from repro_torch.train.trainer import Trainer
    d = mesh.get_coordinate()[0]
    rows = tokens.shape[0] // mesh.mesh.shape[0]
    local = torch.as_tensor(tokens[d * rows:(d + 1) * rows])
    out = {"coord": tuple(mesh.get_coordinate()),
           "cases": {key: held_step(mesh, case, params[key], local,
                                    bind=case[1].get("moe_resident", False))
                     for key, case in cases.items()}}
    if "bf16_routed" in params:
        cfg = held_config(BF16_ROUTED)
        out["routes"] = routing_ids(
            BF16_ROUTED, params["bf16_routed"], local,
            held_rules(mesh, BF16_ROUTED, cfg))
    if ckpt_dir is not None:
        case = ZOO_CASES[ZOO_TRAINER_CASE]
        cfg = held_config(case)
        runs = []
        for steps in (TRAINER_STEPS, TRAINER_STEPS + 1):
            tcfg, run, data = held_trainer_config(case, steps, ckpt_dir)
            tr = Trainer(cfg, tcfg, run, data_cfg=data, device=device,
                         rules=held_rules(mesh, case, cfg))
            tr.train()
            runs.append(tr.metrics_log)
        out["trainer"] = runs
    else:
        odd = local[:, :-1]
        case = SP_CASES["stablelm"]
        out["odd"] = {sp: held_step(mesh, (case[0], kw, {}),
                                    params["stablelm"], odd)
                      for sp, kw in (("sp", SP), ("plain", {}))}
    return out


def pod_train_rank(mesh, device, case, params, tokens) -> dict:
    """A rank of the (pod, data, model) mesh: :func:`held_step` of ``case``
    on this rank's rows of ``tokens``, the batch over ("pod", "data")."""
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    shape = dict(zip(names, mesh.mesh.shape))
    rows = tokens.shape[0] // (shape["pod"] * shape["data"])
    b = coord["pod"] * shape["data"] + coord["data"]
    local = torch.as_tensor(tokens[b * rows:(b + 1) * rows])
    return {"coord": tuple(mesh.get_coordinate()),
            "case": held_step(mesh, case, params, local)}
