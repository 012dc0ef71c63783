"""The layouts: logical axes -> mesh dims, for training and for serving,
and the decode caches' placement.

Counterpart of ``repro/sharding/rules.py``.  Training's rules are the
reference's, entry for entry: ``PARAM_RULES`` (a parameter's path pattern
-> its logical axes, first match wins), ``AXIS_MAP_1POD`` /
``AXIS_MAP_MULTIPOD`` and :func:`make_rules` (FSDP over "data", Megatron
TP over "model", the batch over "data" or ("pod", "data")), and the
contiguous caches' ``CACHE_RULES``.  A rank holds its block of every
leaf under them (``sharding/api.py:shard_state``); ``models/`` and
``train/`` run the split the axis map gives (MoE: :func:`moe_train_branch`).

Serving keeps its own narrower map: ``AXIS_MAP_SERVE``,
:func:`make_serve_rules`, ``PAGED_CACHE_RULES`` and :func:`cache_pspecs`;
:func:`shard_caches` takes the place of ``cache_shardings``: it slices a
full cache tree to this rank's shards.  ``make_rules``' expert axes (its
``n_routed`` and ``moe_resident``) come into :func:`make_serve_rules`,
which places MoE expert weights as the branch ``models/moe.py`` runs
needs them (:func:`moe_branch`, :func:`shard_params`).
"""

from __future__ import annotations

from repro_torch.sharding.api import (MeshRules, local_shard, local_view,
                                      mesh_shape, splits_model)

# Path-pattern parameter rules (the reference's, in its order; first match
# wins).  Axis names refer to the AXIS_MAP keys below.
PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    # Embeddings / unembeddings: vocab over model (TP), embed over fsdp.
    (r"embed/table$", ("vocab", "fsdp")),
    (r"unembed/w$", ("fsdp", "vocab")),
    (r"mtp_head/w$", ("fsdp", "vocab")),
    # Attention projections: heads over model, d_model over fsdp.
    (r"attn/wq/w$", ("fsdp", "heads", None)),
    (r"attn/wk/w$", ("fsdp", "kv_heads", None)),
    (r"attn/wv/w$", ("fsdp", "kv_heads", None)),
    (r"attn/wq/b$", ("heads", None)),
    (r"attn/w[kv]/b$", ("kv_heads", None)),
    (r"attn/wo/w$", ("heads_flat", "fsdp")),
    # MLA projections (deepseek): latent ranks replicated, heads over model.
    (r"mla/wq_a/w$", ("fsdp", None)),
    (r"mla/wq_b/w$", (None, "heads", None)),
    (r"mla/wkv_a/w$", ("fsdp", None)),
    (r"mla/wkv_b/w$", (None, "heads", None)),
    (r"mla/wo/w$", ("heads_flat", "fsdp")),
    # Dense MLPs: ffn over model (Megatron).
    (r"(mlp|ffn|shared)/wi(_gate|_up)?/w$", ("fsdp", "ffn")),
    (r"(mlp|ffn|shared)/wo/w$", ("ffn", "fsdp")),
    # MoE experts: expert axis over model (EP) when divisible, else the
    # per-expert ffn axis picks up "model" (expert-TP).
    (r"moe/router/w$", ("fsdp", None)),
    (r"moe/wi(_gate|_up)?$", ("expert", "expert_dmodel", "expert_ffn")),
    (r"moe/wo$", ("expert", "expert_ffn", "expert_dmodel")),
    # SSM (mamba2): inner channels over model.
    (r"ssm/in_proj/w$", ("fsdp", "ffn")),
    (r"ssm/out_proj/w$", ("ffn", "fsdp")),
    (r"ssm/(conv_w|conv_b|A_log|D|dt_bias)$", ("ffn",)),
    (r"ssm/norm/scale$", ("ffn",)),
    # RG-LRU (recurrentgemma): recurrent width over model.
    (r"rglru/(in_x|in_gate)/w$", ("fsdp", "ffn")),
    (r"rglru/out/w$", ("ffn", "fsdp")),
    (r"rglru/(a_param|conv_w|conv_b)$", ("ffn",)),
    (r"rglru/(rg|ig)/w$", (None, "ffn", None)),
    # Norm scales replicated.
    (r"(scale|bias)$", (None,)),
)

# Training's logical-axis -> mesh-dim map on one pod.
AXIS_MAP_1POD = {
    "batch": "data",
    "fsdp": "data",
    "embed": None,
    "seq": None,
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    # Attention output entering wo keeps its heads split, so wo is the
    # Megatron partial product and sum against the heads_flat rows.
    "heads_out": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": None,
    "seq_sp": "model",
    # Decode caches split their sequence over "model" (8 or 1 KV heads do
    # not divide a 16-way dim; the sequence always does).
    "kv_seq": "model",
}

AXIS_MAP_MULTIPOD = dict(AXIS_MAP_1POD, batch=("pod", "data"))

# Contiguous decode-cache leaf name -> logical axes, without the scan-stack
# axis (:func:`cache_pspecs` prepends a None for a stacked leaf).
CACHE_RULES: dict[str, tuple] = {
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
    "c_kv": ("batch", "kv_seq", None),
    "k_pe": ("batch", "kv_seq", None),
    "conv": ("batch", None, "ffn"),
    "ssm": ("batch", None, None, None),
    "h": ("batch", "ffn"),
    "pos": ("kv_seq",),
    "length": (),
}

# Paged block-pool caches reuse contiguous leaf names ("k", "v", "pos") at
# pool shapes, so they have their own table, chosen by the "table" leaf in
# the same dict.  Pools split their KV heads over "model" (per-head BESF
# attention needs no softmax collective); the page axis is replicated, so
# the host allocator keeps one block id space and every rank's tables
# address its own head slice of the pool.  The per-slot leaves stay whole:
# every rank writes every slot's K/V (the dense layers run all slots), and
# the slots split over "data" only at the attention call
# (``models/attention.py:_shard_paged_attention``), where the reference
# places its "batch" entries.  Indivisible dims (MQA's one KV head on a
# 2-way "model") replicate.
PAGED_CACHE_RULES: dict[str, tuple] = {
    "k": (None, None, "kv_heads", None),          # [nb, bs, Hkv, D]
    "v": (None, None, "kv_heads", None),
    "kq": (None, None, None, "kv_heads", None),   # [nb, bits, bs/8, Hkv, D]
    "k_amax": ("kv_heads",),                      # [Hkv]
    "v_amax": ("kv_heads",),
    "pos": (None, None),                          # [nb, bs] fill levels
    "table": (None, None),                        # [slots, MB] block tables
    "length": (None,),                            # [slots]
}

# The serving map: only axes whose sharding is pure data movement are
# mapped, slots over "data" and attention heads over "model".  Every other
# logical axis (and so every axis a float contraction runs over: ffn, the
# flattened heads into wo, embed, vocab, kv_seq) is replicated, as
# ``MeshRules.pspec`` does for a name the map lacks, so no collective
# reassociates a float sum and sharded serving gives single-device tokens.
AXIS_MAP_SERVE = {
    "batch": "data",
    "heads": "model",
    "kv_heads": "model",
}


# MoE expert weights ([E, D, H] in, [E, H, D] out): experts over "expert",
# each expert's hidden units over "expert_ffn".  Which mesh dims those map
# to depends on the branch (:func:`moe_branch`).
MOE_PARAM_RULES: dict[str, tuple] = {
    "wi_gate": ("expert", None, "expert_ffn"),
    "wi_up": ("expert", None, "expert_ffn"),
    "wo": ("expert", "expert_ffn", None),
}


def moe_branch(shape: dict[str, int], n_routed: int,
               resident: bool = False) -> str:
    """The MoE branch a mesh of dims ``shape`` runs, the reference's choice
    (``repro/models/moe.py:153-166``): "single" without routed experts or
    with a "model" dim of 1; "resident" (experts over data x model) when
    asked for and data x model divides ``n_routed``; "ep" (experts over
    "model") when "model" divides it; else "tp" (every expert on every
    rank, its hidden units over "model")."""
    tp, data = shape.get("model", 1), shape.get("data", 1)
    if not n_routed or tp == 1:
        return "single"
    if resident and n_routed % (data * tp) == 0:
        return "resident"
    return "ep" if n_routed % tp == 0 else "tp"


def moe_train_branch(rules: MeshRules, n_routed: int, d_model: int,
                     d_expert: int) -> str:
    """The MoE branch training's ``rules`` put a rank in, read from the
    spec its expert weights were cut by (the axis map, then
    divisibility): "resident" where the experts lie over "data" (and
    "model"), "ep" where they lie over "model", "tp" where each expert's
    hidden units do, else "whole" (every expert whole on every "model"
    rank)."""
    spec = rules.param_pspec("moe/wi_gate", (n_routed, d_model, d_expert))
    names = () if spec[0] is None else (
        (spec[0],) if isinstance(spec[0], str) else tuple(spec[0]))
    if "data" in names:
        return "resident"
    if splits_model(rules, spec[0]):
        return "ep"
    return "tp" if splits_model(rules, spec[2]) else "whole"


def _expert_axes(shape: dict[str, int], n_routed: int,
                 resident: bool) -> dict:
    """``make_rules``' expert axes for serving: resident experts over
    ("data", "model"), EP experts over "model", expert-TP hidden units over
    "model".  Serving keeps no optimizer state, so the reference's
    FSDP placement of EP's hidden units over "data" has no counterpart."""
    branch = moe_branch(shape, n_routed, resident)
    return {"expert": {"resident": ("data", "model"),
                       "ep": "model"}.get(branch),
            "expert_ffn": "model" if branch == "tp" else None}


def splits_heads(rules: MeshRules, n_kv_heads: int) -> bool:
    """Whether the paged pools hold a block of the KV heads under
    ``rules``: a "model" dim of more than one rank that divides
    ``n_kv_heads``, the divisibility ``PAGED_CACHE_RULES`` applies (MQA's
    one KV head on two ranks stays whole)."""
    tp = rules.shape.get("model", 1)
    return tp > 1 and n_kv_heads % tp == 0


def make_serve_rules(mesh, n_routed: int = 0,
                     moe_resident: bool = False) -> MeshRules:
    """Rules for mesh serving (``PagedEngine`` with ``ServeConfig.mesh``):
    parameters replicated (replicated weights keep every product's
    contraction in single-device order) but for routed MoE experts, which
    a rank holds a block of (:func:`_expert_axes`); activations split over
    slots and attention heads only.  Only expert-TP splits a contraction:
    its partial products are summed in rank order (``models/moe.py``)."""
    axis_map = dict(AXIS_MAP_SERVE)
    if n_routed:
        axis_map.update(_expert_axes(
            mesh_shape(mesh), n_routed,
            moe_resident))
    return MeshRules(mesh=mesh, axis_map=axis_map)


def expert_slice(rules: MeshRules, p: dict, n_routed: int,
                 d_expert: int) -> dict:
    """An MoE block's parameters with this rank's block of the expert
    weights, as views of the full ones (no copy): the branch's layout under
    ``rules``.  Leaves already at the rank's shape (the engine's
    :func:`shard_params`) stay as they are."""
    out = dict(p)
    for name, axes in MOE_PARAM_RULES.items():
        w = p[name]
        full = (n_routed, d_expert) == (
            (w.shape[0], w.shape[2]) if name != "wo" else
            (w.shape[0], w.shape[1]))
        if full:
            out[name] = local_view(rules, w, rules.pspec(axes, w.shape))
    return out


def shard_params(rules: MeshRules, params, n_routed: int, d_expert: int):
    """A parameter tree with every MoE block's expert weights cut to this
    rank's block (views: a rank that received the weights by shared memory
    or CUDA IPC holds no copy); every other leaf as it is."""
    if not n_routed:
        return params

    def walk(node, key=None):
        if isinstance(node, dict):
            if key == "moe":
                return expert_slice(rules, node, n_routed, d_expert)
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def cache_pspecs(rules: MeshRules, cache_tree):
    """The spec of every leaf of a decode-cache tree (``{segN: [{bI: layer
    cache}]}`` or any nesting of dicts and lists), routed as the
    reference routes it: a paged layer's leaves (a dict with a "table"
    leaf) take ``PAGED_CACHE_RULES``, a contiguous layer's
    ``CACHE_RULES`` (a leaf with one more axis than its rule is
    scan-stacked: its leading axis is replicated); a leaf no rule names is
    replicated.  The serving map names neither "kv_seq" nor "ffn", so
    under it a contiguous cache splits its batch over "data" at most."""

    def spec_for(axes, leaf):
        if axes is None:
            axes = (None,) * leaf.ndim
        elif leaf.ndim == len(axes) + 1:
            axes = (None,) + tuple(axes)
        return rules.pspec(axes, leaf.shape)

    def walk(node, axes=None):
        if isinstance(node, dict):
            table = PAGED_CACHE_RULES if "table" in node else CACHE_RULES
            return {name: walk(sub, table.get(name))
                    for name, sub in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(sub) for sub in node)
        return spec_for(axes, node)

    return walk(cache_tree)


def shard_caches(rules: MeshRules, cache_tree):
    """This rank's shards of a full cache tree for mesh serving: every
    leaf sliced by its spec (:func:`cache_pspecs`)."""
    specs = cache_pspecs(rules, cache_tree)

    def walk(spec, node):
        if isinstance(node, dict):
            return {k: walk(spec[k], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(s, c) for s, c in zip(spec, node))
        return local_shard(rules, node, spec)

    return walk(specs, cache_tree)


def make_rules(mesh, *, sequence_parallel: bool = False, fsdp: bool = True,
               moe_ep: bool | None = None, n_routed: int = 0,
               moe_resident: bool = False) -> MeshRules:
    """Training's rules over ``mesh`` (a ``DeviceMesh`` or an
    ``api.AbstractMesh``), the reference's: ``PARAM_RULES`` under
    ``AXIS_MAP_1POD`` (``AXIS_MAP_MULTIPOD`` where the mesh has "pod");
    ``sequence_parallel`` maps "seq" to "model"; ``fsdp=False`` keeps the
    weights whole over "data".  ``moe_ep``: EP configs store the expert
    hidden dim over "data", expert-TP configs over "model"; left None it
    follows from ``n_routed`` over "model".  ``moe_resident`` splits the
    experts over data x model."""
    shape = mesh_shape(mesh)
    axis_map = dict(AXIS_MAP_MULTIPOD if "pod" in shape else AXIS_MAP_1POD)
    if sequence_parallel:
        axis_map["seq"] = "model"
    if not fsdp:
        axis_map["fsdp"] = None
    if moe_ep is None:
        tp = shape.get("model", 1)
        moe_ep = bool(n_routed) and n_routed % tp == 0
    # EP:        wi [E->model, D, H->data]   (H gathered before use)
    # expert-TP: wi [E, D->data, H->model]   (D gathered before use)
    axis_map["expert_ffn"] = "data" if moe_ep else "model"
    axis_map["expert_dmodel"] = None if moe_ep else "data"
    if not moe_ep:
        axis_map["expert"] = None
    if moe_resident:
        axis_map["expert"] = ("data", "model")
        axis_map["expert_ffn"] = None
        axis_map["expert_dmodel"] = None
    return MeshRules(mesh=mesh, axis_map=axis_map, param_rules=PARAM_RULES)
