"""The serving layouts: logical axes -> mesh dims, and the decode caches'
placement.

Counterpart of the serving subset of ``repro/sharding/rules.py``:
``AXIS_MAP_SERVE``, ``make_serve_rules``, ``PAGED_CACHE_RULES`` and
``cache_pspecs``; :func:`shard_caches` takes the place of
``cache_shardings``: it slices a full cache tree to this rank's shards.
Training's parameter rules, axis maps and contiguous-cache rules
(``PARAM_RULES``, ``AXIS_MAP_1POD``, ``CACHE_RULES``, ``make_rules``) come
with training: mesh serving runs the paged engine only.
"""

from __future__ import annotations

from repro_torch.sharding.api import MeshRules, local_shard

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


def make_serve_rules(mesh) -> MeshRules:
    """Rules for mesh serving (``PagedEngine`` with ``ServeConfig.mesh``):
    parameters replicated (replicated weights keep every product's
    contraction in single-device order), activations split over slots and
    attention heads only."""
    return MeshRules(mesh=mesh, axis_map=dict(AXIS_MAP_SERVE))


def cache_pspecs(rules: MeshRules, cache_tree):
    """The spec of every leaf of a decode-cache tree (``{segN: [{bI: layer
    cache}]}`` or any nesting of dicts and lists).  A paged layer's leaves
    (a dict with a "table" leaf) take ``PAGED_CACHE_RULES``; every other
    leaf is replicated."""

    def walk(node, axes=None):
        if isinstance(node, dict):
            table = PAGED_CACHE_RULES if "table" in node else {}
            return {name: walk(sub, table.get(name))
                    for name, sub in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(sub) for sub in node)
        return rules.pspec(axes or (None,) * node.ndim, node.shape)

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
