"""Pytree checkpoints, crash snapshots and the persistent prefix store,
staged then promoted.

Counterpart of ``repro/checkpoint/store.py``, with the same on-disk
layout, so a directory written by either package loads in the other::

    <dir>/step_<NNNNNNNN>/shard_<i>.npz    a checkpoint's leaves, round robin
    <dir>/step_<NNNNNNNN>/MANIFEST.json    {"step": N, "n_shards": n,
                                            "paths": [leaf paths]}
    <dir>/step_<NNNNNNNN>/snapshot.json    the engine's snapshot()
    <dir>/step_<NNNNNNNN>/MANIFEST.json    {"step": N, "kind": "snapshot"}
    <dir>/prefix_<digest>/record.npz       one prefix block's rows,
                                           keys L{i}__{k,v,pos}
    <dir>/prefix_<digest>/MANIFEST.json    {"kind": "prefix", "chain": [...],
                                            "n_layers": n}

A write goes to a unique ``step_<N>.tmp.*`` staging directory first and is
published with one ``os.replace``: a reader sees the previous snapshot or
the new one, never a torn write.  ``save_snapshot``'s ``interrupt`` hook
runs between the two (the chaos harness's ``checkpoint_interrupt``), and
:func:`gc_staging` reclaims the staging orphans a dead writer leaves.

A prefix record is one registered prefix block (``PagedEngine``'s disk
tier): its K/V rows and ``pos`` plane per paged layer, in the reference's
layer layout (a segment the reference stacks is one entry with a leading
reps axis), under the sha256 digest of its full token chain.  The
MANIFEST carries the chain itself and a load checks it, so a digest
collision reads as a miss, never as another prefix's KV.

A bf16 cache's K/V rows travel as their bits (uint16 host arrays; numpy
has no bf16).  They are stored as their raw 2-byte values under the type
the reference's ml_dtypes arrays are stored under (``<V2``), so a record
holds the same bytes whichever package wrote it, and a load gives any
2-byte field back as uint16 bits.  The reference itself cannot load such
a record (its ``astype`` refuses the void type; ROADMAP C7); the port
loads both packages' records.

Under a mesh the serving engine writes whole records, the bytes one
device writes: it gathers a record from the ranks' KV heads, and the rank
at the mesh's first position alone writes it, handing the outcome to the
others (``sharding/api.py:write_once``) before any of them reads.

A checkpoint is a tree of nested dicts and lists with tensor or numpy
leaves.  Its leaf paths are the reference's (``jax.tree_util`` order: dict
keys sorted, list entries by index, joined with "/"), and an npz key is
its path with "/" written "__".  The train state goes to disk in the
reference's layout (``train/train_step.py:state_to_numpy``: scanned
segments stacked), so ``params/seg0/b0/attn/wq/w``, ``opt/m/...`` and
``opt/step`` name the same arrays in both packages.  :class:`CheckpointManager`
saves in a background thread from a host copy taken at the call, keeps the
newest ``keep`` steps and reclaims staging orphans.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import zipfile

import numpy as np


def _stage_named(directory: str, name: str) -> str:
    """Create a staging dir for one atomic write of ``<directory>/<name>``.
    Each save gets its own (concurrent writers of one target must not share
    one); ``mkdtemp`` creates it 0700, so the umask's permissions are put
    back, since the inode becomes the published directory."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=f"{name}.tmp.")
    umask = os.umask(0)
    os.umask(umask)
    os.chmod(tmp, 0o777 & ~umask)
    return tmp


def _stage(directory: str, step: int) -> str:
    return _stage_named(directory, f"step_{step:08d}")


def _promote(tmp: str, final: str) -> None:
    """Atomically publish a fully written staging dir.  A crash before this
    point leaves only an orphaned ``.tmp`` dir for :func:`gc_staging`."""
    if os.path.exists(final):
        # A concurrent re-save of the same step may be removing this tree
        # too; whichever replace lands last wins.
        shutil.rmtree(final, ignore_errors=True)
    try:
        os.replace(tmp, final)
    except OSError:
        if not os.path.isdir(final):
            raise        # a real I/O failure: keep the staging dir
        # Another writer promoted the same step between the rmtree and the
        # replace; its copy is equivalent.
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Pytree checkpoints
# ---------------------------------------------------------------------------


def _leaf_paths(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted, list
    entries by index; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _map_paths(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(fn, v, prefix + (str(i),))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a host array that owns its memory (a CPU tensor's
    ``numpy()`` shares it): bf16 as its bits, uint16."""
    import torch
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.cpu().numpy()
        if t.device.type == "cpu":
            a = a.copy()
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    return np.array(leaf, copy=True)


def save_checkpoint(tree, directory: str, step: int, n_shards: int = 4):
    """Write ``tree`` as ``step_<N>/`` (staged, then promoted): leaf i goes
    to ``shard_{i % n_shards}.npz``, in leaf-path order."""
    pairs = list(_leaf_paths(tree))
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = _stage(directory, step)
    shards: list[dict] = [dict() for _ in range(n_shards)]
    for i, (p, leaf) in enumerate(pairs):
        a = leaf if isinstance(leaf, np.ndarray) else _host_copy(leaf)
        shards[i % n_shards][p.replace("/", "__")] = a
    for si, shard in enumerate(shards):
        _savez(os.path.join(tmp, f"shard_{si}.npz"), shard)
    manifest = {"step": step, "n_shards": n_shards,
                "paths": [p for p, _ in pairs]}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    _promote(tmp, final)
    return final


def load_checkpoint(tree_like, directory: str, step: int | None = None):
    """Restore into the structure of ``tree_like``; ``step=None`` takes the
    latest.  A tensor leaf of ``tree_like`` gives a tensor of its dtype on
    its device, a numpy leaf an array of its dtype (bf16 bits as uint16).
    bf16 leaves load from either package's files (the reference cannot
    load them, not even its own: ROADMAP C13).  Returns ``(tree, step)``."""
    import torch
    from repro_torch.models.attention import tensor_from_host
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    data: dict[str, np.ndarray] = {}
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(d, f"shard_{si}.npz")) as z:
            for k in z.files:
                data[k.replace("__", "/")] = z[k]

    def restore(path, ref):
        arr = data[path]
        if isinstance(ref, torch.Tensor):
            return tensor_from_host(arr, ref.device).to(ref.dtype)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            arr = arr.view(np.uint16)                # bf16 bits
        return np.asarray(arr, dtype=np.asarray(ref).dtype)

    return _map_paths(restore, tree_like), step


class CheckpointManager:
    """Async save and retention; ``wait()`` before the process exits."""

    def __init__(self, directory: str, keep: int = 3, n_shards: int = 4):
        self.directory = directory
        self.keep = keep
        self.n_shards = n_shards
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, tree, step: int):
        """Snapshot ``tree`` to host memory now, write it in a thread."""
        host_tree = _map_paths(lambda _, leaf: _host_copy(leaf), tree)
        self.wait()

        def worker():
            save_checkpoint(host_tree, self.directory, step, self.n_shards)
            self._gc()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def save_sync(self, tree, step: int):
        save_checkpoint(tree, self.directory, step, self.n_shards)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, tree_like, step: int | None = None):
        return load_checkpoint(tree_like, self.directory, step)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
        # Staging dirs orphaned by a crash, once older than any save in
        # flight could be.
        gc_staging(self.directory, grace=600.0)


def save_snapshot(obj, directory: str, step: int, interrupt=None) -> str:
    """Atomically persist one JSON-serializable object (an engine's
    ``snapshot()``) as ``step_<N>/``.

    ``interrupt`` is called after the staging write and before the
    promote.  If it raises, the write dies where a host crash mid-save
    would: the staging dir is orphaned and the previously promoted snapshot
    stays the latest."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = _stage(directory, step)
    with open(os.path.join(tmp, "snapshot.json"), "w") as f:
        json.dump(obj, f)
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump({"step": step, "kind": "snapshot"}, f)
    if interrupt is not None:
        interrupt()
    _promote(tmp, final)
    return final


def load_snapshot(directory: str, step: int | None = None):
    """Load a :func:`save_snapshot` object; ``step=None`` takes the latest
    promoted one.  Returns ``(obj, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no snapshot under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "snapshot.json")) as f:
        return json.load(f), step


def gc_staging(directory: str, grace: float = 600.0) -> list[str]:
    """Reclaim ``.tmp`` staging dirs orphaned by a crashed or interrupted
    writer (``mkdtemp`` names are never reused).  ``grace`` spares writes
    still in flight by their age; a single writer that knows its own write
    just died may pass 0.  Returns the names reclaimed."""
    if not os.path.isdir(directory):
        return []
    reclaimed = []
    for n in os.listdir(directory):
        if ((n.startswith("step_") or n.startswith("prefix_"))
                and ".tmp" in n):
            p = os.path.join(directory, n)
            try:
                if time.time() - os.path.getmtime(p) >= grace:
                    shutil.rmtree(p, ignore_errors=True)
                    reclaimed.append(n)
            except OSError:
                pass
    return reclaimed


def latest_step(directory: str) -> int | None:
    """The newest promoted step (with a MANIFEST) under ``directory``."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
                s = int(name.split("_")[1])
                best = s if best is None or s > best else best
    return best


# ---------------------------------------------------------------------------
# The persistent prefix store (the disk tier of the serving KV hierarchy)
# ---------------------------------------------------------------------------


def _prefix_digest(chain) -> str:
    payload = json.dumps([int(t) for t in chain]).encode()
    return hashlib.sha256(payload).hexdigest()[:32]


def prefix_record_name(chain) -> str:
    """Directory name of one stored prefix block.  The digest is only a
    file name: the full chain lives in the MANIFEST, and a load checks it."""
    return f"prefix_{_prefix_digest(chain)}"


def save_prefix_record(directory: str, chain, layers,
                       interrupt=None) -> str:
    """Atomically persist one registered prefix block under its token
    chain.

    ``layers`` holds one dict of host arrays per paged layer, the block's
    ``k``/``v`` rows (f32, or bf16 bits as uint16) and ``pos`` plane as
    :func:`repro_torch.models.attention.extract_block_rows` gives them for
    one block.  Packed planes and scales are not stored: the loading engine
    derives its own from the rows through the write rule's scale update, so
    a record stays valid whatever the writer's scales were.

    The first writer wins: a chain already promoted is left as it is (the
    content under one chain is the same by construction).  ``interrupt``
    runs after the staging write and before the promote (the chaos
    harness's ``checkpoint_interrupt``); if it raises, the torn record is
    an invisible ``.tmp`` orphan for :func:`gc_staging`."""
    chain = [int(t) for t in chain]
    name = prefix_record_name(chain)
    final = os.path.join(directory, name)
    if os.path.isdir(final):
        return final
    tmp = _stage_named(directory, name)
    flat = {}
    for i, layer in enumerate(layers):
        for field, arr in layer.items():
            flat[f"L{i}__{field}"] = np.asarray(arr)
    _savez(os.path.join(tmp, "record.npz"), flat)
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump({"kind": "prefix", "chain": chain,
                   "n_layers": len(layers)}, f)
    if interrupt is not None:
        interrupt()
    _promote(tmp, final)
    return final


def load_prefix_record(directory: str, chain):
    """The layer arrays stored for ``chain``, or None on a miss.  A MANIFEST
    whose chain differs (a digest collision) is a miss."""
    chain = [int(t) for t in chain]
    d = os.path.join(directory, prefix_record_name(chain))
    manifest_path = os.path.join(d, "MANIFEST.json")
    if not os.path.isfile(manifest_path):
        return None
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "prefix" or manifest.get("chain") != chain:
        return None
    layers = [dict() for _ in range(manifest["n_layers"])]
    with np.load(os.path.join(d, "record.npz")) as z:
        for k in z.files:
            li, field = k.split("__", 1)
            a = z[k]
            if a.dtype.itemsize == 2 and a.dtype.kind == "V":
                a = a.view(np.uint16)             # bf16 bits
            layers[int(li[1:])][field] = a
    return layers


def _savez(path: str, arrays: dict) -> None:
    """``np.savez`` (uncompressed, one ``<key>.npy`` member per array, zip64
    forced as numpy forces it), writing a uint16 array, bf16 bits, with the
    header ml_dtypes' bf16 gets there: descr ``<V2``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype != np.uint16:
                    np.lib.format.write_array(f, arr)
                    continue
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": arr.shape})
                f.write(np.ascontiguousarray(arr).tobytes())


def _prefix_dirs(directory: str) -> list[str]:
    """Names of the promoted prefix records (staging orphans excluded), in
    digest order."""
    if not os.path.isdir(directory):
        return []
    return sorted(n for n in os.listdir(directory)
                  if n.startswith("prefix_") and ".tmp" not in n)


def list_prefix_records(directory: str) -> list[list[int]]:
    """Token chains of every promoted prefix record, in digest order."""
    chains = []
    for n in _prefix_dirs(directory):
        manifest_path = os.path.join(directory, n, "MANIFEST.json")
        if not os.path.isfile(manifest_path):
            continue
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("kind") == "prefix":
            chains.append(list(manifest["chain"]))
    return chains


def prefix_store_bytes(directory: str) -> int:
    """On-disk payload bytes of every promoted prefix record (the
    ``disk_prefix_bytes`` of ``PagedEngine.memory_report``)."""
    total = 0
    for n in _prefix_dirs(directory):
        try:
            total += os.path.getsize(os.path.join(directory, n, "record.npz"))
        except OSError:
            pass
    return total
