"""Crash snapshots: one JSON document per step, staged then promoted.

Counterpart of the snapshot half of ``repro/checkpoint/store.py``, with the
same on-disk layout, so a directory written by either package loads in the
other::

    <dir>/step_<NNNNNNNN>/snapshot.json    the engine's snapshot()
    <dir>/step_<NNNNNNNN>/MANIFEST.json    {"step": N, "kind": "snapshot"}

A write goes to a unique ``step_<N>.tmp.*`` staging directory first and is
published with one ``os.replace``: a reader sees the previous snapshot or
the new one, never a torn write.  ``save_snapshot``'s ``interrupt`` hook
runs between the two (the chaos harness's ``checkpoint_interrupt``), and
:func:`gc_staging` reclaims the staging orphans a dead writer leaves.

The pytree checkpoints of the reference (``save_checkpoint``,
``load_checkpoint``, ``CheckpointManager``) come with training, and its
prefix-store records with the swap and prefix tiers (ROADMAP).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time


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
