"""Atomic persistence for frozen index artifacts.

Same durability conventions as :mod:`repro.checkpoint.checkpointer` (write to
``<path>.tmp``, fsync, rename — a torn write never shadows a previous file),
for two artifact shapes:

* single-file ``.npz`` — every array plus a JSON metadata blob under the
  reserved key ``__meta__`` (:func:`save_npz_atomic` / :func:`load_npz`);
* a *segment manifest* directory — per-segment ``.npz`` files that are
  immutable once written, committed by an atomically-renamed ``manifest.json``
  (:func:`save_manifest_atomic` / :func:`load_manifest`). A crash between
  segment writes and the manifest rename leaves the previous manifest (and the
  files it references) fully intact.

Every failure path raises :class:`IndexIOError` (a ``ValueError`` subclass)
naming the file and the problem — a truncated/corrupt ``.npz`` or a missing
array key never surfaces as a bare ``KeyError``/``zipfile`` error. Kept free
of any ``repro_torch.core`` import so the core index can depend on it without a
cycle.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, Tuple

import numpy as np

META_KEY = "__meta__"
MANIFEST_NAME = "manifest.json"


class IndexIOError(ValueError):
    """A persisted index artifact is missing, truncated, or malformed."""


def save_npz_atomic(path: str, arrays: Dict[str, np.ndarray], meta: dict) -> str:
    """Atomically write ``arrays`` + ``meta`` to one uncompressed ``.npz``.

    On any failure the ``.tmp`` staging file is removed and an existing good
    file at ``path`` is left untouched (the rename only happens after a
    successful fsync)."""
    if META_KEY in arrays:
        raise ValueError(f"array key {META_KEY!r} is reserved for metadata")
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    payload = dict(arrays)
    payload[META_KEY] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"), dtype=np.uint8)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_npz(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load a :func:`save_npz_atomic` file -> (arrays, meta).

    Raises :class:`IndexIOError` for a missing file, a truncated or corrupt
    archive, undecodable metadata, or an absent ``__meta__`` key."""
    path = os.fspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    if not os.path.exists(path):
        raise IndexIOError(f"{path}: no such index artifact")
    try:
        with np.load(path, allow_pickle=False) as z:
            if META_KEY not in z.files:
                raise IndexIOError(
                    f"{path} is not an index artifact (no {META_KEY})")
            meta = json.loads(bytes(z[META_KEY]).decode("utf-8"))
            # materialize every member inside the context so a truncated
            # archive fails here, wrapped, not lazily at first use
            arrays = {k: z[k] for k in z.files if k != META_KEY}
    except IndexIOError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError, KeyError, ValueError,
            json.JSONDecodeError) as e:
        raise IndexIOError(f"{path}: corrupt or truncated index artifact "
                           f"({type(e).__name__}: {e})") from e
    return arrays, meta


def take(arrays: Dict[str, np.ndarray], key: str, path: str = "<artifact>"
         ) -> np.ndarray:
    """Fetch a required array, raising :class:`IndexIOError` (not KeyError)
    naming the missing key and the file it should have been in."""
    try:
        return arrays[key]
    except KeyError:
        raise IndexIOError(f"{path}: index artifact is missing required "
                           f"array {key!r}") from None


# ---- segment-manifest directories ----

def save_json_atomic(path: str, obj: dict) -> str:
    """Atomically write ``obj`` as JSON (tmp + fsync + rename)."""
    path = os.fspath(path)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def save_manifest_atomic(root: str, manifest: dict) -> str:
    """Commit a segment-manifest directory: the ``manifest.json`` rename is
    the commit point, so callers must write every referenced ``.npz`` first
    (immutable, content-named files). Returns the manifest path."""
    root = os.fspath(root)
    os.makedirs(root, exist_ok=True)
    return save_json_atomic(os.path.join(root, MANIFEST_NAME), manifest)


def load_manifest(root: str) -> dict:
    """Read a directory's ``manifest.json`` -> dict (IndexIOError on any
    missing/undecodable manifest)."""
    path = os.path.join(os.fspath(root), MANIFEST_NAME)
    if not os.path.exists(path):
        raise IndexIOError(f"{path}: no such manifest")
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise IndexIOError(f"{path}: corrupt manifest "
                           f"({type(e).__name__}: {e})") from e


def gc_unreferenced(root: str, referenced: set, subdir: str = "segments"
                    ) -> int:
    """Delete ``root/subdir`` files not named in ``referenced`` (basenames).
    Called after a manifest commit; never touches referenced files."""
    seg_dir = os.path.join(os.fspath(root), subdir)
    if not os.path.isdir(seg_dir):
        return 0
    removed = 0
    for name in os.listdir(seg_dir):
        if name not in referenced and not name.endswith(".tmp"):
            os.unlink(os.path.join(seg_dir, name))
            removed += 1
    return removed
