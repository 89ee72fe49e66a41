"""Step-granular checkpointing with atomic commit and auto-resume, in the
reference's on-disk format (``repro/train/checkpoint.py``), so that either
package resumes from the other's checkpoints.

Layout:
    <dir>/ckpt_<step>.tmp/   — in-progress write (never resumed from)
    <dir>/ckpt_<step>/       — committed (atomic rename)
        manifest.json        — step, leaves {file, shape, dtype, digest}, extra
        <leaf path, / → __>.npy — one file a leaf

Leaves are nested-dict paths of tensors, keys sorted.  A bf16 leaf is
written as raw 2-byte void (``<V2``), byte for byte the file the reference
writes for an ``ml_dtypes.bfloat16`` array, and read back from void
through int16 into ``torch.bfloat16``, so neither direction needs
``ml_dtypes``.  The digest is the first 16 hex digits of the SHA-256 of the
leaf's raw bytes.  Corrupted or partial checkpoints (no manifest, a
missing leaf) are skipped by ``latest_step``; ``load`` takes the newest
valid one.

Checkpoints stay mesh-agnostic: ``save`` writes a DTensor leaf as its full
array (``full_tensor()`` on every rank, the files written by rank 0), and
``load(shardings=)`` places each leaf onto any ``DeviceMesh`` and
placements (each rank slices its shard from the full array it read: no
communication), the counterpart of the reference's ``device_put`` onto
``NamedSharding``s.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.models.layers import is_dtensor


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that a 2-byte void array gets the ``<V2`` header
    numpy writes for ``ml_dtypes.bfloat16``."""
    if arr.dtype.kind != "V":
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Write a checkpoint of a nested dict of tensors (or numpy arrays);
    returns the committed path.  With DTensor leaves every rank of their
    mesh calls it: each leaf is gathered whole, rank 0 writes, and all
    wait for the commit."""
    flat = _flatten(tree)
    sharded = any(is_dtensor(v) for v in flat.values())
    if sharded:
        flat = {k: v.full_tensor() if is_dtensor(v) else v
                for k, v in flat.items()}
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_rank() != 0:
            dist.barrier()
            return os.path.join(directory, f"ckpt_{step}")
    path = _write(directory, step, flat, extra)
    if sharded:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()
    return path


def _write(directory: str, step: int, flat: dict,
           extra: dict | None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"ckpt_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        fname = path.replace("/", "__") + ".npy"
        _write_npy(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "digest": _digest(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _valid(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not os.path.isfile(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        return all(os.path.isfile(os.path.join(path, meta["file"]))
                   for meta in manifest["leaves"].values())
    except (json.JSONDecodeError, KeyError):
        return False


def steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)", name)
        if m and _valid(os.path.join(directory, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    s = steps(directory)
    return s[-1] if s else None


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if arr.dtype.kind == "V":  # raw 2-byte void: the bytes of a bf16 leaf
        if dtype != "bfloat16":
            raise ValueError(f"a void leaf of dtype {dtype!r}; only "
                             f"bfloat16 is stored as void")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def load(directory: str, step: int | None = None, verify: bool = False,
         device="cpu", shardings=None):
    """Load a checkpoint (the newest valid one if ``step`` is None) as a
    nested dict of tensors on ``device``; returns (tree, manifest).  With
    ``verify`` every leaf's digest is checked.  ``shardings``, a tree of
    the checkpoint's structure whose leaves carry ``mesh`` and
    ``placements`` (``sharding.policies.Sharding``), reshards every leaf
    onto its mesh as a DTensor, on the mesh's device type."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {directory}")
    path = os.path.join(directory, f"ckpt_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for leaf_path, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and _digest(arr) != meta["digest"]:
            raise IOError(f"digest mismatch for {leaf_path} in {path}")
        flat[leaf_path] = _to_tensor(arr, meta["dtype"], device)
    tree = _unflatten(flat)
    if shardings is not None:
        tree = _place(tree, shardings)
    return tree, manifest


def _place(tree, shardings):
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    mesh = shardings.mesh
    return distribute_tensor(tree.to(mesh.device_type), mesh,
                             list(shardings.placements), src_data_rank=None)


def gc(directory: str, keep: int = 3) -> None:
    """Remove all but the newest ``keep`` checkpoints (and stale .tmp dirs)."""
    for name in os.listdir(directory) if os.path.isdir(directory) else []:
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    for s in steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"ckpt_{s}"),
                      ignore_errors=True)
