"""Checkpoints of the port, in ``repro.ckpt``'s on-disk format, so that a
checkpoint written by either package restores in the other.

Layout:
    <dir>/step_<N>/
        manifest.json        {step, leaves, shards}
        shard_<i>.npz        the leaves as ``leaf_<j>``, ~512 MB a shard

A leaf's ``path`` is jax's ``keystr`` of its place in the tree
(``['params']['layers']['attn']['wq']``) and the leaves are in jax's
flatten order (dict keys sorted).  A bfloat16 leaf is stored as its raw
uint16 words under the dtype string ``"bfloat16"`` (numpy has no
bfloat16; ``repro`` writes ml_dtypes' words, which are the same bits); a
bfloat16 leaf restored into a numpy target comes back widened to f32
before the cast to the target's dtype.
Writes go to ``step_<N>.tmp`` and are renamed atomically, so
``latest_step`` only sees complete checkpoints; each shard's crc32 is in
the manifest and checked on restore.  Leaves may be torch tensors (any
device) or numpy arrays; ``restore`` returns each leaf as its target's
kind: a tensor on the target's device in its dtype, or a numpy array.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SHARD_BYTES = 512 * 1024 * 1024


def _flatten_with_paths(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in jax's flatten order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(tree: Any, flat) -> Any:
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(tree)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array to store, and its logical dtype string."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(1 << 20)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0

    def flush():
        nonlocal shard, shard_bytes
        if not shard:
            return
        name = f"shard_{len(manifest['shards'])}.npz"
        path = os.path.join(tmp, name)
        np.savez(path, **shard)
        manifest["shards"].append({"file": name, "crc32": _crc(path)})
        shard, shard_bytes = {}, 0

    for i, (name, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, logical = _host(leaf)
        key = f"leaf_{i}"
        manifest["leaves"].append(
            {"path": name, "key": key, "shard": len(manifest["shards"]),
             "dtype": logical, "shape": list(arr.shape)})
        shard[key] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= SHARD_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _restored(arr: np.ndarray, logical: str, target):
    """A stored array as ``target``'s kind, device and dtype."""
    bf16 = "bfloat16" in logical and arr.dtype == np.uint16
    if isinstance(target, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16) if bf16 else torch.from_numpy(arr)
        return t.to(device=target.device, dtype=target.dtype)
    if bf16:
        arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return np.asarray(arr, dtype=np.asarray(target).dtype)


def restore(ckpt_dir: str, step: int, target_tree: Any) -> Any:
    """The checkpoint of ``step`` in ``target_tree``'s structure; raises
    IOError on a corrupt shard and ValueError on another structure or a
    leaf of another shape."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for sh in manifest["shards"]:
        fpath = os.path.join(path, sh["file"])
        if _crc(fpath) != sh["crc32"]:
            raise IOError(f"checkpoint shard corrupt: {fpath}")
    loaded = [np.load(os.path.join(path, sh["file"]))
              for sh in manifest["shards"]]
    targets = [leaf for _, leaf in _flatten_with_paths(target_tree)]
    if len(manifest["leaves"]) != len(targets):
        raise ValueError("checkpoint/target tree structure mismatch")
    out = []
    for entry, tgt in zip(manifest["leaves"], targets):
        arr = loaded[entry["shard"]][entry["key"]]
        if list(arr.shape) != list(np.shape(tgt)):
            raise ValueError(f"shape mismatch for {entry['path']}: "
                             f"{arr.shape} vs {tuple(np.shape(tgt))}")
        out.append(_restored(arr, entry["dtype"], tgt))
    return _unflatten(target_tree, out)
