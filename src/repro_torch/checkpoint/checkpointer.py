"""Sharded checkpointing with a data-availability manifest, on tensors.

The port of the JAX package's `repro/checkpoint/checkpointer.py`.  The
checkpoint IS a restart log in the paper's sense (§3.12): each saved
artifact (param shard file) is a produced dataset; the manifest commits
atomically (write + rename) only after every shard is durable, so a crash
mid-checkpoint leaves the previous manifest valid.  `ShardMapper` (XDTM) maps
the logical arrays to their physical shard files.

The on-disk format is the reference's: `step_XXXXXXXX/MANIFEST.json` and one
`.npz` file per shard, under the key paths of `_flatten` (dict keys in
sorted order and list indices, joined with "/"), so each package restores
what the other wrote.  A leaf goes to the host one at a time
(`.detach().cpu().numpy()`), so the host holds one leaf, not the state,
and a restore writes into the leaves of the live state it is given.  A
leaf whose dtype numpy cannot hold (bfloat16) raises with its key: it is
never widened on the way to disk.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.core.xdtm import PhysicalRef, ShardMapper

# torch dtypes that numpy holds bit for bit
_NUMPY_DTYPES = {torch.float64, torch.float32, torch.float16, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool}


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    """{key path: leaf} in JAX's leaf order: dict keys sorted, list and
    tuple items by index, None an empty subtree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten(t, prefix + (i,)))
        return out
    if tree is None:
        return {}
    return {"/".join(str(p) for p in prefix): tree}


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"checkpoint leaf {key!r} has dtype {leaf.dtype}, "
                            f"which numpy cannot hold; cast it before saving")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, n_shards: int = 1, keep: int = 3):
        self.directory = directory
        self.n_shards = n_shards
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def manifest_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), "MANIFEST.json")

    def save(self, step: int, state: dict) -> list[PhysicalRef]:
        """state: a tree (nested dicts and lists) of tensors or arrays."""
        sdir = self._step_dir(step)
        os.makedirs(sdir, exist_ok=True)
        entries = {}
        refs = []
        for key, leaf in _flatten(state).items():
            arr = _to_numpy(key, leaf)
            name = key.replace("/", ".")
            n_shards = self.n_shards if arr.ndim and arr.shape[0] >= \
                self.n_shards else 1
            mapper = ShardMapper(sdir, name, arr.shape, str(arr.dtype),
                                 n_shards)
            refs.extend(mapper.save(arr))
            entries[key] = {
                "name": name, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "n_shards": n_shards,
            }
            del arr
        # atomic manifest commit
        fd, tmp = tempfile.mkstemp(dir=sdir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"step": step, "entries": entries}, f)
        os.replace(tmp, self.manifest_path(step))
        self._gc()
        return refs

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "MANIFEST.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: dict, step: int | None = None) -> tuple:
        """Returns (state, step): `template` itself, each leaf overwritten
        with the stored array (`copy_` for a tensor, so the device holds one
        copy of the state; `np.copyto` for an array).  A stored shape or
        dtype that differs from the template leaf's raises (the leaves
        before it are already overwritten)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        sdir = self._step_dir(step)
        with open(self.manifest_path(step)) as f:
            manifest = json.load(f)
        for key, leaf in _flatten(template).items():
            e = manifest["entries"][key]
            mapper = ShardMapper(sdir, e["name"], tuple(e["shape"]),
                                 e["dtype"], e["n_shards"])
            arr = mapper.load()
            src = torch.from_numpy(arr) if isinstance(leaf, torch.Tensor) else arr
            if tuple(src.shape) != tuple(leaf.shape) or src.dtype != leaf.dtype:
                raise ValueError(
                    f"checkpoint leaf {key!r} is {tuple(src.shape)} "
                    f"{src.dtype}; the template's is {tuple(leaf.shape)} "
                    f"{leaf.dtype}")
            if isinstance(leaf, torch.Tensor):
                with torch.no_grad():
                    leaf.copy_(src)
            else:
                np.copyto(leaf, arr)
            del arr, src
        return template, step

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
