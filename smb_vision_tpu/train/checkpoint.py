"""Train-state checkpoints as plain files: one directory per step.

`<dir>/<step>/` holds `state.bin` (every leaf's raw bytes, back to back)
and `manifest.json` (each leaf's key path, dtype name, shape and byte
offset). A save writes `<dir>/.tmp-<step>/` and renames it into place, so
a directory named by a step is always complete; the oldest steps beyond
`max_to_keep` are deleted after each save. Restore reads the leaves back
into the structure of a target tree (the live train state), so the tree's
layout lives in code, not on disk. Leaf dtypes round-trip exactly,
bfloat16 and int8 included (numpy dtypes from ml_dtypes).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import List, Optional

import jax
import numpy as np

_DATA = "state.bin"
_MANIFEST = "manifest.json"


def _host(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory, max_to_keep: Optional[int] = None):
        self.dir = Path(directory)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        if not self.dir.is_dir():
            return []
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / _MANIFEST).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        leaves = [(jax.tree_util.keystr(k), _host(v)) for k, v in
                  jax.tree_util.tree_leaves_with_path(state)]
        if jax.process_index() != 0:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.dir / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        manifest, offset = [], 0
        with open(tmp / _DATA, "wb") as f:
            for path, a in leaves:
                f.write(a.tobytes(order="C"))
                manifest.append({"path": path, "dtype": a.dtype.name,
                                 "shape": list(a.shape), "offset": offset})
                offset += a.nbytes
        (tmp / _MANIFEST).write_text(json.dumps({"leaves": manifest}))
        final = self.dir / str(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.dir / str(old), ignore_errors=True)

    def restore(self, step: int, target):
        """Leaves of checkpoint `step` in the structure of `target`
        (matched by key path; shapes and dtypes must agree)."""
        d = self.dir / str(step)
        entries = {e["path"]: e for e in
                   json.loads((d / _MANIFEST).read_text())["leaves"]}
        raw = np.memmap(d / _DATA, dtype=np.uint8, mode="r") \
            if (d / _DATA).stat().st_size else np.zeros(0, np.uint8)
        flat, treedef = jax.tree_util.tree_flatten_with_path(target)
        out = []
        for k, ref in flat:
            path = jax.tree_util.keystr(k)
            e = entries.get(path)
            if e is None:
                raise KeyError(f"checkpoint {d} has no leaf {path}")
            dt = np.dtype(jax.numpy.dtype(e["dtype"]))
            n = int(np.prod(e["shape"], dtype=np.int64)) * dt.itemsize
            a = np.frombuffer(raw[e["offset"]:e["offset"] + n].tobytes(),
                              dt).reshape(e["shape"])
            if tuple(a.shape) != tuple(np.shape(ref)):
                raise ValueError(f"{path}: checkpoint shape {a.shape} != "
                                 f"{np.shape(ref)}")
            out.append(a)
        return jax.tree_util.tree_unflatten(treedef, out)

    def delete_all(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
