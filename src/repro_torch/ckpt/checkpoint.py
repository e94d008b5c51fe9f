"""Sharded, async, atomic checkpointing with elastic restore.

Port of ``src/repro/ckpt/checkpoint.py``, on the reference's layout (one
directory per step):

    <dir>/step_000000123.tmp/          — written first
        manifest.json                  — keys, shapes, dtypes, hash, extra
        shard_<host>.npz               — this host's leaves as uint8 bytes
    <dir>/step_000000123/              — atomic rename on commit

The manifest holds ``step``, ``num_hosts``, ``keys`` (each leaf's path in
the reference's ``keystr`` form, ``['params']['blocks'][0]…``), ``shapes``,
``dtypes`` (numpy's names: ``"float32"``, ``"bfloat16"``, ``"int64"``),
``shard_hash`` (sha256 of each host's npz) and ``extra``. Leaves are
flattened in ``nn.param.tree_flatten``'s order (dict keys sorted, lists in
order), which is JAX's order for the same tree, so a numpy tree saved by
either package restores in the other bit for bit. The port's parameter
tree holds one leaf per layer where the reference stacks its layers, so a
*trainer's* checkpoint does not swap between the packages leaf for leaf.

* async   — ``save`` copies every leaf to host memory before it returns
            (the device→host copy); a writer thread, which touches only
            numpy arrays, serializes, hashes and commits.
* atomic  — readers only ever see fully committed step directories.
* elastic — ``restore(shardings=)`` places the leaves on a mesh's device
            and checks that every rank of it holds the same bits.
* self-validating — a hash-mismatched, truncated or unreadable step is
            skipped with a warning; ``restore`` falls back to the newest
            earlier committed step.

bfloat16 leaves are written as their bytes under ``"bfloat16"``, as the
reference writes them; the port maps dtype names to torch dtypes itself
(no ``ml_dtypes``), reading a leaf's bytes back as ``uint8`` and viewing
them as its dtype.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import threading
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.nn.param import (is_node, tree_flatten, tree_paths,
                                  tree_unflatten)

#: everything a torn / truncated / corrupted step dir can throw at the
#: reader: missing files (OSError, which IOError aliases), torn manifest
#: json (json.JSONDecodeError ⊂ ValueError), truncated npz
#: (zipfile.BadZipFile), short raw buffers (ValueError), manifest missing
#: keys (KeyError).
_RESTORE_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile)

#: manifest dtype name → torch dtype
DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "uint16", "uint32", "uint64", "bool")
    if hasattr(torch, name)}
_NAMES = {v: k for k, v in DTYPES.items()}

_HASH_CHUNK = 1 << 24


def keystr(path) -> str:
    """A leaf's path in ``jax.tree_util.keystr``'s form: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    leaves, treedef = tree_flatten(tree)
    return [(keystr(p), x) for p, x in zip(tree_paths(tree), leaves)], \
        treedef


def to_host(x) -> Tuple[np.ndarray, List[int], str]:
    """(uint8 bytes, shape, dtype name) of a leaf, copied to host memory:
    the training loop may change the leaf in place once ``save`` returns."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _NAMES:
            raise TypeError(f"cannot checkpoint a {x.dtype} leaf")
        h = x.detach().to("cpu", copy=True).contiguous()
        return (h.reshape(-1).view(torch.uint8).numpy(), list(h.shape),
                _NAMES[x.dtype])
    a = np.ascontiguousarray(np.asarray(x))
    return np.frombuffer(a.tobytes(), np.uint8), list(a.shape), str(a.dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """The leaf stored as ``raw`` uint8 bytes: viewed as ``dtype`` (a
    manifest name), shaped ``shape``. A short or long buffer is a
    ``ValueError``, as numpy's ``frombuffer(...).reshape`` raises."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown checkpoint dtype {dtype!r}; have "
                         f"{sorted(DTYPES)}")
    tdt = DTYPES[dtype]
    want = math.prod(shape) * torch.empty((), dtype=tdt).element_size()
    raw = np.asarray(raw).reshape(-1)
    if raw.dtype != np.uint8 or raw.size != want:
        raise ValueError(f"leaf of {raw.size} bytes ({raw.dtype}) cannot "
                         f"hold a {dtype} array of shape {tuple(shape)}")
    return torch.from_numpy(raw).view(tdt).reshape(tuple(shape))


def _sharding_leaves(shardings, n: int) -> list:
    """One ``dist.sharding.Sharding`` per leaf: a single one stands for
    every leaf, a tree of them (dicts, lists, nodes) is walked in
    ``tree_flatten``'s order."""
    from repro_torch.dist.sharding import Sharding

    if isinstance(shardings, Sharding):
        return [shardings] * n
    out = []

    def walk(s):
        if isinstance(s, Sharding):
            out.append(s)
        elif isinstance(s, dict):
            for k in sorted(s):
                walk(s[k])
        elif isinstance(s, (list, tuple)):
            for x in s:
                walk(x)
        elif is_node(s):
            for x in s.tree_flatten()[0]:
                walk(x)
        else:
            raise TypeError(f"shardings holds {type(s).__name__}; expected "
                            f"dist.sharding.Sharding leaves")

    walk(shardings)
    if len(out) != n:
        raise ValueError(f"shardings has {len(out)} leaves, the tree {n}")
    return out


def _place_on_mesh(leaves: list, shardings, device) -> list:
    """Leaves on the mesh's device, each replicated (the port's mesh path
    is data-parallel only), checked to be the same bits on every rank."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import pex as dpex

    specs = _sharding_leaves(shardings, len(leaves))
    mesh = specs[0].mesh
    for s in specs:
        if s.mesh is not mesh:
            raise ValueError("shardings name more than one mesh")
        if not all(isinstance(p, Replicate) for p in s.placements):
            raise NotImplementedError(
                f"placements {s.placements}: the port's mesh path is "
                f"data-parallel only, so every leaf is replicated")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    out = [x.to(device) for x in leaves]
    dpex.check_replicated(out, mesh, tuple(mesh.mesh_dim_names),
                          what="restored checkpoint leaves")
    return out


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: Optional[threading.Thread] = None
        self._write_exc: Optional[BaseException] = None
        #: step actually used by the last successful restore() (it may
        #: have fallen back from the requested/latest step)
        self.last_restored_step: Optional[int] = None
        os.makedirs(directory, exist_ok=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """Remove ``step_*.tmp`` litter from a writer that crashed mid-save
        in a previous life. Readers never see tmp dirs (``all_steps``
        filters them), but the litter would block the atomic rename of a
        later save of the same step, and it wastes disk. Construction is
        the safe moment: this manager has no save in flight yet, and a
        committed dir is never named ``.tmp``."""
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                warnings.warn(f"sweeping stale checkpoint tmp dir {path} "
                              f"(crashed mid-save)")
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.unlink(path)

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.dir,
                            f"step_{step:09d}" + (".tmp" if tmp else ""))

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        """Device→host copy now; serialization, hashing and the commit on
        the writer thread."""
        # one in-flight save at a time, waited for before the copy: at most
        # one host copy of the tree exists
        self.wait()
        items, _ = _flatten(tree)
        host_items = [(k,) + to_host(v) for k, v in items]
        self._thread = threading.Thread(
            target=self._write, args=(step, host_items, extra or {}))
        self._thread.start()
        if block:
            self.wait()

    def wait(self) -> None:
        """Join the in-flight save. A background ``_write`` failure is
        captured on the writer thread and re-raised HERE (and therefore at
        the next ``save()``, which waits first) — silently losing
        checkpoints is how a later host failure becomes unrecoverable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_exc is not None:
            exc, self._write_exc = self._write_exc, None
            raise exc

    def _write(self, step: int, host_items, extra: Dict) -> None:
        try:
            self._write_inner(step, host_items, extra)
        except BaseException as e:          # noqa: BLE001 — re-raised at wait()
            self._write_exc = e

    def _write_inner(self, step: int, host_items, extra: Dict) -> None:
        tmp = self._step_dir(step, tmp=True)
        final = self._step_dir(step)
        os.makedirs(tmp, exist_ok=True)
        arrays = {f"leaf_{i}": raw
                  for i, (_, raw, _, _) in enumerate(host_items)}
        shard_path = os.path.join(tmp, f"shard_{self.host_id:05d}.npz")
        np.savez(shard_path, **arrays)
        manifest = {
            "step": step,
            "num_hosts": self.num_hosts,
            "keys": [k for k, _, _, _ in host_items],
            "shapes": [shape for _, _, shape, _ in host_items],
            "dtypes": [dtype for _, _, _, dtype in host_items],
            "shard_hash": {str(self.host_id): _sha256(shard_path)},
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int], like_tree, shardings=None,
                device=None) -> Tuple[Any, Dict]:
        """Rebuild the tree of ``like_tree``'s structure, each leaf in its
        like leaf's dtype, on ``device`` (default: each like leaf's own
        device; with ``shardings``, the mesh's device, every leaf checked
        replicated across the mesh's ranks).

        Verifies content hashes. A hash-mismatched, truncated, or otherwise
        unreadable step dir is *not* fatal: it warns and falls back to the
        newest earlier committed step, raising only when no restorable
        checkpoint exists — a single corrupt shard costing a step of
        progress beats it killing the run. The step actually used is
        recorded in ``self.last_restored_step``."""
        steps = self.all_steps()
        if step is None:
            candidates = list(reversed(steps))
        else:
            candidates = [step] + [s for s in reversed(steps) if s < step]
        assert candidates, "no checkpoint found"
        errors: List[str] = []
        for s in candidates:
            try:
                tree, extra = self._restore_step(
                    s, like_tree, None if shardings is not None else device)
            except _RESTORE_ERRORS as e:
                errors.append(f"step {s}: {type(e).__name__}: {e}")
                if len(candidates) > len(errors):
                    warnings.warn(
                        f"checkpoint step {s} unreadable "
                        f"({type(e).__name__}: {e}); falling back to the "
                        f"newest earlier committed step")
                continue
            self.last_restored_step = s
            if shardings is not None:
                leaves, treedef = tree_flatten(tree)
                tree = tree_unflatten(treedef, _place_on_mesh(
                    leaves, shardings, device))
            return tree, extra
        raise IOError("no restorable checkpoint in "
                      f"{self.dir}; tried: " + "; ".join(errors))

    def _restore_step(self, step: int, like_tree,
                      device) -> Tuple[Any, Dict]:
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        shard_path = os.path.join(d, f"shard_{self.host_id:05d}.npz")
        digest = _sha256(shard_path)
        want = manifest["shard_hash"].get(str(self.host_id))
        if want is not None and digest != want:
            raise IOError(f"checkpoint shard corrupt at step {step}")
        flat_like, treedef = tree_flatten(like_tree)
        if len(flat_like) != len(manifest["keys"]):
            raise ValueError(
                f"tree structure changed: checkpoint has "
                f"{len(manifest['keys'])} leaves, caller expects "
                f"{len(flat_like)}")
        out = []
        with np.load(shard_path) as data:
            for i, like in enumerate(flat_like):
                x = _from_bytes(data[f"leaf_{i}"], manifest["dtypes"][i],
                                manifest["shapes"][i])
                if isinstance(like, torch.Tensor):
                    x = x.to(device=like.device if device is None
                             else device, dtype=like.dtype)
                elif device is not None:
                    x = x.to(device)
                out.append(x)
        return tree_unflatten(treedef, out), manifest["extra"]
