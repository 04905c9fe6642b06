"""Fault-tolerant checkpoints (port of ``repro.checkpoint.manager``).

The reference's layout, so that one checkpoint reads the same in both
packages: ``<dir>/ckpt-%08d/arrays.npz`` (``np.savez``, one array per
flattened key) and ``meta.json`` (``round``, ``digest`` = SHA-256 of the
payload, ``keys``, ``extra``; the port adds ``dtypes``, which the
reference's reader ignores).

  * atomic: written to ``<dir>/.tmp-<round>``, meta.json fsynced, then
    renamed to ``ckpt-%08d``, so a crash mid-write never corrupts the
    newest checkpoint;
  * self-validating: ``restore_latest`` walks back past a checkpoint whose
    digest does not match or which will not load into the template (a
    missing key, a wrong shape);
  * bounded retention: the newest ``keep`` checkpoints stay.

Keys are the reference's flattened paths: ``/``-joined dict keys (sorted)
and sequence indices, with ``None`` subtrees and empty tuples (SGD's
optimizer state) absent. Leaves are tensors or Python ints, stored as the
reference stores them: ints (``round``, Adam's ``t``) as 0-d int32, the
int64 words of the port's PRNG key as uint32, floats with their own dtype. numpy has no
bfloat16, so a bf16 leaf is stored as its raw 2-byte words (uint16), with
``bfloat16`` in ``meta["dtypes"]``: the reference writes its bf16 leaves as
numpy void ``V2`` arrays of the same bytes, and its own restore fails on
them and returns ``(None, None)``
(``tests/test_torch_checkpoint.py::test_reference_cannot_restore_its_bf16``).
The port restores a uint16 or V2 array as bf16 wherever the template's leaf
is bf16, so it reads its own checkpoints and the reference's.

Not saved, as in the reference: an async run's late-payload queue (it lives
in the built round step, ``fed/async_server.py``). The launcher's Plateau
controller and participation sampler restart on resume
(``launch/train.py``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _paths(tree, prefix=()):
    """[(path, leaf)] in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v,
                                                                prefix + (i,))]
    return [(prefix, tree)]


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf):
    """-> (array as the reference stores it, dtype name for meta.json)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).cpu().numpy().view(np.uint16),
                    "bfloat16")
        if t.dtype == torch.int64:
            # the port's key words: uint32 values in int64
            if t.numel() and not bool(((t >= 0) & (t <= _M32)).all()):
                raise ValueError("an int64 leaf holds values outside uint32")
            return t.cpu().numpy().astype(np.uint32), "uint32"
        arr = t.cpu().numpy()
        return arr, arr.dtype.name
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _from_numpy(arr: np.ndarray, tmpl):
    """A stored array -> the template leaf's type, dtype, device and
    pinning."""
    if not isinstance(tmpl, torch.Tensor):
        return int(arr.item())
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"shape {arr.shape} != the template's "
                         f"{tuple(tmpl.shape)}")
    if tmpl.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and (
            arr.dtype.kind == "V" or arr.dtype in (np.uint16, np.int16)):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    elif tmpl.dtype == torch.int64:
        t = torch.from_numpy(arr.astype(np.int64))
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(tmpl.dtype)
    if tmpl.device.type != "cpu":
        return t.to(tmpl.device)
    if tmpl.is_pinned():
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)
    return t


def _rebuild(tmpl, prefix, load):
    if tmpl is None:
        return None
    if isinstance(tmpl, dict):
        return {k: _rebuild(v, prefix + (k,), load) for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(v, prefix + (i,), load)
                          for i, v in enumerate(tmpl))
    return load(prefix, tmpl)


class CheckpointManager:
    """``save(round, tree)`` and ``restore_latest(template)`` over a
    directory. ``last_save`` / ``last_restore`` hold the timings of the
    latest call (seconds; bytes of the payload); ``skipped`` the
    checkpoints a restore walked past, with why."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self.last_save: dict = {}
        self.last_restore: dict = {}
        #: (path, error) of each checkpoint restore_latest walked past
        self.skipped: list = []
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, round_idx: int, state_tree: Any,
             extra: Optional[dict] = None) -> str:
        t0 = time.perf_counter()
        flat, dtypes = {}, {}
        for path, leaf in _paths(state_tree):
            flat[_key(path)], dtypes[_key(path)] = _to_numpy(leaf)
        t1 = time.perf_counter()
        tmp = os.path.join(self.dir, f".tmp-{round_idx}")
        final = os.path.join(self.dir, f"ckpt-{round_idx:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        payload = os.path.join(tmp, "arrays.npz")
        np.savez(payload, **flat)
        t2 = time.perf_counter()
        digest = _sha256(payload)
        t3 = time.perf_counter()
        meta = {"round": round_idx, "digest": digest,
                "keys": sorted(flat.keys()), "extra": extra or {},
                "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.last_save = {"round": round_idx,
                          "bytes": os.path.getsize(os.path.join(
                              final, "arrays.npz")),
                          "to_host_s": t1 - t0, "write_s": t2 - t1,
                          "hash_s": t3 - t2,
                          "total_s": time.perf_counter() - t0}
        return final

    def _gc(self):
        for _, path in self._list()[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    def _list(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt-(\d+)", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    # -- restore ------------------------------------------------------------
    def restore_latest(self, template_tree: Any):
        """-> (round_idx, tree) or (None, None). Walks back past corrupt
        checkpoints (digest mismatch, unreadable, or not matching the
        template's keys and shapes). Each leaf lands on the template
        leaf's device, dtype and pinning."""
        for round_idx, path in reversed(self._list()):
            t0 = time.perf_counter()
            try:
                with open(os.path.join(path, "meta.json")) as f:
                    meta = json.load(f)
                payload = os.path.join(path, "arrays.npz")
                if _sha256(payload) != meta["digest"]:
                    raise IOError("digest mismatch")
                t1 = time.perf_counter()
                with np.load(payload) as data:
                    tree = _rebuild(template_tree, (), lambda p, t: (
                        _from_numpy(data[_key(p)], t)))
            except (OSError, ValueError, KeyError, TypeError, EOFError,
                    zipfile.BadZipFile) as e:
                self.skipped.append((path, repr(e)))
                continue
            self.last_restore = {"round": round_idx,
                                 "bytes": os.path.getsize(payload),
                                 "hash_s": t1 - t0,
                                 "load_s": time.perf_counter() - t1}
            return round_idx, tree
        return None, None


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
