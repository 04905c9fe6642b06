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

Under ``stream(devices=D)`` each rank holds only its own client-state
rows (``core.fedavg.owned_rows``); given their ``StateRows``, ``save`` is
called on every rank, gathers the rows to rank 0 in rank order and rank 0
writes the reference's (G, N, d) layout, and ``restore_latest`` gives each
rank its rows of that layout, so a checkpoint saved at one device count
resumes at any other. The rows cross in pieces of ``GATHER_CHUNK_BYTES``
and a restore reads a rank's rows alone from the payload. A D > 1 save and
restore has run at test sizes only (d = 96, a reduced qwen2), not at full
width on a card.

Not saved, as in the reference: an async run's late-payload queue (it lives
in the built round step, ``fed/async_server.py``). The launcher's Plateau
controller and participation sampler restart on resume
(``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import time
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF

#: a D-rank save gathers the state rows to rank 0 in pieces of at most this
#: many bytes (a rank's rows run to gigabytes at full width; no message may
#: near the 2 GiB of a signed 32-bit size)
GATHER_CHUNK_BYTES = 256 << 20
#: a restore reads a rank's rows from the payload this many bytes at a time
READ_CHUNK_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class StateRows:
    """Where the client-state rows of a ``stream(devices=D)`` run lie: rank
    r of ``group`` (the default torch.distributed group when None) holds
    cohort rows ``spans[r]`` = (lo, hi) of every slot under ``key``, flat
    (hi - lo, d); the saved layout is ``lead + (d,)``, lead = (G, N).
    ``group`` is a subgroup only in tests that run D = 2 on pairs of a
    4-rank group."""
    spans: Tuple[Tuple[int, int], ...]
    lead: Tuple[int, ...]
    key: str = "comp_state"
    group: Any = None


def _gather_rows(slots: dict, rows: StateRows):
    """Every rank's rows of each slot, in rank order, to rank 0 (point to
    point in pieces of ``GATHER_CHUNK_BYTES``, through host memory under
    gloo) -> {slot: lead + (d,)} host tensors on rank 0, None on the other
    ranks."""
    import torch.distributed as dist
    g = rows.group
    rank = dist.get_rank(g)
    staged = dist.get_backend(g) == "gloo"

    def peer(r):
        return r if g is None else dist.get_global_rank(g, r)
    out = {}
    for k in sorted(slots):
        mine = slots[k]
        step = max(1, GATHER_CHUNK_BYTES // mine.element_size())
        if rank != 0:
            flat = mine.reshape(-1)
            for lo in range(0, flat.numel(), step):
                piece = flat[lo:lo + step]
                dist.send(piece.cpu() if staged else piece.contiguous(),
                          dst=peer(0), group=g)
            continue
        full = torch.empty((rows.spans[-1][1],) + tuple(mine.shape[1:]),
                           dtype=mine.dtype)
        for r, (lo, hi) in enumerate(rows.spans):
            dst = full[lo:hi].reshape(-1)
            if r == 0:
                dst.copy_(mine.reshape(-1))
                continue
            for a in range(0, dst.numel(), step):
                part = dst[a:a + step]
                if staged:
                    dist.recv(part, src=peer(r), group=g)
                else:
                    buf = torch.empty(part.shape, dtype=mine.dtype,
                                      device=mine.device)
                    dist.recv(buf, src=peer(r), group=g)
                    part.copy_(buf)
        out[k] = full.reshape(tuple(rows.lead) + tuple(mine.shape[1:]))
    return out if rank == 0 else None


def _read_rows(payload: str, key: str, lead: int, span) -> np.ndarray:
    """Rows ``span`` = (lo, hi) of the stored array ``key``, its first
    ``lead`` dims taken as one, read from its member of the .npz alone: the
    rows before are skipped (``np.savez`` stores members uncompressed, so
    the seek reads nothing) and those after are never read."""
    lo, hi = span
    fmt = np.lib.format
    with zipfile.ZipFile(payload) as z, z.open(key + ".npy") as f:
        version = fmt.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(f)
        else:
            raise ValueError(f"{key}: .npy format {version}")
        if fortran or dtype.hasobject or len(shape) < lead:
            raise ValueError(f"{key}: {shape} {dtype} is not a row-major "
                             f"array of {lead} lead dims")
        tail = tuple(shape[lead:])
        n_rows = int(np.prod(shape[:lead]))
        if not 0 <= lo <= hi <= n_rows:
            raise ValueError(f"{key}: rows {span} of {n_rows}")
        row = int(np.prod(tail)) * dtype.itemsize
        f.seek(lo * row, os.SEEK_CUR)
        out = np.empty((hi - lo,) + tail, dtype)
        buf = memoryview(out.reshape(-1).view(np.uint8))
        for a in range(0, out.nbytes, READ_CHUNK_BYTES):
            b = min(a + READ_CHUNK_BYTES, out.nbytes)
            part = f.read(b - a)
            if len(part) != b - a:
                raise EOFError(f"{key}: payload ends inside rows {span}")
            buf[a:b] = part
    return out


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
             extra: Optional[dict] = None,
             rows: Optional[StateRows] = None) -> Optional[str]:
        """Write ``state_tree`` as the checkpoint of ``round_idx`` -> its
        directory. With ``rows`` (a ``stream(devices=D)`` run) every rank
        calls it: the rows gather to rank 0, which writes; the other ranks
        return None."""
        t0 = time.perf_counter()
        if rows is not None and state_tree.get(rows.key) is not None:
            full = _gather_rows(state_tree[rows.key], rows)
            if full is None:
                return None
            state_tree = {**state_tree, rows.key: full}
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
    def restore_latest(self, template_tree: Any,
                       rows: Optional[StateRows] = None):
        """-> (round_idx, tree) or (None, None). Walks back past corrupt
        checkpoints (digest mismatch, unreadable, or not matching the
        template's keys and shapes). Each leaf lands on the template
        leaf's device, dtype and pinning. With ``rows``, this rank's rows
        of each stored client-state slot (``lead + (d,)``) fill the
        template's flat ones; they alone are read from the payload, so a
        rank's host memory holds its own rows, never the cohort's."""
        span = None
        if rows is not None:
            import torch.distributed as dist
            span = rows.spans[dist.get_rank(rows.group)]

        def stored(data, payload, p):
            if span is not None and p[0] == rows.key:
                return _read_rows(payload, _key(p), len(rows.lead), span)
            return data[_key(p)]

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
                        _from_numpy(stored(data, payload, p), t)))
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
