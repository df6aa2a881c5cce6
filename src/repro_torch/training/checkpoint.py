"""Atomic checkpoints in ``repro``'s layout (port of
``repro.training.checkpoint``).

Layout:  <dir>/step_00000042/
            manifest.json          leaf names, each leaf's dtype, shape and files
            <leaf-path>.s0.npy     one file a leaf (``/`` in the name -> ``__``)
         <dir>/LATEST              committed step pointer (atomic rename commit)

The leaf names and files are ``repro``'s (``params/layers/wq``, layers
stacked ``[L, ...]``; a :class:`~.tree.Stacked` leaf is written as one
array), so a float32 checkpoint written by either package restores in the
other.  A bfloat16 leaf is written as ``repro`` writes it: its raw bits
under the ``.npy`` descr ``'<V2'``, with dtype ``bfloat16`` in the
manifest.  Restore reads such a leaf by viewing the bits as
``torch.bfloat16``, so the port reads the bf16 checkpoints that ``repro``'s
own ``restore`` cannot cast back.

Writes go to a temp dir first and are renamed into place -- a crashed save
can never corrupt the latest checkpoint.  ``save`` copies every leaf to the
host before its writer thread starts, so training may go on (and overwrite
its tensors in place) while the files are written.  ``events`` records each
save (the host copy's and the write's seconds, the bytes written) and each
restore (its seconds and the bytes read).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device

from .tree import Stacked, map_leaves, named_leaves

# a tensor's dtype name in the manifest (numpy's names, as ``repro`` writes them)
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _file_name(name: str) -> str:
    return name.replace("/", "__") + ".s0.npy"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype name) of a leaf; a bfloat16 leaf's array
    holds its bits as int16."""
    if isinstance(leaf, Stacked):      # layer by layer into one host array
        host = torch.empty(leaf.shape, dtype=leaf.dtype)
        for row, t in zip(host, leaf):
            row.copy_(t.detach())
        leaf = host
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    name = _DTYPE_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy(), name


def _save_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # repro's bytes: numpy writes an ml_dtypes bfloat16 array as '<V2'
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.events: list[dict] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extras: dict | None = None):
        self.wait()
        t0 = time.perf_counter()
        host = [(name, *_to_host(leaf)) for name, leaf in named_leaves(tree)]
        event = {"kind": "save", "step": step, "copy_s": time.perf_counter() - t0}
        self.events.append(event)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_reporting, args=(step, host, extras or {}, event))
            self._thread.start()
        else:
            self._write(step, host, extras or {}, event)

    def _write_reporting(self, step: int, host: list, extras: dict, event: dict):
        try:
            self._write(step, host, extras, event)
        except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
            self._error = e

    def _write(self, step: int, host: list, extras: dict, event: dict):
        t0 = time.perf_counter()
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extras": extras, "leaves": {}}
        for name, arr, dtype in host:
            fname = _file_name(name)
            _save_leaf(tmp / fname, arr, dtype)
            manifest["leaves"][name] = {
                "files": [fname], "dtype": dtype, "shape": list(arr.shape)}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        with open(self.dir / ".LATEST_tmp", "w") as f:
            f.write(str(step))
        os.rename(self.dir / ".LATEST_tmp", self.dir / "LATEST")
        event["write_s"] = time.perf_counter() - t0
        event["bytes"] = sum(f.stat().st_size for f in final.iterdir())
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self):
        """Wait for the last asynchronous save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> int | None:
        """The last committed step, once the save in flight (if any) has
        committed: a recovery right after an asynchronous save restores
        that save.  (``repro``'s reads ``LATEST`` without waiting, so a
        failure while its first save is still being written finds no
        checkpoint and replays from step 0 on the state it has.)"""
        self.wait()
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        return int(f.read_text())

    def restore(self, step: int, target, device=None):
        """-> (tree shaped as ``target``, extras).

        ``target`` defines the structure: a tree of tensors (``meta`` ones
        too), :class:`~.tree.Stacked` leaves or arrays.  With ``device``
        None, each tensor leaf of ``target`` on a real device is written in
        place and returned (the live training state restores without a
        second copy); a ``meta`` or array leaf gets a new tensor on the card
        (raising without one).  With ``device`` given, every leaf is a new
        tensor there (``repro``'s ``shardings``: the restore onto another
        mesh's device).  Leaves keep the checkpoint's dtype when new, the
        target's when written in place.
        """
        self.wait()
        t0 = time.perf_counter()
        d = self.dir / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        names = iter(name for name, _ in named_leaves(target))
        read = []

        def put(leaf):             # one leaf on the host at a time
            info = manifest["leaves"][next(names)]
            path = d / info["files"][0]
            read.append(path.stat().st_size)
            return _place(leaf, _load_leaf(path, info["dtype"]), device)

        out = map_leaves(put, target)
        self.events.append({"kind": "restore", "step": step, "bytes": sum(read),
                            "seconds": time.perf_counter() - t0})
        return out, manifest["extras"]


def _place(leaf, value: torch.Tensor, device):
    """``value`` (a host tensor of the whole leaf) put where ``leaf`` says."""
    if isinstance(leaf, Stacked):
        if len(leaf) != value.shape[0]:
            raise ValueError(f"checkpoint leaf of {value.shape[0]} layers for "
                             f"{len(leaf)} in the target")
        return Stacked(_place(t, v, device) for t, v in zip(leaf, value.unbind(0)))
    in_place = (device is None and isinstance(leaf, torch.Tensor)
                and leaf.device.type != "meta")
    if in_place:
        if tuple(leaf.shape) != tuple(value.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(value.shape)} for "
                             f"{tuple(leaf.shape)} in the target")
        with torch.no_grad():
            leaf.copy_(value)
        return leaf
    return value.to(resolve_device(device))
