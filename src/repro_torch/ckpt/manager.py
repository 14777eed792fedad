"""Checkpoints with atomic publish, retention and async saves (port of
``repro.ckpt.manager``), in the reference's on-disk format, so either
package restores what the other wrote:

  * a checkpoint is a directory ``step_XXXXXXXX/``: ``manifest.json`` and
    one ``.npy`` per leaf of the tree, named by its flattened path (dict
    keys sorted, list and tuple items by index, NamedTuple fields by
    name, joined by "/"; "/" becomes "__" in the file name), each with
    the first 16 hex digits of the sha256 of its bytes;
  * bfloat16 leaves are stored as their raw 16-bit words (numpy has no
    bfloat16 without ``ml_dtypes``), with ``"dtype": "bfloat16"`` in the
    manifest: the same bytes, so the same hash, as the reference's;
  * saves are atomic: written to ``.tmp``, fsynced, then renamed (the
    leaves by a few threads at once, so hashing overlaps the disk);
  * ``save_async`` copies every leaf to the host before it returns and
    writes on a thread; a writer's error is raised by the next
    ``wait()``;
  * retention keeps the last ``keep`` checkpoints.

``restore`` loads the leaves into the structure of a template, as
tensors on an explicit device, or laid out on a tree of shardings
(``sharding.specs.NamedSharding``): the elastic path, since a checkpoint
does not record the mesh that wrote it.

A tree of DTensors (the sharded training state) is gathered leaf by
leaf on the calling thread, on every rank (a collective), and rank 0
alone writes it; ``save`` and ``wait`` then meet the other ranks at a
barrier, so a checkpoint is published on every rank when they return.
The writer thread runs no collective.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import resolve_device

BF16 = "bfloat16"
# leaves written (and read and hashed) at once: hashing and the disk overlap
_WORKERS = 4


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_like(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], flat, f"{prefix}{k}/")
                for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_like(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(template))
    return flat[prefix[:-1]]


def _leaf_path(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf -> (numpy array to store, manifest dtype); bfloat16 tensors
    as their 16-bit words; a DTensor gathered whole first."""
    if _is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        # a copy even on the CPU: the training loop updates its
        # parameters in place while the writer thread runs
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._meet = False        # a sharded save waits for its barrier

    # -- discovery ---------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        s = self.all_steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    @staticmethod
    def _snapshot(tree) -> dict:
        """Every leaf on the host, as it is written.  A sharded tree's
        leaves are gathered on every rank (a collective) and copied to the
        host by the writing rank only."""
        if _roles(tree)[1]:
            return {k: _to_host(v) for k, v in _flatten(tree).items()}
        for v in _flatten(tree).values():
            if _is_dtensor(v):
                v.full_tensor()
        return {}

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        """Synchronous atomic save."""
        sharded, writes = _roles(tree)
        host = self._snapshot(tree)
        final = os.path.join(self.directory, f"step_{step:08d}")
        if writes:
            final = self._write(step, host, extra or {})
        if sharded:
            _barrier()
        return final

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Copy every leaf to the host now, then write on a thread."""
        self.wait()
        self._meet, writes = _roles(tree)
        host = self._snapshot(tree)
        if not writes:
            return

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._meet:
            self._meet = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: dict, extra: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra}

        def leaf(item):
            name, (arr, dtype) = item
            fn = _leaf_path(name)
            with open(os.path.join(tmp, fn), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            return name, {"file": fn, "shape": list(arr.shape),
                          "dtype": dtype, "sha256": _digest(arr)}

        with ThreadPoolExecutor(_WORKERS) as pool:
            manifest["leaves"] = dict(pool.map(leaf, host.items()))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int | None, template, device=None,
                shardings=None, verify: bool = True):
        """Load checkpoint ``step`` (None: the latest) into the structure
        of ``template``, every leaf a tensor in its stored dtype on
        ``device`` (the card unless the caller asks for the CPU); with
        ``shardings`` (a tree like ``template`` of ``NamedSharding``)
        each leaf is laid out as a DTensor on its sharding, every rank
        reading the whole leaf and keeping its piece.  Returns (tree,
        extra, step); raises IOError on a leaf whose bytes do not match
        its hash."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        def leaf(item):
            name, meta = item
            arr = np.load(os.path.join(d, meta["file"]))
            if verify and _digest(arr) != meta["sha256"]:
                raise IOError(f"checkpoint corruption in leaf {name}")
            return name, arr

        place = lambda name, t: t  # noqa: E731
        if shardings is not None:
            from repro_torch.sharding.specs import distribute
            sh = _flatten(shardings)
            place = lambda name, t: distribute(t, sh[name])  # noqa: E731
        flat = {}
        with ThreadPoolExecutor(_WORKERS) as pool:
            for name, arr in pool.map(leaf, manifest["leaves"].items()):
                flat[name] = place(name, _from_host(
                    arr, manifest["leaves"][name]["dtype"], device))
        return _unflatten_like(template, flat), manifest["extra"], step


def _roles(tree) -> tuple[bool, bool]:
    """(whether ``tree`` holds DTensors, whether this rank writes it):
    of a sharded tree rank 0 alone writes."""
    sharded = any(_is_dtensor(v) for v in _flatten(tree).values())
    if not sharded:
        return False, True
    import torch.distributed as dist
    return True, dist.get_rank() == 0


def _barrier():
    import torch.distributed as dist
    dist.barrier()
