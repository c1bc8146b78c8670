"""Sharded, atomic, async checkpointing with reshard-on-restore.

The JAX package's contract and on-disk layout:

* **Atomic**: a checkpoint is a step directory written under a ``.tmp``
  name and renamed into place, then stamped with a ``COMMITTED`` marker.
  `latest_step()` only considers committed directories, so a crash
  mid-save never hides the last good step.
* **Layout**: one ``.npy`` per leaf, named by the leaf's path joined with
  "." (``params.layers.attn.wq``, ``opt.m.embed``, ``opt.step``; dict keys
  in sorted order, tuple and list entries by index, NamedTuple entries by
  field name), and a ``manifest.json`` of each leaf's name, shape and
  dtype.  A float32 or int32 checkpoint written by either package
  restores in the other with equal arrays.  A bfloat16 leaf is stored as
  the JAX package stores it: 2-byte records of its bits (numpy reads them
  back as ``V2`` without ``ml_dtypes``), manifest dtype ``bfloat16``.
* **Reshard-on-restore**: `restore` takes target placements (a tree of
  `repro_torch.sharding.partition.Sharding` on a `DeviceMesh`) and gives
  each rank a DTensor whose local shard is read, through
  ``np.load(mmap_mode="r")``, as only the slice that rank holds: save
  under one mesh, restore under another (elastic re-mesh).
* **Async**: `save_async` copies the tree to host memory (the only
  synchronous part) and writes it on a thread; an error surfaces on
  `wait()`.
* **Sharded save**: a tree of DTensors, or of each rank's slices with
  their placements (``placements``), is saved by every rank of the mesh
  at once.  Each copies only its own slices to the host; its thread
  sends them, over a gloo group of the mesh's ranks, to the one writer
  (the mesh's first rank), which assembles each whole leaf and writes the
  same files, byte for byte, as a one-device save of the same state, and
  commits.  `wait()` returns on every rank once that commit is made.
* **GC**: keep the last ``keep`` committed steps, and any step that is a
  multiple of ``keep_every``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch

COMMIT = "COMMITTED"
_SEP = "."
_BF16 = np.dtype("V2")      # the bits of a bfloat16, as numpy keeps them


def _map_with_path(f, tree, path=()):
    """``f(path, leaf)`` over a tree of dicts (keys sorted), NamedTuples,
    tuples and lists, rebuilt in the same structure; None and empty
    containers have no leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(f, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(f, getattr(tree, n), path + (n,))
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        out = [_map_with_path(f, t, path + (str(i),))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return f(path, tree)


def _flatten_with_path(tree) -> list:
    """[(path, leaf)] in `_map_with_path`'s order."""
    out = []
    _map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _leaf_name(path) -> str:
    return _SEP.join(path) or "leaf"


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf (tensors copied off their device, never
    shared with them; bfloat16 as its 2-byte records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.array(leaf)


def _sharding_of(dt):
    """The `Sharding` of a DTensor's placements."""
    from repro_torch.sharding.partition import Sharding
    spec = [None] * dt.ndim
    for name, pl in zip(dt.device_mesh.mesh_dim_names, dt.placements):
        if pl.is_shard():
            d = pl.dim
            spec[d] = name if spec[d] is None else \
                (spec[d] if isinstance(spec[d], tuple) else (spec[d],)) \
                + (name,)
    return Sharding(dt.device_mesh, tuple(spec))


def _host_slices(tree, placements):
    """[(path, host copy of this rank's slice, its Sharding, the whole
    leaf's shape)] of a tree of DTensors or of slices with
    ``placements``, or None when the tree holds neither."""
    from torch.distributed.tensor import DTensor
    flat = _flatten_with_path(tree)
    if placements is None:
        if not any(isinstance(x, DTensor) for _, x in flat):
            return None
        shs = [_sharding_of(x) if isinstance(x, DTensor) else None
               for _, x in flat]
    else:
        shs = [sh for _, sh in _flatten_with_path(placements)]
        if len(shs) != len(flat):
            raise ValueError(f"placements have {len(shs)} leaves, the tree "
                             f"{len(flat)}")
    out = []
    for (path, x), sh in zip(flat, shs):
        if isinstance(x, DTensor):
            x = x.to_local()
        if sh is None:
            raise ValueError(f"{_leaf_name(path)}: a plain leaf in a "
                             f"sharded tree has no placement")
        arr = _to_host(x)
        out.append((path, arr, sh, sh.global_shape(arr.shape)))
    return out


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor of (a slice of) a leaf read back: ``arr`` is copied into
    memory here, ``dtype`` is the manifest's."""
    arr = np.array(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3
    keep_every: int = 0  # additionally keep steps % keep_every == 0

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._groups: dict = {}    # mesh ranks -> their gloo group

    # ----------------------------------------------------------- listing --
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, COMMIT)):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -------------------------------------------------------------- save --
    def save(self, step: int, tree, extra: dict | None = None,
             placements=None) -> None:
        """Synchronous save.  ``tree`` may hold tensors (on any device),
        numpy arrays and Python scalars; or DTensors, or this rank's
        slices with ``placements`` (a tree of `Sharding`), saved by every
        rank of their mesh together (see the module)."""
        self.wait()  # serialize with any in-flight async save
        slices = _host_slices(tree, placements)
        if slices is not None:
            self._start_sharded(step, slices, extra)
            self.wait()
            return
        self._write(step, [(p, _to_host(x))
                           for p, x in _flatten_with_path(tree)], extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None,
                   placements=None) -> None:
        """Copy to host now (a sharded tree: this rank's slices only);
        write in a background thread."""
        self.wait()
        slices = _host_slices(tree, placements)
        if slices is not None:
            self._start_sharded(step, slices, extra)
            return
        host = [(p, _to_host(x)) for p, x in _flatten_with_path(tree)]
        extra = dict(extra or {})

        def work():
            try:
                self._write(step, host, extra)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _start_sharded(self, step: int, slices: list, extra) -> None:
        """The thread of a sharded save: send this rank's slices to the
        writer, which assembles, writes and commits; then a barrier of the
        mesh's ranks."""
        import torch.distributed as dist
        mesh = slices[0][2].mesh
        ranks = tuple(sorted(mesh.mesh.flatten().tolist()))
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(
                list(ranks), backend="gloo", use_local_synchronization=True)
        group = self._groups[ranks]
        writer = int(mesh.mesh.flatten()[0])
        me = dist.get_rank()
        coords = {r: tuple(int(i) for i in (mesh.mesh == r).nonzero()[0])
                  for r in ranks}
        extra = dict(extra or {})

        def assembled():
            """Each leaf gathered to the writer, which gets it whole (one
            leaf in host memory at a time)."""
            for path, arr, sh, shape in slices:
                flat = np.ascontiguousarray(arr).reshape(-1)
                local = torch.from_numpy(flat.view(np.uint8))
                parts = ([torch.empty_like(local) for _ in ranks]
                         if me == writer else None)
                dist.gather(local, parts, dst=writer, group=group)
                if me != writer:
                    continue
                full = np.empty(shape, dtype=arr.dtype)
                for k, part in enumerate(parts):
                    r = dist.get_global_rank(group, k)
                    full[sh.local_index(shape, coords[r])] = \
                        part.numpy().view(arr.dtype).reshape(arr.shape)
                yield path, full

        def work():
            try:
                if me == writer:
                    self._write(step, assembled(), extra)
                else:
                    for _ in assembled():
                        pass
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e
            finally:
                dist.barrier(group=group)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight async save (if any) commits."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_leaves, extra: dict) -> None:
        """Write ``host_leaves`` ((path, host array) pairs in the tree's
        order, a list or an iterator), then commit."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for path, arr in host_leaves:
            name = _leaf_name(path)
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"].append(
                {"name": name, "shape": list(arr.shape),
                 "dtype": "bfloat16" if arr.dtype == _BF16
                 else str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # commit marker written only after the rename: readers never see a
        # half-written committed step.
        with open(os.path.join(final, COMMIT), "w") as f:
            f.write("ok")
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        drop = steps[:-self.keep] if self.keep else []
        for s in drop:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ----------------------------------------------------------- restore --
    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, target_tree, placements=None):
        """Restore into the structure of ``target_tree``.

        ``target_tree`` supplies the structure and each leaf's shape,
        dtype and device (tensors; a leaf on the ``meta`` device restores
        to the CPU, or with placements to the mesh's device type).  Without ``placements`` each leaf is read whole.
        With ``placements`` (a tree of `Sharding` of the same structure)
        each leaf becomes a DTensor on its mesh whose local shard is read
        as only this rank's slice of the memory-mapped ``.npy``
        (reshard-on-restore).
        """
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, COMMIT)):
            raise FileNotFoundError(f"step {step} not committed in {d}")
        dtypes = {lf["name"]: lf["dtype"]
                  for lf in self.manifest(step)["leaves"]}
        flat = _flatten_with_path(target_tree)
        sh_flat = ([s for _, s in _flatten_with_path(placements)]
                   if placements is not None else [None] * len(flat))
        if len(sh_flat) != len(flat):
            raise ValueError(f"placements have {len(sh_flat)} leaves, the "
                             f"target {len(flat)}")
        by_path = {}
        for (path, tgt), sh in zip(flat, sh_flat):
            name = _leaf_name(path)
            mm = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
            if tuple(mm.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {mm.shape} != target "
                    f"{tuple(tgt.shape)}")
            by_path[path] = self._read_leaf(mm, dtypes.get(name, ""), tgt,
                                            sh)
        return _map_with_path(lambda p, _: by_path[p], target_tree)

    @staticmethod
    def _read_leaf(mm, dtype: str, tgt, sh):
        """One leaf in ``tgt``'s dtype and on its device, whole or, with a
        `Sharding` ``sh``, as a DTensor of this rank's slice."""
        device = tgt.device
        if device.type == "meta":
            device = torch.device("cpu" if sh is None
                                  else sh.mesh.device_type)
        if sh is None:
            return _from_host(mm, dtype).to(dtype=tgt.dtype, device=device)
        from torch.distributed.tensor import DTensor
        index = sh.local_index(tuple(mm.shape), sh.mesh.get_coordinate())
        local = _from_host(mm[index], dtype).to(dtype=tgt.dtype,
                                                device=device)
        shape = tuple(mm.shape)
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def restore_extra(self, step: int) -> dict:
        return self.manifest(step)["extra"]
