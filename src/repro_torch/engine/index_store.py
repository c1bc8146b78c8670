"""On-disk index store: the resolved `Mapper` session, persisted.

Production mappers ship a prebuilt index (BWA-MEM2's ``.idx``) because
building it dominates a worker's cold start.  ``save_store`` writes what
`Mapper.from_index` resolves once per session: the reference in its
resolved flavor (uint8 bases, or 2-bit packed words written as uint32),
the SeedMap in its resolved layout (CSR tables or the `PaddedSeedMap`
rows), the resolved `PipelineConfig` / `LongReadConfig` /
`SeedMapConfig`, and a tune-cache snapshot, so ``Mapper.load`` rebuilds an
identical session without calling `build_seedmap`.

The format is the JAX package's, byte for byte: the same manifest keys,
the same array names per layout, int32 index payloads and uint32 packed
words.  Stores move between the two packages either way.  A store saved
here lacks the JAX configs' per-family kernel backends; the JAX package
fills them with its defaults on load.  This package drops them, and the
TPU launch blocks beside them, from a JAX store
(`core.config_fields.config_from_fields`); its own launch geometry (the
``*_block`` fields, warps or pairs a block of its kernels) round-trips.

Store layout (a directory)::

    <path>/manifest.json     version, layout, configs, array catalog
    <path>/<name>.npy        one raw payload per array (ref, rows, ...)

The manifest carries a per-file sha256, so a torn copy or bit-rot is
detected before any array is trusted; it is written last (atomic rename),
so an interrupted ``save_store`` never leaves a store that parses.

A corrupt, stale or version-mismatched store warns and degrades; it never
crashes a worker.  ``load_store`` returns ``None`` on any defect (one
``warnings.warn`` with the reason); `Mapper.load` then falls back to a full
``build`` when given a ``fallback_ref``, and `Mapper.swap_index` keeps the
index it already serves.  ``strict=True`` raises `IndexStoreError`
instead.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config_fields import config_from_fields
from repro_torch.core.long_read import LongReadConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.seedmap import PaddedSeedMap, SeedMap, SeedMapConfig

#: bump on any incompatible manifest/payload change; mismatched stores
#: degrade (they are rebuilt from the reference, not migrated)
STORE_VERSION = 1
MANIFEST = "manifest.json"

#: array names per index layout (the manifest's ``layout`` field)
_LAYOUTS = {
    "csr": ("offsets", "locations"),
    "padded": ("rows", "counts"),
}


class IndexStoreError(RuntimeError):
    """A store defect surfaced in ``strict`` mode (default: degrade)."""


class StorePayload(NamedTuple):
    """Everything `Mapper.from_index` needs, as host (CPU) tensors."""

    index: object                 # SeedMap | PaddedSeedMap
    ref: torch.Tensor             # uint8 bases or int32-held packed words
    pipe_cfg: PipelineConfig      # fully resolved at save time
    lr_cfg: LongReadConfig | None
    sm_config: SeedMapConfig
    tune_entries: dict
    manifest: dict


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host(t: torch.Tensor) -> np.ndarray:
    """One device -> host fetch of a whole tensor."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- save --
def save_store(path: str | os.PathLike, *, index, ref,
               pipe_cfg: PipelineConfig, sm_config: SeedMapConfig,
               lr_cfg: LongReadConfig | None = None,
               tune_entries: dict | None = None) -> str:
    """Persist a resolved session to the directory ``path``.

    ``index`` is the session's resolved SeedMap layout (`SeedMap` or
    `PaddedSeedMap`), ``ref`` the resolved reference flavor (uint8 bases
    or int32-held packed words, written as uint32); both may live on the
    device (each is fetched once).  Returns the manifest path.
    """
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    if isinstance(index, PaddedSeedMap):
        layout = "padded"
        arrays = {"rows": index.rows, "counts": index.counts}
    elif isinstance(index, SeedMap):
        layout = "csr"
        arrays = {"offsets": index.offsets, "locations": index.locations}
    else:
        raise TypeError(
            f"cannot persist index of type {type(index).__name__}; "
            "save the replicated session's SeedMap/PaddedSeedMap")
    arrays = {k: _host(v) for k, v in arrays.items()}
    ref_np = _host(ref)
    if ref_np.dtype == np.int32:         # packed words: the uint32 bits
        ref_np = ref_np.view(np.uint32)
    arrays["ref"] = ref_np

    catalog = {}
    for name, arr in arrays.items():
        fname = f"{name}.npy"
        fpath = os.path.join(path, fname)
        np.save(fpath, arr)
        catalog[name] = {
            "file": fname,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "sha256": _sha256(fpath),
        }

    manifest = {
        "version": STORE_VERSION,
        "layout": layout,
        "seedmap_config": dataclasses.asdict(sm_config),
        "pipeline_config": dataclasses.asdict(pipe_cfg),
        "long_read_config": (None if lr_cfg is None
                             else dataclasses.asdict(lr_cfg)),
        "tune_entries": dict(tune_entries or {}),
        "arrays": catalog,
    }
    # Manifest last, atomically: a store only parses once it is complete.
    mpath = os.path.join(path, MANIFEST)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, mpath)
    return mpath


# ---------------------------------------------------------------- load --
def _load_checked(path: str) -> StorePayload:
    mpath = os.path.join(path, MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) \
            or manifest.get("version") != STORE_VERSION:
        raise ValueError(
            f"expected a version-{STORE_VERSION} manifest, got "
            f"version={manifest.get('version') if isinstance(manifest, dict) else manifest!r}")
    layout = manifest.get("layout")
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown index layout {layout!r}")
    catalog = manifest["arrays"]
    expected = _LAYOUTS[layout] + ("ref",)
    missing = [n for n in expected if n not in catalog]
    if missing:
        raise ValueError(f"manifest missing arrays {missing}")

    arrays = {}
    for name in expected:
        entry = catalog[name]
        fpath = os.path.join(path, entry["file"])
        digest = _sha256(fpath)
        if digest != entry["sha256"]:
            raise ValueError(
                f"checksum mismatch on {entry['file']}: "
                f"manifest {entry['sha256'][:12]}..., file {digest[:12]}...")
        arr = np.load(fpath)
        if str(arr.dtype) != entry["dtype"] \
                or list(arr.shape) != list(entry["shape"]):
            raise ValueError(
                f"{entry['file']}: payload is {arr.dtype}{arr.shape}, "
                f"manifest says {entry['dtype']}{tuple(entry['shape'])}")
        arrays[name] = arr

    # Configs go through the constructors: a stale manifest with renamed
    # or unknown fields raises and degrades like any other defect.
    sm_config = config_from_fields(SeedMapConfig, manifest["seedmap_config"])
    pipe_cfg = config_from_fields(PipelineConfig,
                                  manifest["pipeline_config"])
    lr_raw = manifest.get("long_read_config")
    lr_cfg = (None if lr_raw is None
              else config_from_fields(LongReadConfig, lr_raw))
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if layout == "padded":
        index = PaddedSeedMap(rows=t["rows"], counts=t["counts"],
                              config=sm_config)
    else:
        index = SeedMap(offsets=t["offsets"], locations=t["locations"],
                        config=sm_config)
    ref = t["ref"]
    if arrays["ref"].dtype == np.uint32:  # packed words, held as int32
        ref = torch.from_numpy(arrays["ref"].view(np.int32))
    return StorePayload(index=index, ref=ref, pipe_cfg=pipe_cfg,
                        lr_cfg=lr_cfg, sm_config=sm_config,
                        tune_entries=dict(manifest.get("tune_entries") or {}),
                        manifest=manifest)


def load_store(path: str | os.PathLike, *,
               strict: bool = False) -> StorePayload | None:
    """Load and verify a store; any defect warns and returns ``None``.

    Verification order: manifest parse -> version -> layout -> payload
    checksums -> dtype/shape -> config reconstruction.  ``strict=True``
    raises `IndexStoreError` instead of degrading.
    """
    path = os.fspath(path)
    try:
        return _load_checked(path)
    except Exception as e:  # noqa: BLE001 — any defect degrades
        if strict:
            raise IndexStoreError(
                f"index store {path!r} failed verification: {e}") from e
        warnings.warn(
            f"ignoring unreadable index store {path!r} ({e!r}); "
            "falling back to a full index build", stacklevel=2)
        return None


def store_size_bytes(path: str | os.PathLike) -> int:
    """Total on-disk payload size (manifest + arrays) of a store."""
    path = os.fspath(path)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)
               if os.path.isfile(os.path.join(path, f)))
