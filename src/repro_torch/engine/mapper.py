"""The `Mapper` session: device-resident index + reference, built once.

``Mapper.build`` (reference -> index -> session) and ``Mapper.from_index``
(existing index -> session) resolve, exactly once, the kernel backend,
the ``packed_ref`` flavor (2-bit packing the reference on the device), the
reference padded for the window kernels and the SeedMap layout the step
consumes: the CSR map on the staged plain path, the bucket-major
`PaddedSeedMap` for the CUDA front end, this rank's shard of the
bucket-sharded map on the sharded-index mesh plan.

``mapper.map`` maps one batch of read pairs and ``mapper.map_long`` one
batch of long reads (the lane config is resolved at build, too);
``map_stream`` / ``map_long_stream`` stream batches with device-side stage
totals and one host sync at the end.  ``mapper.save`` / ``Mapper.load``
round-trip the resolved session through an index store
(`engine.index_store`), and ``mapper.swap_index`` replaces the index a
live session serves.  All are eager launches on PyTorch's
current stream, but for a full batch of ``map_stream`` on one card
through the kernels, which replays a CUDA graph of the same step
(`engine.graph`).  On a mesh (`ExecutionConfig.mesh`) every rank is handed
the same global batch, maps its rows of the data axis and all_gathers the
result, so each call returns the global result on every rank.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from repro_torch.core.distributed import RowSplit, shard_seedmap
from repro_torch.core.encoding import BASES_PER_WORD, pack_2bit, unpack_2bit
from repro_torch.core.genpairx_step import make_genpair_serve_step
from repro_torch.core.long_read import (
    LongReadResult,
    long_stage_stat_counts,
    map_long_impl,
)
from repro_torch.core.pipeline import (
    MapResult,
    PipelineConfig,
    map_pairs_impl,
    stage_stat_counts,
)
from repro_torch.core.seedmap import (
    PaddedSeedMap,
    SeedMap,
    SeedMapConfig,
    build_seedmap,
    to_padded,
)
from repro_torch.engine import spans
from repro_torch.engine.config import (
    ExecutionConfig,
    resolved_long_read,
    resolved_pipeline,
)
from repro_torch.engine.graph import StepGraphs
from repro_torch.engine.index_store import (
    IndexStoreError,
    StorePayload,
    load_store,
    save_store,
)
from repro_torch.engine.stats import (
    LONG_STAT_KEYS,
    STAT_KEYS,
    add_stage_counts,
    fetch_stage_totals,
    init_stage_totals,
    stage_count_vector,
)
from repro_torch.engine.stream import (
    StreamResult,
    pad_tail,
    run_stream,
    split_batch,
    to_device,
)
from repro_torch.kernels._util import kernel_reference
from repro_torch.tree import tree_map


def _as_device(x, device: torch.device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _mask_tail(res, n):
    """Set a step result's ``n_valid``: its first ``n`` rows are real, or
    the rows a (B,) bool tensor ``n`` marks (a fleet stream pads each
    host's rows inside the batch, `engine.multihost`)."""
    valid = res.n_valid
    if isinstance(n, torch.Tensor):
        return res._replace(n_valid=n.to(valid.device))
    return res._replace(
        n_valid=torch.arange(valid.shape[0], device=valid.device) < n)


class Mapper:
    """A reusable mapping session for read pairs and long reads (index +
    resolved configs).

    Use :meth:`build` / :meth:`from_index`.
    """

    def __init__(self, *, index, ref: torch.Tensor, pipe_cfg: PipelineConfig,
                 exec_cfg: ExecutionConfig, device: torch.device,
                 backend: str, sm_config: SeedMapConfig,
                 tune_entries: dict | None = None):
        self.index = index           # SeedMap | PaddedSeedMap | SeedMapShard
        self.ref = ref               # uint8 bases or int32 packed words
        self.pipe_cfg = pipe_cfg     # fully resolved
        self.exec_cfg = exec_cfg
        self.device = device
        self.backend = backend       # "cuda" or "torch"
        self.sm_config = sm_config   # the config of the index it was given
        self.kref = self._kernel_ref(ref)
        # the tune-cache entries the session resolved with (or its store's
        # snapshot, `load`), written by `save`
        self._tune_entries: dict = dict(tune_entries or {})
        mesh = exec_cfg.mesh
        # this rank's rows of each global batch (None: one device)
        self._split = (None if mesh is None else
                       RowSplit.from_mesh(mesh, exec_cfg.batch_axes[0]))
        self._serve = None           # the sharded-index serve step
        self.lr_cfg = None           # the long-read lane (not when sharded)
        if exec_cfg.shard_index:
            self._serve = make_genpair_serve_step(
                mesh, pipe_cfg, index.config, backend, exec_cfg.batch_axes,
                exec_cfg.model_axis, self.kref)
        else:
            self.lr_cfg = resolved_long_read(pipe_cfg, exec_cfg,
                                             self._tune_entries)
        # the pair stream's ring slots and step graphs: one card, kernels
        self._graphs = (StepGraphs(device) if device.type == "cuda"
                        and backend == "cuda" and self._serve is None
                        and self._split is None else None)

    def _kernel_ref(self, ref: torch.Tensor):
        """The reference padded once for both window kernels (CUDA only)."""
        if self.backend != "cuda":
            return None
        cfg = self.pipe_cfg
        width = cfg.read_len + 2 * max(cfg.max_gap, cfg.dp_pad)
        return kernel_reference(ref, width, cfg.packed_ref)

    # ------------------------------------------------------------ build --
    @classmethod
    def build(cls, ref, seedmap_cfg: SeedMapConfig | None = None,
              pipe_cfg: PipelineConfig | None = None,
              exec_cfg: ExecutionConfig | None = None) -> "Mapper":
        """Offline stage + session build: index ``ref`` on the session's
        device and resolve."""
        exec_cfg = exec_cfg or ExecutionConfig()
        device = exec_cfg.torch_device()
        ref = _as_device(ref, device, torch.uint8)
        sm = build_seedmap(ref, seedmap_cfg or SeedMapConfig())
        return cls.from_index(sm, ref, pipe_cfg, exec_cfg)

    @classmethod
    def from_index(cls, sm: SeedMap | PaddedSeedMap, ref,
                   pipe_cfg: PipelineConfig | None = None,
                   exec_cfg: ExecutionConfig | None = None) -> "Mapper":
        """Build a session from an existing index and the (L,) uint8
        reference (or, for a packed session, its int32 2-bit packing).

        A `PaddedSeedMap` is taken as-is and its row width becomes the
        session's ``max_locs_per_seed``.  The sharded-index plan
        (``shard_index=True``) takes a CSR `SeedMap`, splits it by bucket
        range over the mesh's model axis on the host and keeps this rank's
        shard on its device.

        The tune cache (`ExecutionConfig.tune`) is read here, once; its
        winners fill only the knobs the configs left unset.
        """
        from repro_torch.tune import session_cache
        exec_cfg = exec_cfg or ExecutionConfig()
        device = exec_cfg.torch_device()
        tune_cache = session_cache(exec_cfg.tune)
        cfg, backend = resolved_pipeline(pipe_cfg or PipelineConfig(),
                                         exec_cfg, tune_cache)
        packed_in = isinstance(ref, torch.Tensor) and ref.dtype == torch.int32
        ref = _as_device(ref, device, torch.int32 if packed_in
                         else torch.uint8)
        if exec_cfg.shard_index:
            if not isinstance(sm, SeedMap):
                raise TypeError("shard_index requires a CSR SeedMap")
            words = ref if packed_in else pack_2bit(ref)
            ref_arr = words if cfg.packed_ref else unpack_2bit(
                words, words.shape[0] * BASES_PER_WORD)
            mesh, axis = exec_cfg.mesh, exec_cfg.model_axis
            ssm = shard_seedmap(sm, mesh.shape[mesh.mesh_dim_names.index(axis)])
            index = ssm.shard(mesh.get_local_rank(axis), device)
            return cls(index=index, ref=ref_arr, pipe_cfg=cfg,
                       exec_cfg=exec_cfg, device=device, backend=backend,
                       sm_config=sm.config, tune_entries=tune_cache)
        if cfg.packed_ref:
            ref_arr = ref if packed_in else pack_2bit(ref)
        elif packed_in:
            raise ValueError("packed_ref resolved False but ref holds packed "
                             "words; pass the uint8 base array")
        else:
            ref_arr = ref
        sm = type(sm)(*(_as_device(x, device, x.dtype)
                        if isinstance(x, torch.Tensor) else x for x in sm))
        if isinstance(sm, PaddedSeedMap):
            cap = int(sm.rows.shape[1])
            if cap != cfg.max_locs_per_seed:
                cfg = dataclasses.replace(cfg, max_locs_per_seed=cap)
            index = sm
        elif backend == "torch":
            index = sm            # the staged plain path queries the CSR map
        else:
            index = to_padded(sm, cap=cfg.max_locs_per_seed)
        return cls(index=index, ref=ref_arr, pipe_cfg=cfg, exec_cfg=exec_cfg,
                   device=device, backend=backend, sm_config=sm.config,
                   tune_entries=tune_cache)

    # ----------------------------------------------------- index store ---
    def save(self, path) -> str:
        """Persist the resolved session to an index store at ``path``
        (`engine.index_store`): the resolved reference flavor, SeedMap
        layout and configs.  ``Mapper.load`` rebuilds an identical session
        from it without calling `build_seedmap`.  Returns the manifest
        path."""
        if self.exec_cfg.shard_index:
            raise NotImplementedError(
                "saving a shard_index session is not supported; save a "
                "replicated-plan session (CSR layout) and load the store "
                "into the sharded ExecutionConfig instead")
        return save_store(path, index=self.index, ref=self.ref,
                          pipe_cfg=self.pipe_cfg, sm_config=self.sm_config,
                          lr_cfg=self.lr_cfg,
                          tune_entries=self._tune_entries)

    @classmethod
    def load(cls, path, exec_cfg: ExecutionConfig | None = None, *,
             fallback_ref=None, seedmap_cfg: SeedMapConfig | None = None,
             pipe_cfg: PipelineConfig | None = None) -> "Mapper":
        """Cold-start a session from a saved index store, with no index
        build.

        The store's configs are already resolved, so the session maps
        exactly as the one that saved it.  ``exec_cfg`` supplies the
        execution side (device, stream batch, mesh); its ``tune=None`` is
        forced to False (pass an explicit ``tune`` to fill the store's
        unset knobs from a cache), and with ``long_read`` None it adopts
        the store's lane config.  The session keeps the store's tune-cache
        snapshot, never applied, for `save`.  An unreadable store warns
        and degrades to ``Mapper.build(fallback_ref, seedmap_cfg,
        pipe_cfg, exec_cfg)``; with no ``fallback_ref`` it raises
        `IndexStoreError`, as there is nothing to build from.
        """
        payload = load_store(path)
        if payload is None:
            if fallback_ref is None:
                raise IndexStoreError(
                    f"index store {os.fspath(path)!r} is unreadable and "
                    "no fallback_ref was provided to rebuild from")
            warnings.warn(
                f"index store {os.fspath(path)!r} unreadable; rebuilding "
                "the session from the reference", stacklevel=2)
            return cls.build(fallback_ref, seedmap_cfg, pipe_cfg, exec_cfg)
        exec_cfg = exec_cfg or ExecutionConfig()
        if exec_cfg.tune is None:
            exec_cfg = dataclasses.replace(exec_cfg, tune=False)
        if exec_cfg.long_read is None and payload.lr_cfg is not None \
                and not exec_cfg.shard_index:
            exec_cfg = dataclasses.replace(exec_cfg,
                                           long_read=payload.lr_cfg)
        mapper = cls.from_index(payload.index, payload.ref,
                                payload.pipe_cfg, exec_cfg)
        mapper._tune_entries = dict(payload.tune_entries)
        return mapper

    def swap_index(self, store, *, strict: bool = False) -> str:
        """Replace the index this session serves with a saved store's.

        Call it between dispatches.  A store with the same resolved
        configs and the same array shapes and dtypes replaces ``index``,
        ``ref`` and the kernels' padded reference ``kref`` with the
        store's, on the session's device: ``"reused"``.  Any other store
        re-runs `from_index` in place with a warning: ``"rebuilt"``.  An
        unreadable store warns and keeps the index already served:
        ``"kept"``.  ``store`` is a path or a loaded `StorePayload`.
        """
        if self.exec_cfg.shard_index:
            raise NotImplementedError(
                "swap_index is not supported on shard_index sessions")
        payload = (store if isinstance(store, StorePayload)
                   else load_store(store, strict=strict))
        if payload is None:
            warnings.warn("swap_index: unreadable store; keeping the "
                          "index already being served", stacklevel=2)
            return "kept"
        old = (*self.index[:-1], self.ref)
        new = (*payload.index[:-1], payload.ref)
        same = (payload.pipe_cfg == self.pipe_cfg
                and payload.sm_config == self.sm_config
                and payload.lr_cfg == self.lr_cfg
                and type(payload.index) is type(self.index)
                and all(o.shape == n.shape and o.dtype == n.dtype
                        for o, n in zip(old, new)))
        if same:
            index = type(payload.index)(
                *(x.to(self.device) for x in payload.index[:-1]),
                self.index.config)
            ref = payload.ref.to(self.device)
            self.index, self.ref, self.kref = index, ref, self._kernel_ref(ref)
            if self._graphs is not None:
                self._graphs.forget()
            return "reused"
        warnings.warn(
            "swap_index: store differs in shape or config from the live "
            "session; rebuilding in place", stacklevel=2)
        exec_cfg = self.exec_cfg
        if exec_cfg.tune is None:
            exec_cfg = dataclasses.replace(exec_cfg, tune=False)
        if payload.lr_cfg is not None:
            exec_cfg = dataclasses.replace(exec_cfg,
                                           long_read=payload.lr_cfg)
        fresh = Mapper.from_index(payload.index, payload.ref,
                                  payload.pipe_cfg, exec_cfg)
        fresh._tune_entries = dict(payload.tune_entries)
        self.__dict__.update(fresh.__dict__)
        return "rebuilt"

    # ------------------------------------------------------------- run ---
    def _step(self, reads1: torch.Tensor, reads2: torch.Tensor,
              n) -> MapResult:
        """Map a batch whose first ``n`` rows are real.  On a mesh every
        rank is handed the global batch and returns the global result."""
        if self._serve is not None:
            res = self._serve(self.index, self.ref, reads1, reads2)
        else:
            res = map_pairs_impl(self.index, self.ref, reads1, reads2,
                                 self.pipe_cfg, self.backend, self.kref,
                                 self._split)
        return _mask_tail(res, n)

    def _counted_step(self, reads1: torch.Tensor, reads2: torch.Tensor):
        """`_step` of a batch whose every row is real, and its stage
        counts as one vector: what a step graph records."""
        res = self._step(reads1, reads2, reads1.shape[0])
        return res, stage_count_vector(stage_stat_counts(res), STAT_KEYS)

    def _long_step(self, reads: torch.Tensor, n) -> LongReadResult:
        """`_step` for long reads: each read maps on its own, so on a mesh
        this rank maps its rows and all_gathers the result."""
        split = self._split
        res = map_long_impl(self.index, self.ref,
                            reads if split is None else split.rows(reads),
                            self.lr_cfg, self.backend)
        if split is not None:
            res = type(res)(*split.gather(res))
        return _mask_tail(res, n)

    def _need_long_lane(self) -> None:
        if self.lr_cfg is None:
            raise NotImplementedError(
                "the long-read lane is not available on shard_index "
                "sessions; build a replicated-index Mapper for map_long")

    def map(self, reads1, reads2) -> MapResult:
        """Map one batch of FR read pairs (``reads2`` as sequenced)."""
        reads1 = _as_device(reads1, self.device, torch.uint8)
        reads2 = _as_device(reads2, self.device, torch.uint8)
        return self._step(reads1, reads2, reads1.shape[0])

    def map_long(self, reads) -> LongReadResult:
        """Map one batch of (B, L) uint8 long reads in reference
        orientation, under the session's lane config (``self.lr_cfg``)."""
        self._need_long_lane()
        reads = _as_device(reads, self.device, torch.uint8)
        return self._long_step(reads, reads.shape[0])

    # ---------------------------------------------------------- stream ---
    #: per lane: (step method, stage counts, stat keys, read arrays per
    #: batch item)
    _LANES = {
        "pairs": ("_step", stage_stat_counts, STAT_KEYS, 2),
        "long": ("_long_step", long_stage_stat_counts, LONG_STAT_KEYS, 1),
    }

    def _stream(self, lane, batches, on_result, reduce_fn, reduce_init,
                warmup_batch) -> StreamResult:
        """The lane-generic stream body behind `map_stream` and
        `map_long_stream`: warmup, tail padding, per-batch stage totals on
        the device and the one fetch at the end, under the stream's
        `spans.StreamTrace`.  On the pair lane of a session with
        `StepGraphs`, a full batch in a ring slot replays the slot's
        graph, captured after the slot's first full batch ran eagerly."""
        step_name, counts_fn, keys, n_arrays = self._LANES[lane]
        step = getattr(self, step_name)
        stream_batch = self.exec_cfg.stream_batch
        dev = self.device
        totals = init_stage_totals(dev, keys)
        reduced = reduce_init
        if warmup_batch is not None:
            reads, _ = split_batch(warmup_batch, n_arrays)
            if stream_batch is None:
                stream_batch = int(np.shape(reads[0])[0])
            step(*(to_device(pad_tail(r, stream_batch), dev) for r in reads),
                 stream_batch)
        trace = spans.StreamTrace(dev)

        def dispatch(*args):
            nonlocal reduced
            *reads, n, aux = args
            # looked up a batch: a swap_index that rebuilds the session
            # mid-stream leaves the ring's slots to graphs of the old index
            graphs = self._graphs if lane == "pairs" else None
            s = graph = None
            if graphs is not None and isinstance(n, int) and \
                    n == reads[0].shape[0]:
                s = graphs.find(reads)
                graph = None if s is None else graphs.graphs[s]
            with trace.spans["step"]:
                if graph is None:
                    res = step(*reads, n)
                else:
                    res, counts = graph.replay()
            trace.step_end()
            if lane == "long":
                segs = self.lr_cfg.n_segments(reads[0].shape[-1])
                trace.pseudo_pairs += n * (segs - 1)
            with trace.spans["stream.counts"]:
                if graph is None:
                    add_stage_counts(totals, counts_fn(res), keys)
                else:
                    totals.add_(counts)
            if graph is not None:
                trace.graph_replays += 1
            elif s is not None:
                graphs.capture(s, lambda: self._counted_step(*reads))
                trace.graph_captures += 1
            if reduce_fn is not None:
                reduced = reduce_fn(reduced, res,
                                    tree_map(lambda a: to_device(a, dev),
                                             aux))
            return res

        def drain():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return fetch_stage_totals(totals, keys)

        with trace:
            n_items, n_batches, seconds, fetched = run_stream(
                dispatch, batches, trace, dev, stream_batch=stream_batch,
                on_result=on_result, drain=drain, n_arrays=n_arrays,
                slots=self._graphs if lane == "pairs" else None)
        return StreamResult(n_pairs=n_items, n_batches=n_batches,
                            seconds=seconds, totals=fetched,
                            reduced=reduced, reads_per_item=n_arrays,
                            trace=trace.summary)

    def map_stream(self, batches, on_result=None, reduce_fn=None,
                   reduce_init=None, warmup_batch=None) -> StreamResult:
        """Stream ``(reads1, reads2[, aux])`` host batches through the
        session.

        A ragged tail batch is zero-padded to the stream shape and its
        padded rows are masked through ``MapResult.n_valid``; they count
        toward no stage total.  ``reduce_fn(state, res, aux) -> state``
        runs after each batch (it must mask by ``res.n_valid``).
        ``warmup_batch`` runs once before the timed stream (it fixes the
        stream shape when ``stream_batch`` is unset).  ``on_result(idx,
        res, n_valid)`` sees each result one batch late.
        """
        return self._stream("pairs", batches, on_result, reduce_fn,
                            reduce_init, warmup_batch)

    def map_long_stream(self, batches, on_result=None, reduce_fn=None,
                        reduce_init=None, warmup_batch=None) -> StreamResult:
        """Stream ``(reads[, aux])`` long-read host batches through the
        session: `map_stream`'s contract with one read array per item,
        `LongReadResult` batches (tail rows masked through ``n_valid``)
        and the lane's LONG_STAT_KEYS totals."""
        self._need_long_lane()
        return self._stream("long", batches, on_result, reduce_fn,
                            reduce_init, warmup_batch)
