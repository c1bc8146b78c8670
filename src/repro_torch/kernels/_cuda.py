"""Build, load and launch the hand-written CUDA kernels.

All ``repro_torch/csrc/*.cu`` sources compile with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together) and link
into one shared library with a plain C interface, loaded with `ctypes`.
The build runs at the first launch in a process, into
``build/repro_torch/<hash>/`` at the repository root, keyed by a content
hash of the sources and flags, so each source version builds once and a
second process loads the library the first one built.  A failed build
raises with nvcc's output; nothing falls back to a plain version.

Every kernel is a `Kernel` in `KERNELS`: calling it launches on the
caller's stream, raises on a non-zero ``cudaGetLastError()`` and adds one
to its plain-integer ``launches`` count (and, for a kernel with more than
one path, to that path's count in ``paths``).  Each `Kernel` carries its
cost function: the HBM bytes and operations of a launch as a function of
its shapes (`Work`), the formula behind the bound of every kernel in
``chip_smoke.py`` and the kernel's share of a dry run's counts.

A launch is the one place that turns tensors into pointers.  Under
`dry_run_launches` (`repro_torch.launch.dryrun`'s context) a launch on
fake tensors records its `Work` and launches nothing; anywhere else a
fake tensor that reaches a launch raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

# ctypes argument shorthands: every pointer and the stream are c_void_p
PTR, INT, U32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                           ctypes.c_longlong, ctypes.c_float)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _build(final: Path) -> None:
    """Compile every source in parallel, link, and move the result into
    ``final`` atomically (a concurrent build's result wins)."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    try:
        nvcc = nvcc_path()
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                 *(str(tmp / (s.stem + ".o")) for s in _sources())],
                capture_output=True, text=True)
            log.append(f"== link (rc {link.returncode})\n"
                       f"{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(log))
        try:
            os.rename(tmp, final)
        except OSError:
            if not (final / LIB_NAME).exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            final = build_dir()
            if not (final / LIB_NAME).exists():
                _build(final)
            lib = ctypes.CDLL(str(final / LIB_NAME))
            lib.repro_cuda_error_string.argtypes = [INT]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (ptxas register and shared-memory use per kernel)."""
    library()
    return (build_dir() / "build.log").read_text()


class Work(NamedTuple):
    """The work of one launch: HBM bytes (each input read once, each output
    written once) and operations of ``unit`` (a key of
    `repro_torch.roofline.PEAKS`: "int32", "bfloat16", "float32")."""

    bytes: float
    ops: float
    unit: str = "int32"


# the dry run active in this thread (context): (record(kernel name, Work),
# whether fake tensors on any device take the kernel route), or None
_DRY: contextvars.ContextVar[tuple[Callable, bool] | None] = \
    contextvars.ContextVar("repro_torch_dry_run", default=None)


@contextlib.contextmanager
def dry_run_launches(record: Callable[[str, Work], None],
                     route_kernels: bool = False):
    """Within the block, and in this thread only, a launch on fake tensors
    calls ``record(name, work)`` and launches nothing.  ``route_kernels``:
    fake tensors on the CPU take the kernel route too (`routes_kernels`),
    so that a dry run on the CPU counts the work the card's kernels would
    do."""
    token = _DRY.set((record, route_kernels))
    try:
        yield
    finally:
        _DRY.reset(token)


def routes_kernels() -> bool:
    """Whether this thread's dry run sends fake tensors of any device down
    the kernel route (`kernels.backend.resolve_backend`, `check`)."""
    dry = _DRY.get()
    return dry is not None and dry[1]


def pointers(args) -> list | None:
    """A launch's C arguments: a tensor as its data pointer, None as a
    null pointer, any other value as it is; None where a fake tensor is
    among them.  (``type() is``: an isinstance test of FakeTensor costs
    more than the data_ptr() call.)"""
    ptrs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if type(a) is FakeTensor:
                return None
            a = a.data_ptr()
        ptrs.append(a)
    return ptrs


class Kernel:
    """One C entry point of the library, its launch count, its launches by
    path (``paths``: the path's name -> launches, for a kernel whose
    wrapper names one) and its cost function (``cost(*work) -> Work``)."""

    def __init__(self, name: str, symbol: str, argtypes: tuple,
                 cost: Callable[..., Work]):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.cost = cost
        self.launches = 0
        self.paths: dict[str, int] = {}

    def __call__(self, *args, stream: torch.Tensor, work: tuple,
                 path: str | None = None) -> None:
        """Launch on ``stream``'s device's current stream.  A tensor
        argument passes as its data pointer, None as a null pointer, any
        other value as it is (`pointers`); ``work`` are the cost
        function's arguments, ``path`` the path the launch takes."""
        ptrs = pointers(args)
        if ptrs is None or type(stream) is FakeTensor:
            return self._fake_launch(work)
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = list(self.argtypes)
        fn.restype = INT
        err = fn(*ptrs, stream_of(stream))
        if err != 0:
            msg = lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"{msg} (error {err})")
        self.launches += 1
        if path is not None:
            self.paths[path] = self.paths.get(path, 0) + 1

    def _fake_launch(self, work: tuple) -> None:
        dry = _DRY.get()
        if dry is None:
            raise RuntimeError(
                f"a fake tensor reached the launch of CUDA kernel "
                f"{self.name} outside a dry run "
                f"(repro_torch.launch.dryrun); nothing was launched")
        dry[0](self.name, self.cost(*work))


#: every kernel of the package, by name (registered by the ops modules)
KERNELS: dict[str, Kernel] = {}


def register(name: str, symbol: str, argtypes: tuple,
             cost: Callable[..., Work]) -> Kernel:
    k = KERNELS[name] = Kernel(name, symbol, argtypes, cost)
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.paths.clear()


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


@contextlib.contextmanager
def recorded_launches(out: dict):
    """Within the block launches are recorded, not counted: a CUDA graph's
    capture enqueues no work.  On exit every kernel's ``launches`` and
    ``paths`` are as they were before the block, and ``out`` maps each
    kernel that launched in it to ``(launches, {path: launches})``;
    `count_launches` adds those each time a replay runs them."""
    before = {name: (k.launches, dict(k.paths))
              for name, k in KERNELS.items()}
    try:
        yield out
    finally:
        for name, k in KERNELS.items():
            n0, p0 = before.get(name, (0, {}))
            paths = {p: c - p0.get(p, 0) for p, c in k.paths.items()
                     if c != p0.get(p, 0)}
            if k.launches != n0 or paths:
                out[name] = (k.launches - n0, paths)
            k.launches, k.paths = n0, p0


def count_launches(recorded: dict) -> None:
    """Add a recorded block's launches (`recorded_launches`) to each
    kernel's counts, as its launches would have: a graph replay launches
    them without a call."""
    for name, (n, paths) in recorded.items():
        k = KERNELS[name]
        k.launches += n
        for p, c in paths.items():
            k.paths[p] = k.paths.get(p, 0) + c


class TimingEvents:
    """The library's events (``csrc/markers.cu``) as plain calls: an event
    is an integer handle, made on a device and freed with `destroy`; a
    stream is a ``cudaStream_t`` as an integer.  A CUDA error raises.  One
    C call each, a few microseconds of host where ``torch.cuda.Event``
    spends 3-10 (the marker path of `engine.spans` runs five records and
    one read a marked batch, the copy ring of `engine.stream` two records
    and two waits every batch)."""

    NOT_READY = 600          # cudaErrorNotReady

    def __init__(self):
        lib = library()
        sigs = {"repro_event_create": [INT, ctypes.POINTER(PTR)],
                "repro_event_destroy": [PTR],
                "repro_event_record": [PTR, PTR],
                "repro_stream_wait": [PTR, PTR],
                "repro_event_synchronize": [PTR],
                "repro_marker_times": [PTR] * 7,
                "repro_event_elapsed": [PTR, PTR, PTR]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, INT
        self._lib = lib
        self._record = lib.repro_event_record
        self._wait = lib.repro_stream_wait
        self._times = lib.repro_marker_times
        self._out = (ctypes.c_float * 4)()
        self._out_p = ctypes.cast(self._out, PTR)

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"CUDA {what} failed: {msg} (error {err})")

    def create(self, device: int) -> int:
        ev = PTR()
        self._check(self._lib.repro_event_create(device, ctypes.byref(ev)),
                    "event create")
        return ev.value

    def destroy(self, ev: int) -> None:
        self._check(self._lib.repro_event_destroy(ev), "event destroy")

    def record(self, ev: int, stream: int) -> None:
        err = self._record(ev, stream)
        if err:
            self._check(err, "event record")

    def wait(self, stream: int, ev: int) -> None:
        """``stream`` runs what is enqueued on it from now on only after
        ``ev`` ran."""
        err = self._wait(stream, ev)
        if err:
            self._check(err, "stream wait")

    def synchronize(self, ev: int) -> None:
        self._check(self._lib.repro_event_synchronize(ev),
                    "event synchronize")

    def times(self, prev: int, m0: int, m1: int, r: int, s: int, m2: int):
        """ms from ``prev`` to ``m0``, ``m0`` to ``m1``, ``r`` to ``s`` and
        ``s`` to ``m2`` once ``m2`` ran, else None."""
        err = self._times(prev, m0, m1, r, s, m2, self._out_p)
        if err == self.NOT_READY:
            return None
        if err:
            self._check(err, "marker read")
        out = self._out
        return out[0], out[1], out[2], out[3]

    def elapsed(self, a: int, b: int) -> float:
        """ms from ``a`` to ``b``, both of which ran."""
        out = ctypes.c_float()
        self._check(self._lib.repro_event_elapsed(a, b, ctypes.byref(out)),
                    "event elapsed")
        return out.value


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t, n: int) -> bool:
    """Whether ``t``'s first element sits on an ``n``-byte boundary (a fake
    tensor's storage starts aligned, as the caching allocator's blocks
    do)."""
    if type(t) is FakeTensor:
        return t.storage_offset() * t.element_size() % n == 0
    return t.data_ptr() % n == 0


def int_array(values) -> ctypes.Array:
    """A host int32 array, passed to a ``c_void_p`` launcher argument."""
    return (ctypes.c_int * len(values))(*values)


def check(t, name: str, dtype, shape: tuple | None = None) -> None:
    """Validate a kernel input: CUDA (or a fake tensor of a dry run that
    takes the kernel route), dtype, shape and contiguity."""
    if not t.is_cuda and not (isinstance(t, FakeTensor) and routes_kernels()):
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
