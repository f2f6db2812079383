"""Hand-written Hopper kernels for the popcount reductions, bound with ctypes.

``csrc/popcount.cu`` holds the four kernels and a plain C interface.  The
first call that launches one builds it with ``nvcc`` for ``sm_90a`` into
``pilosa_tpu_torch/_build/`` (a shared library named by a hash of the
source, so an edited source rebuilds) and loads it with :mod:`ctypes`.
Nothing is built or loaded at import time: the CPU tests import every
module of the package on machines without ``nvcc``.

Each wrapper takes CUDA ``int32`` tensors (the slot list of
``selected_row_counts`` excepted: it is host data), checks device, dtype,
shape and contiguity and raises on anything else, allocates its output
with ``torch.empty``, launches on ``torch.cuda.current_stream()``, raises
if the launch was refused, and adds one to ``LAUNCHES[name]``
(under a lock: several threads launch at once).  While ``EVENTS`` is a
list, each launch also appends ``(name, start, end)``: CUDA events
recorded around it on its stream, so a caller can time the kernels of one
request.  The
routing in :mod:`pilosa_tpu_torch.engine.kernels` sends CPU tensors to the
plain PyTorch versions; nothing here falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "popcount.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches per kernel; main-path runs reset and read these
LAUNCHES = {"row_counts": 0, "selected_row_counts": 0, "count": 0,
            "intersect_count": 0}
# the same launches per (kernel, CUDA device index): a placement over
# several cards launches on each
DEVICE_LAUNCHES: dict[tuple[str, int], int] = {}
# a list: every launch appends (kernel, start event, end event); None: no
# events (the default)
EVENTS: list | None = None

_MAX_BLOCKS = (1 << 31) - 1
_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# ptxas resource report of the last build (registers, shared memory)
BUILD_LOG = ""


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        DEVICE_LAUNCHES.clear()


def launches_by_device() -> dict[int, dict[str, int]]:
    """device index -> kernel -> launches since the last reset."""
    with _count_lock:
        out: dict[int, dict[str, int]] = {}
        for (name, dev), n in DEVICE_LAUNCHES.items():
            out.setdefault(dev, dict.fromkeys(LAUNCHES, 0))[name] = n
        return dict(sorted(out.items()))


def _count(name: str, device: int) -> None:
    """One launch of ``name`` on CUDA device ``device``: serving threads,
    the batcher's collector and fast-lane callers launch at the same time,
    and ``+=`` on a shared dict entry is a read-modify-write that can lose
    counts."""
    with _count_lock:
        LAUNCHES[name] += 1
        key = (name, device)
        DEVICE_LAUNCHES[key] = DEVICE_LAUNCHES.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile ``popcount.cu`` unless a library of this exact source is
    already built; returns the library path."""
    global BUILD_LOG
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libpopcount_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_LOG = proc.stdout + proc.stderr
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            sigs = {
                "pt_row_counts": [i32, p, p, p, i64, i64, i64, p],
                "pt_selected_row_counts": [i32, p, p, p, i64, i64, i64, i64,
                                           p],
                "pt_count": [i32, p, p, i64, i64, p],
                "pt_intersect_count": [i32, p, p, p, i64, i64, p],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launch(kernel: str, fn, blocks: int, out: torch.Tensor, *args) -> None:
    """One launch of ``fn`` on the current stream of ``out``'s device,
    that device made current here and in the library (``args`` follow
    the device index; the stream comes last)."""
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{kernel}: {blocks} blocks exceed the grid limit")
    dev = out.device
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        events = EVENTS
        if events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(cur)
        err = fn(dev.index, *args, cur.cuda_stream)
        if err != 0:
            raise RuntimeError(f"{kernel}: launch on {dev} failed with CUDA "
                               f"error {err}")
        if events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(cur)
            events.append((kernel, start, end))
    _count(kernel, dev.index)


def _same_device(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"{name}: tensors on {a.device} and {b.device}")


def row_counts(plane: torch.Tensor,
               filter_words: torch.Tensor | None = None) -> torch.Tensor:
    """int32[S, R, W] (& int32[S, W]) -> int32[S, R] per-row popcounts."""
    _check("row_counts plane", plane, 3)
    s, r, w = plane.shape
    fptr = None
    if filter_words is not None:
        _check("row_counts filter", filter_words, 2)
        _same_device("row_counts", plane, filter_words)
        if tuple(filter_words.shape) != (s, w):
            raise ValueError(f"row_counts: filter shape "
                             f"{tuple(filter_words.shape)} != {(s, w)}")
        fptr = filter_words.data_ptr()
    out = torch.empty((s, r), dtype=torch.int32, device=plane.device)
    if out.numel():
        _launch("row_counts", _load().pt_row_counts, s * r, out,
                plane.data_ptr(), fptr, out.data_ptr(), s, r, w)
    return out


def selected_row_counts(plane: torch.Tensor,
                        row_idx: torch.Tensor) -> torch.Tensor:
    """int32[S, R, W] + int32[N] slots -> int32[S, N].  Slots may repeat.
    ``row_idx`` is a CPU tensor (the executor resolves slots on the
    host): it is checked there, a slot outside [0, R) raises, and it
    reaches the card by an asynchronous copy from pinned memory, so the
    check costs no device synchronization."""
    _check("selected_row_counts plane", plane, 3)
    if not isinstance(row_idx, torch.Tensor) or row_idx.device.type != "cpu":
        raise ValueError("selected_row_counts: slot indices must be a CPU "
                         "tensor")
    if row_idx.dtype != torch.int32 or row_idx.dim() != 1:
        raise TypeError("selected_row_counts: slot indices must be int32[N]")
    s, r, w = plane.shape
    n = row_idx.shape[0]
    if n and (int(row_idx.min()) < 0 or int(row_idx.max()) >= r):
        raise IndexError(f"selected_row_counts: slots "
                         f"[{int(row_idx.min())}, {int(row_idx.max())}] "
                         f"outside [0, {r})")
    out = torch.empty((s, n), dtype=torch.int32, device=plane.device)
    if out.numel():
        # the copy runs on the current stream of the plane's device, the
        # stream the kernel launches on
        idx = row_idx.contiguous().pin_memory().to(plane.device,
                                                  non_blocking=True)
        _launch("selected_row_counts", _load().pt_selected_row_counts,
                s * n, out, plane.data_ptr(), idx.data_ptr(),
                out.data_ptr(), s, r, w, n)
    return out


def count(words: torch.Tensor) -> torch.Tensor:
    """int32[S, W] -> int32[S] whole-bitmap popcount per shard."""
    _check("count", words, 2)
    s, w = words.shape
    out = torch.empty((s,), dtype=torch.int32, device=words.device)
    if s:
        _launch("count", _load().pt_count, s, out, words.data_ptr(),
                out.data_ptr(), s, w)
    return out


def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32[S, W] x2 -> int32[S] = popcount(a & b) per shard, one pass."""
    _check("intersect_count a", a, 2)
    _check("intersect_count b", b, 2)
    _same_device("intersect_count", a, b)
    if a.shape != b.shape:
        raise ValueError(f"intersect_count: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    s, w = a.shape
    out = torch.empty((s,), dtype=torch.int32, device=a.device)
    if s:
        _launch("intersect_count", _load().pt_intersect_count, s, out,
                a.data_ptr(), b.data_ptr(), out.data_ptr(), s, w)
    return out
