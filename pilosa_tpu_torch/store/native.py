"""The native roaring codec (``csrc/roaring_codec.cpp``), bound with ctypes.

The first call builds the source with ``g++`` into
``pilosa_tpu_torch/_build/`` (a shared library named by a hash of the
source, so an edited source rebuilds) and loads it with
:class:`ctypes.CDLL`, which releases the interpreter lock for the whole
of each call: builder threads expanding different fragments run at once.
Nothing is built or loaded at import time.  A build or load failure
raises; there is no Python fallback and no switch.  The numpy codec in
:mod:`pilosa_tpu_torch.store.roaring` (``_serialize_plain``,
``_deserialize_plain``) is the plain version the tests hold this one to.

The wrappers are ``pilosa_tpu.store.native``'s, with the same argument
checks and the same ``ValueError`` texts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "roaring_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
# native/Makefile's flags
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")

_ERRORS = {-1: "truncated buffer", -2: "bad magic/version",
           -3: "bad container type", -4: "output buffer too small",
           -5: "positions not sorted/unique"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("g++ not found: the native roaring codec cannot "
                           "be built")
    return path


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile ``source`` unless a library of its exact bytes is already
    built; returns the library path."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(build_dir, f"libroaring_codec_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    # several processes may build at once: each writes its own file and
    # the rename is atomic
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    size = ctypes.c_size_t
    sigs = {
        "rc_cardinality": [u8p, size],
        "rc_deserialize": [u8p, size, u64p, size],
        "rc_serialize": [u64p, size, u8p, size],
        "rc_serialized_bound": [u64p, size],
        "rc_expand_plane": [u8p, size, ctypes.c_uint64, u64p, size, u32p,
                            size],
        "rc_expand_rows_into": [u8p, size, ctypes.c_uint64, u64p, u64p,
                                size, u32p, size, size],
        # bare addresses (see _addr): the row-write path unions many tiny
        # chunks, where a typed pointer cast costs more than the merge
        "rc_union_u32": [ctypes.c_void_p, size, ctypes.c_void_p, size,
                         ctypes.c_void_p],
        "rc_diff_u32": [ctypes.c_void_p, size, ctypes.c_void_p, size,
                        ctypes.c_void_p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def lib() -> ctypes.CDLL:
    """The loaded codec, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(build())
    return _lib


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise ValueError(
            f"native codec {what}: {_ERRORS.get(rc, f'error {rc}')}")
    return rc


def _u8(buf):
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr


def _p64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def deserialize(buf) -> np.ndarray:
    """Pilosa-format bytes (any buffer) -> uint64 positions in container
    order (sorted for every writer's blob)."""
    ptr, keep = _u8(buf)
    L = lib()
    card = _check(L.rc_cardinality(ptr, len(keep)), "cardinality")
    out = np.empty(card, dtype=np.uint64)
    got = _check(L.rc_deserialize(ptr, len(keep), _p64(out), card),
                 "deserialize")
    return out[:got]


def serialize(positions: np.ndarray) -> bytes:
    """Sorted unique uint64 positions -> pilosa-format bytes."""
    positions = np.ascontiguousarray(positions, dtype=np.uint64)
    L = lib()
    p64 = _p64(positions)
    bound = _check(L.rc_serialized_bound(p64, len(positions)), "bound")
    out = np.empty(bound, dtype=np.uint8)
    n = _check(L.rc_serialize(
        p64, len(positions),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bound),
        "serialize")
    return out[:n].tobytes()


def expand_plane(buf, row_width: int, row_slots: np.ndarray,
                 plane: np.ndarray) -> int:
    """Expand a fragment blob into a zeroed dense plane
    ``uint32[n_rows, words_per_row]``; ``row_slots`` holds the sorted row
    ids of the plane's rows.  Returns bits set."""
    ptr, keep = _u8(buf)
    row_slots = np.ascontiguousarray(row_slots, dtype=np.uint64)
    if plane.dtype != np.uint32 or not plane.flags.c_contiguous:
        raise ValueError("plane must be C-contiguous uint32")
    return _check(lib().rc_expand_plane(
        ptr, len(keep), row_width, _p64(row_slots), len(row_slots),
        plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        plane.shape[-1]), "expand_plane")


def expand_rows_into(buf, row_width: int, row_ids: np.ndarray,
                     slots: np.ndarray, plane: np.ndarray) -> int:
    """OR the blob's row ``row_ids[i]`` (sorted ascending) into
    ``plane[slots[i]]`` (``uint32[n_rows, words_per_row]``); rows absent
    from ``row_ids`` are skipped.  Returns bits set."""
    ptr, keep = _u8(buf)
    row_ids = np.ascontiguousarray(row_ids, dtype=np.uint64)
    slots = np.ascontiguousarray(slots, dtype=np.uint64)
    if len(row_ids) != len(slots):
        raise ValueError("expand_rows_into: row_ids/slots length mismatch")
    if plane.dtype != np.uint32 or not plane.flags.c_contiguous:
        raise ValueError("plane must be C-contiguous uint32")
    if plane.ndim != 2:
        raise ValueError("plane must be 2-D [n_rows, words_per_row]")
    return _check(lib().rc_expand_rows_into(
        ptr, len(keep), row_width, _p64(row_ids), _p64(slots),
        len(row_ids), plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        plane.shape[-1], plane.shape[0]), "expand_rows_into")


def _addr(arr: np.ndarray) -> int:
    return arr.__array_interface__["data"][0]


_U32 = np.dtype(np.uint32)


def _as_u32c(a: np.ndarray) -> np.ndarray:
    if a.dtype is _U32 and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.uint32)


def union_sorted_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Linear merge-union of two sorted unique uint32 arrays."""
    a, b = _as_u32c(a), _as_u32c(b)
    out = np.empty(len(a) + len(b), dtype=np.uint32)
    k = lib().rc_union_u32(_addr(a), len(a), _addr(b), len(b), _addr(out))
    # an exact-size copy: rows hold the result, and a view would pin the
    # oversized merge buffer
    return out[:k].copy()


def diff_sorted_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a`` minus ``b``, both sorted unique uint32."""
    a, b = _as_u32c(a), _as_u32c(b)
    out = np.empty(len(a), dtype=np.uint32)
    k = lib().rc_diff_u32(_addr(a), len(a), _addr(b), len(b), _addr(out))
    return out[:k].copy()
