"""ctypes bindings for the port's native host ops (voxel downsample, grid
kNN, farthest point sampling), built from ``host_ops.cc`` beside this file.

The library is compiled by ``g++`` with the JAX package's Makefile flags
on first use into ``build/cofii2p_tpu_torch/`` at the repo root, named by a
hash of the source and flags, and loaded through ``ctypes``.  Nothing
builds at import.  There is no NumPy fallback: the native voxel order
(first occurrence) differs from a NumPy one (lexicographic), and the
fixed-size resample draws over that order, so a silent fallback would
change every KITTI frame.  A failed build or load raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "host_ops.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "cofii2p_tpu_torch")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libhost_ops_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile host_ops.cc unless a library of the same source exists;
    returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", tmp, SOURCE], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx!r} to build the port's host ops: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded host-op library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            handle.voxel_downsample.restype = ctypes.c_int64
            handle.voxel_downsample.argtypes = [
                f32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, f32p, ctypes.c_void_p, ctypes.c_int64,
            ]
            handle.knn_search.restype = None
            handle.knn_search.argtypes = [
                f32p, ctypes.c_int64, f32p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float, i32p,
            ]
            handle.farthest_point_sampling.restype = None
            handle.farthest_point_sampling.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p,
            ]
            _lib = handle
    return _lib


def _points(x: np.ndarray, name: str) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: expected (N, 3) points, got {x.shape}")
    return x


def voxel_downsample(points: np.ndarray, attrs: np.ndarray | None, voxel: float):
    """Average points (and attrs) per occupied voxel, voxels in order of
    first occurrence; returns (points (M, 3), attrs (M, A) or None)."""
    pts = _points(points, "points")
    n = pts.shape[0]
    a = 0 if attrs is None else attrs.shape[1]
    at = None if attrs is None else np.ascontiguousarray(attrs, np.float32)
    if at is not None and at.shape[0] != n:
        raise ValueError(f"attrs: {at.shape[0]} rows for {n} points")
    out_p = np.empty((n, 3), np.float32)
    out_a = np.empty((n, max(a, 1)), np.float32)
    m = lib().voxel_downsample(
        pts,
        None if at is None else at.ctypes.data_as(ctypes.c_void_p),
        n, a, voxel, out_p,
        out_a.ctypes.data_as(ctypes.c_void_p), n,
    )
    return out_p[:m].copy(), (None if attrs is None else out_a[:m, :a].copy())


def knn(queries: np.ndarray, database: np.ndarray, k: int, grid_cell: float = 0.0) -> np.ndarray:
    """Exact kNN indices (nq, k) via the native grid index; padded with
    len(database) when the database has fewer than k points."""
    q = _points(queries, "queries")
    d = _points(database, "database")
    out = np.empty((q.shape[0], k), np.int32)
    lib().knn_search(q, q.shape[0], d, d.shape[0], k, grid_cell, out)
    return out


def farthest_point_sampling(points: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    """Greedy farthest point sampling from ``start``: k indices (int32)."""
    pts = _points(points, "points")
    if not 0 <= start < pts.shape[0]:
        raise ValueError(f"start {start} for {pts.shape[0]} points")
    out = np.empty((k,), np.int32)
    lib().farthest_point_sampling(pts, pts.shape[0], k, start, out)
    return out
