"""Build and load the port's CUDA kernels (cofii2p_tpu_torch/csrc/*.cu).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds: one ``nvcc`` per
source, all started together, then one link.  The library lands in
``build/cofii2p_tpu_torch/`` at the repo root, named by a hash of the
sources and flags, so an edited source is rebuilt on next use and an
unchanged one is reused.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cofii2p_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the launchers (csrc/*.cu); every launcher returns the
# cudaError_t of its launch
SIGNATURES = {
    "kpconv_fused_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _F, _F, _P],
    "kpconv_aggregate_launch": [_P, _P, _P, _I, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _P],
    "kpconv_transpose_launch": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _P],
    "maxpool_launch": [_P, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _P],
    "maxpool_count_launch": [_P, _P, _P, _I, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _F, _P],
    "maxpool_bwd_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "knn_tau_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "maxpool_tau_launch": [_P, _P, _P, _I, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    "kpconv_fused_tau_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _P],
    "kpconv_aggregate_tau_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _P],
    "kpconv_transpose_dyn_launch": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _P],
    "kpconv_transpose_tau_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _P],
    "maxpool_count_tau_launch": [_P, _P, _P, _I, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P],
    "maxpool_bwd_dyn_launch": [_P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "maxpool_bwd_tau_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "band_scatter_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "residual_fused_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _F, _F, _P],
    "ransac_hyp_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P],
    "ransac_refine_launch": [_I, _P, _P, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib = None
_driver = None
build_log = ""


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on first use")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libcofii2p_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library of the same sources exists;
    returns its path.  ``build_log`` keeps nvcc's output (``-Xptxas -v``
    lists each kernel's registers, shared memory and spills)."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    tmp = f"{out}.{os.getpid()}.tmp"
    obj_dir = tmp + ".o"
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(obj_dir, os.path.basename(p) + ".o") for p in cus]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for p, o in zip(cus, objs)
    ]
    logs, failed = [], []
    for p, proc in zip(cus, procs):
        text, _ = proc.communicate()
        logs.append(f"== {os.path.basename(p)}\n{text}")
        if proc.returncode != 0:
            failed.append(os.path.basename(p))
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def graph_nodes(graph) -> int:
    """Node count of a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True``: the driver's ``cuGraphGetNodes`` on its
    ``raw_cuda_graph()`` (the process's one ``libcuda``, so the handle
    needs no runtime of its own)."""
    global _driver
    with _lock:
        if _driver is None:
            drv = ctypes.CDLL("libcuda.so.1")
            drv.cuGraphGetNodes.argtypes = [_P, _P, ctypes.POINTER(ctypes.c_size_t)]
            drv.cuGraphGetNodes.restype = ctypes.c_int
            _driver = drv
    n = ctypes.c_size_t(0)
    err = _driver.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
