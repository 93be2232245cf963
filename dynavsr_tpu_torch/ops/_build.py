"""Build the CUDA kernels of csrc/ into plain-C-ABI shared libraries.

Each `.cu` source is compiled by its own `nvcc` process, all started
together, into `build/kernels/lib<name>-<hash>.so` under the repository
root (the hash covers the sources and flags, so an edit rebuilds). The
libraries are loaded with ctypes at first use. A missing nvcc or a failed
build raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "build", "load", "lib_path", "stream", "raise_if",
           "refuse_double_backward", "cotangents", "accumulate"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("dcn_fwd", "dcn_bwd", "dcn_tangent", "warp_fwd", "warp_bwd", "warp_tangent",
           "duf_fwd", "duf_bwd")
_HEADERS = {"dcn_fwd": ("dcn_common.cuh", "dcn_fwd.cuh"),
            "dcn_bwd": ("dcn_common.cuh", "dcn_bwd_data.cuh", "dcn_bwd_weight.cuh"),
            "dcn_tangent": ("dcn_common.cuh", "dcn_fwd.cuh", "dcn_bwd_data.cuh",
                            "dcn_bwd_weight.cuh"),
            "warp_fwd": ("warp_common.cuh",), "warp_bwd": ("warp_common.cuh",),
            "warp_tangent": ("warp_common.cuh",),
            "duf_fwd": ("duf_common.cuh",), "duf_bwd": ("duf_common.cuh",)}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOG: Dict[str, str] = {}

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "dcn_fwd": [_VP] * 7 + [_I] * 7 + [_VP],
    "dcn_bwd_data": [_VP] * 9 + [_I] * 7 + [_VP],
    "dcn_bwd_weight": [_VP] * 6 + [_I] * 7 + [_VP],
    "dcn_fwd_tangent": [_VP] * 7 + [_I] * 7 + [_VP],
    "dcn_fwd_tangent_splits": [_I] * 6,
    "dcn_bwd_weight_tangent": [_VP] * 7 + [_I] * 6 + [_VP],
    "dcn_bwd_data_tangent": [_VP] * 9 + [_I] * 7 + [_VP],
    "warp_fwd": [_VP] * 3 + [_I] * 4 + [_VP],
    "warp_bwd": [_VP] * 5 + [_I] * 4 + [_VP],
    "warp_bwd_tangent": [_VP] * 7 + [_I] * 4 + [_VP],
    "duf_fwd": [_VP] * 3 + [_I] * 6 + [_VP],
    "duf_bwd": [_VP] * 5 + [_I] * 6 + [_VP],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu is built (hash of its sources)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS[name]:
        h.update((_CSRC / f).read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel; return
    {name: nvcc output} (the -Xptxas -v register/shared-memory lines)."""
    todo = [n for n in names if not lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            out, _ = p.communicate()
            _LOG[n] = out
            if p.returncode != 0:
                failed.append(f"{n}.cu (rc {p.returncode}):\n{out}")
            else:
                os.replace(tmp, lib_path(n))
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: _LOG.get(n, "(cached)") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
        _LIBS[name] = lib
    return lib


def stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device (the capture stream while a CUDA
    graph is captured), as a launcher's last argument: the raw handle,
    without building a `torch.cuda.Stream` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def raise_if(rc: int, name: str) -> None:
    """Raise on a launcher's nonzero cudaError."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def refuse_double_backward(kernels: str, what: str) -> None:
    """Raise inside an autograd `backward` that runs the kernels `kernels`
    when the caller asked for `create_graph=True` (grad mode is on there
    exactly then). The kernels fill their gradients through ctypes, so
    those gradients carry no graph, and a higher-order gradient would
    silently lose every term through them. `what` says which derivative
    is missing and where it is planned."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"a double backward (create_graph=True) through the CUDA kernels {kernels} is "
            f"not implemented: their second-order terms would be dropped. {what}")


def cotangents(*cots):
    """The cotangents of a second-order backward, with None for each that is
    absent or all zero (one device sync for all of them), so a term along a
    zero cotangent skips its launches."""
    present = [i for i, t in enumerate(cots) if t is not None]
    if not present:
        return cots
    nonzero = torch.stack([cots[i].any() for i in present]).tolist()
    out = list(cots)
    for i, nz in zip(present, nonzero):
        if not nz:
            out[i] = None
    return out


def accumulate(total, term):
    """total + term, where a total of None is nothing yet."""
    return term if total is None else total + term
