"""ctypes binding to the repository's native LMDB reader/writer
(native/lmdbr/lmdbr.cpp), the same API as dynavsr_tpu/data/lmdb_native.py.

Both packages build the one C++ source, so they read and write one on-disk
format. This one builds it into its own library,
`build/native/liblmdbr-<hash>.so` under the repository root (the hash
covers the source and the flags, so an edit rebuilds), with g++ called
directly at first use: never `make -C native/lmdbr`, whose
`native/lmdbr/liblmdbr.so` is the JAX binding's file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

__all__ = ["LmdbReader", "LmdbWriter", "build_native"]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "lmdbr" / "lmdbr.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LIB: Optional[ctypes.CDLL] = None


def build_native() -> str:
    """Path of the built library, compiling it first if it is not there.
    The build writes a temporary file and renames it into place, so
    processes that build at once never load a half-written library."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    so = _BUILD_DIR / f"liblmdbr-{h.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/lmdbr/lmdbr.cpp")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SOURCE)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if osp.exists(tmp):
            os.unlink(tmp)
    return str(so)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native())
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        pvp, psz = ctypes.POINTER(vp), ctypes.POINTER(sz)
        sigs = {
            "lmdbr_open": (vp, [ctypes.c_char_p]),
            "lmdbr_close": (None, [vp]),
            "lmdbr_entries": (ctypes.c_uint64, [vp]),
            "lmdbr_get": (ctypes.c_int, [vp, ctypes.c_char_p, sz, pvp, psz]),
            "lmdbr_cursor_open": (vp, [vp]),
            "lmdbr_cursor_next": (ctypes.c_int, [vp, pvp, psz, pvp, psz]),
            "lmdbr_cursor_close": (None, [vp]),
            "lmdbw_open": (vp, [ctypes.c_char_p]),
            "lmdbw_put": (ctypes.c_int, [vp, ctypes.c_char_p, sz, ctypes.c_char_p, sz]),
            "lmdbw_close": (ctypes.c_int, [vp]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
    return _LIB


def _datafile(path: str) -> str:
    return osp.join(path, "data.mdb") if osp.isdir(path) else path


class LmdbReader:
    """Read-only view of an LMDB file; get() copies out of the mapping."""

    def __init__(self, path: str):
        self._h = _lib().lmdbr_open(_datafile(path).encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open LMDB at {path}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._h:
            _lib().lmdbr_close(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(_lib().lmdbr_entries(self._h))

    def get(self, key: bytes) -> Optional[bytes]:
        val, vlen = ctypes.c_void_p(), ctypes.c_size_t()
        if _lib().lmdbr_get(self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen)):
            return None
        return ctypes.string_at(val.value, vlen.value)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        lib = _lib()
        cur = lib.lmdbr_cursor_open(self._h)
        try:
            k, kl = ctypes.c_void_p(), ctypes.c_size_t()
            v, vl = ctypes.c_void_p(), ctypes.c_size_t()
            while lib.lmdbr_cursor_next(cur, ctypes.byref(k), ctypes.byref(kl),
                                        ctypes.byref(v), ctypes.byref(vl)) == 0:
                yield ctypes.string_at(k.value, kl.value), ctypes.string_at(v.value, vl.value)
        finally:
            lib.lmdbr_cursor_close(cur)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]


class LmdbWriter:
    """Bulk writer: puts are collected, and the B+tree is written on close."""

    def __init__(self, path: str):
        if osp.isdir(path) or path.endswith(".lmdb"):
            os.makedirs(path, exist_ok=True)
            path = osp.join(path, "data.mdb")
        self._h = _lib().lmdbw_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def put(self, key: bytes, value: bytes) -> None:
        if _lib().lmdbw_put(self._h, key, len(key), value, len(value)):
            raise ValueError(f"LMDB key too large for one leaf node ({len(key)} bytes)")

    def close(self) -> None:
        if self._h:
            rc = _lib().lmdbw_close(self._h)
            self._h = None
            if rc:
                raise OSError("lmdb write failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
