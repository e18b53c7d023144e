"""ctypes loader for the native host-kernel library (csrc/hostkernels.cpp).

Auto-builds with g++ on first use if the shared object is missing (cached in
the package directory); every caller has a pure-numpy fallback, so absence of
a toolchain only costs setup speed, never correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _so_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "_native.so")


def _build() -> bool:
    src = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "csrc", "hostkernels.cpp",
    )
    if not os.path.exists(src):
        return False
    # build to a per-process name and rename: concurrent first users (test
    # workers) must never load a half-written library
    tmp = f"{_so_path()}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _so_path())
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _so_path()
    if not os.path.exists(path) and not _build():
        return None
    try:
        L = ctypes.CDLL(path)
        L.encode_rows.restype = ctypes.c_int64
        L.encode_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        L.stable_counting_argsort.restype = None
        L.stable_counting_argsort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        _LIB = L
    except OSError:
        _LIB = None
    return _LIB


def encode_rows(
    main: np.ndarray, query: Optional[np.ndarray] = None
) -> Tuple[int, np.ndarray, Optional[np.ndarray]]:
    """Hash-unique rows of ``main`` (first-seen order) and look up ``query``.

    Returns (n_unique, main_ids, query_ids or None).  Native when available,
    numpy otherwise.
    """
    main = np.ascontiguousarray(main, dtype=np.int64)
    n, w = main.shape
    if query is not None:
        query = np.ascontiguousarray(query, dtype=np.int64)
        assert query.shape[1] == w
    L = lib()
    if L is not None:
        main_ids = np.empty(n, dtype=np.int64)
        nq = 0 if query is None else len(query)
        query_ids = np.empty(max(nq, 1), dtype=np.int64)
        count = L.encode_rows(
            main.ctypes.data, n,
            query.ctypes.data if query is not None else main.ctypes.data,
            nq, w, main_ids.ctypes.data, query_ids.ctypes.data,
        )
        return int(count), main_ids, (query_ids[:nq] if query is not None else None)
    # numpy fallback: sort-based unique (different id order — both are valid
    # global numberings; callers must not rely on a specific order)
    void = main.view([("", np.int64)] * w).ravel()
    uniq, inv = np.unique(void, return_inverse=True)
    qids = None
    if query is not None:
        qvoid = np.ascontiguousarray(query).view([("", np.int64)] * w).ravel()
        pos = np.searchsorted(uniq, qvoid)
        pos_c = np.minimum(pos, len(uniq) - 1)
        qids = np.where(uniq[pos_c] == qvoid, pos_c, -1).astype(np.int64)
    return len(uniq), inv.astype(np.int64), qids


def counting_argsort(keys: np.ndarray, nbins: int) -> np.ndarray:
    """Stable argsort of non-negative int keys (native counting sort or
    numpy stable sort)."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    L = lib()
    if L is not None:
        perm = np.empty(len(keys), dtype=np.int64)
        L.stable_counting_argsort(
            keys.ctypes.data, len(keys), int(nbins), perm.ctypes.data
        )
        return perm
    return np.argsort(keys, kind="stable")
