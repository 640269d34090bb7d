"""ctypes bindings to the native CSV reader (`native/csv_parser.cpp`) — the
counterpart of `amid_tpu/data/native.py`: `pack_csv_native` (parse and pack
in C++) and `parse_csv_native` (parse only, for the subdomain filter).

The library is the repository's `native/libamid_native.so`. Where it does
not load (another platform or C library), `native/csv_parser.cpp` is built
with the Makefile's flags into `amid_tpu_torch/_build/` (never into
`native/`). Where neither works, both functions return None, the warning
names the library once, and `data/packed.py` reads the CSV in Python, with
the same result.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "libamid_native.so"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall")  # native/Makefile's

log = logging.getLogger(__name__)


def _build() -> Path:
    """Compiles native/csv_parser.cpp into _build/ (a temporary name, then a
    rename, so a reader never loads a half-written library)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / "libamid_native.so"
    tmp = _BUILD_DIR / f"libamid_native.{os.getpid()}.so"
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                    str(_NATIVE_DIR / "csv_parser.cpp")],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.amid_parse.restype = ctypes.c_void_p
    lib.amid_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.amid_num_rows.restype = ctypes.c_int64
    lib.amid_num_rows.argtypes = [ctypes.c_void_p]
    lib.amid_seq_total.restype = ctypes.c_int64
    lib.amid_seq_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("amid_users", "amid_seq_offsets", "amid_seq_values"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
    for name in ("amid_domains", "amid_ob_labels"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int32)
    lib.amid_users.argtypes = [ctypes.c_void_p]
    lib.amid_domains.argtypes = [ctypes.c_void_p]
    lib.amid_ob_labels.argtypes = [ctypes.c_void_p]
    lib.amid_seq_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.amid_seq_values.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.amid_free.restype = None
    lib.amid_free.argtypes = [ctypes.c_void_p]
    lib.amid_pack.restype = ctypes.c_void_p
    lib.amid_pack.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.amid_packed_n.restype = ctypes.c_int64
    lib.amid_packed_n.argtypes = [ctypes.c_void_p]
    for name in ("amid_packed_r_width", "amid_packed_p_width"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.amid_packed_pool_size.restype = ctypes.c_int32
    lib.amid_packed_pool_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.amid_packed_arr.restype = ctypes.POINTER(ctypes.c_int32)
    lib.amid_packed_arr.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.amid_packed_free.restype = None
    lib.amid_packed_free.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def _load() -> tuple[Optional[ctypes.CDLL], Optional[Path]]:
    """(library, its path): the tracked one, else one built into _build/,
    else (None, None), said once."""
    try:
        return _bind(ctypes.CDLL(str(_SO))), _SO
    except OSError as e:
        first = e
    try:
        path = _build()
        return _bind(ctypes.CDLL(str(path))), path
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native CSV reader unavailable (%s: %s; building %s: %s); "
                    "reading CSVs in Python", _SO, first,
                    _NATIVE_DIR / "csv_parser.cpp", e)
        return None, None


def library_path() -> Optional[Path]:
    """The native library in use, or None when the Python reader serves."""
    return _load()[1]


def pack_csv_native(path: str, with_ob_label: bool, seq_len: int, pad_id: int,
                    long_length: int):
    """CSV -> PackedDualDomainDataset in C++ (parse and pack; `pack_rows`'s
    semantics bit for bit). None when the library is unavailable or the file
    does not parse."""
    from amid_tpu_torch.data.packed import PackedDualDomainDataset

    lib = _load()[0]
    if lib is None:
        return None
    h = lib.amid_parse(str(path).encode(), 1 if with_ob_label else 0)
    if not h:
        return None
    try:
        hp = lib.amid_pack(h, seq_len, pad_id, long_length)
        if not hp:
            return None
        try:
            n = int(lib.amid_packed_n(hp))
            rw = int(lib.amid_packed_r_width(hp))
            pw = int(lib.amid_packed_p_width(hp))

            def arr(name, shape):
                flat = int(np.prod(shape))
                ptr = lib.amid_packed_arr(hp, name.encode())
                return np.ctypeslib.as_array(ptr, (flat,)).reshape(shape).copy()

            return PackedDualDomainDataset(
                user=arr("user", (n,)),
                target=arr("target", (n,)),
                seq_d1=arr("seq1", (n, seq_len)),
                seq_d2=arr("seq2", (n, seq_len)),
                long_mask_d1=arr("long1", (n,)),
                long_mask_d2=arr("long2", (n,)),
                domain_id=arr("domain", (n,)),
                overlap=arr("overlap", (n,)),
                ob_label=arr("ob", (n,)),
                reject=arr("reject", (n, rw)),
                reject_counts=arr("reject_counts", (n,)),
                pools=arr("pools", (2, pw)),
                pool_sizes=np.array([lib.amid_packed_pool_size(hp, 0),
                                     lib.amid_packed_pool_size(hp, 1)], dtype=np.int32),
                pad_id=pad_id,
                seq_len=seq_len,
            )
        finally:
            lib.amid_packed_free(hp)
    finally:
        lib.amid_free(h)


def parse_csv_native(path: str, with_ob_label: bool):
    """(users, seq_d1, seq_d2, domains, ob_labels) as python lists (lists of
    lists for the sequences), or None when the library is unavailable or the
    file does not parse."""
    lib = _load()[0]
    if lib is None:
        return None
    h = lib.amid_parse(str(path).encode(), 1 if with_ob_label else 0)
    if not h:
        return None
    try:
        n = int(lib.amid_num_rows(h))
        users = np.ctypeslib.as_array(lib.amid_users(h), (n,)).tolist()
        domains = np.ctypeslib.as_array(lib.amid_domains(h), (n,)).tolist()
        ob = (np.ctypeslib.as_array(lib.amid_ob_labels(h), (n,)).tolist()
              if with_ob_label else [])
        seqs = []
        for which in (0, 1):
            total = lib.amid_seq_total(h, which)
            offsets = np.ctypeslib.as_array(lib.amid_seq_offsets(h, which), (n + 1,))
            values = np.ctypeslib.as_array(lib.amid_seq_values(h, which),
                                           (max(int(total), 1),))
            seqs.append([values[offsets[i]:offsets[i + 1]].tolist() for i in range(n)])
        return users, seqs[0], seqs[1], domains, ob
    finally:
        lib.amid_free(h)
