"""The host C++ library (edit distance, CTC beam search with an ARPA LM,
FLAC decoding), built with g++ at first use and loaded through ctypes.

The sources are copies of the JAX package's ``native/*.cpp``; the ctypes
signatures are the JAX loader's. The library is built into
``deepspeech_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the sources, so a library is never stale: changed
sources name another file. Processes that load it at once take turns on
an ``flock`` of ``<library>.lock`` (released by the kernel when a process
dies), so one compiles and the rest find its library; g++ writes to a
per-process temporary name in the same directory, which ``os.replace``
then moves onto the final name, so no process ever opens a half-written
library. A failed compile raises with g++'s output; a
machine without g++ has no library (``try_load_native`` returns None, and
every consumer has a Python fallback).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("edit_distance.cpp", "beam_search.cpp", "flac_decoder.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=1)
def _source_hash() -> str:
    h = hashlib.sha1()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(build_dir: str | None = None) -> str:
    """Where the library of the current sources lives."""
    return os.path.join(build_dir or BUILD_DIR,
                        f"libdeepspeech_native-{_source_hash()}.so")


def build(build_dir: str | None = None) -> str:
    """Compile the library into ``build_dir``; -> g++'s output. Raises
    RuntimeError with that output when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library of "
                           "deepspeech_tpu_torch cannot be built")
    lib = library_path(build_dir)
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp,
           *(os.path.join(_DIR, s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for deepspeech_tpu_torch/native "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def load_native(build_dir: str | None = None,
                force: bool = False) -> ctypes.CDLL:
    """The loaded library, built first if the current sources have none
    (or, with ``force``, rebuilt). Raises where it cannot be built."""
    lib_path = library_path(build_dir)
    lib = _libs.get(lib_path)
    if lib is not None and not force:
        return lib
    with _lock:
        lib = _libs.get(lib_path)
        if force or not os.path.exists(lib_path):
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            with open(lib_path + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if force or not os.path.exists(lib_path):
                    build(build_dir)
        if lib is None:
            lib = _bind(ctypes.CDLL(lib_path))
            _libs[lib_path] = lib
        return lib


def try_load_native(build_dir: str | None = None) -> ctypes.CDLL | None:
    """``load_native``, or None on a machine without g++ (a failed compile
    still raises)."""
    lib = _libs.get(library_path(build_dir))
    if lib is not None:
        return lib
    if shutil.which("g++") is None and not os.path.exists(
            library_path(build_dir)):
        return None
    return load_native(build_dir)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The JAX loader's signatures (its native/__init__.py)."""
    lib.edit_distance_u32.restype = ctypes.c_int64
    lib.edit_distance_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    lib.flac_probe.restype = ctypes.c_int32
    lib.flac_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.flac_decode.restype = ctypes.c_int64
    lib.flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.edit_distance_u32_batch.restype = None
    lib.edit_distance_u32_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bs_lm_load.restype = ctypes.c_void_p
    lib.bs_lm_load.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.bs_lm_free.restype = None
    lib.bs_lm_free.argtypes = [ctypes.c_void_p]
    lib.bs_lm_order.restype = ctypes.c_int32
    lib.bs_lm_order.argtypes = [ctypes.c_void_p]
    lib.bs_lm_score_word.restype = ctypes.c_double
    lib.bs_lm_score_word.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.bs_decode.restype = ctypes.c_int32
    lib.bs_decode.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_double, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    return lib
