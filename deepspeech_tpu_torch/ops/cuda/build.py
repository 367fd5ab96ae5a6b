"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. The
build happens at first use, into ``deepspeech_tpu_torch/_build/`` (listed in
``.gitignore``), and again whenever the source or a header in ``csrc/`` is
newer than the library. A missing ``nvcc`` or a failed build raises.

``build_all`` starts one ``nvcc`` per source at once, so the build time is
that of the slowest file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from deepspeech_tpu_torch.utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("stft_mag", "gru_fwd", "gru_scan", "gru_bwd", "lstm_fwd",
           "lstm_scan", "lstm_bwd", "ctc", "topk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "deepspeech_tpu_torch cannot be built")
    return path


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(lib)


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen, tmp: str, lib: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return out


def build_all(names=SOURCES, force: bool = False) -> dict[str, str]:
    """Compile the stale (or, with ``force``, all) kernels in parallel;
    -> {name: nvcc output}."""
    with _lock, trace.span("build"):
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = [n for n in names if force or _stale(n)]
        procs = {n: _start(n) for n in todo}
        return {n: _finish(n, *procs[n]) for n in todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(_paths(name)[1])
            lib.ds_error_string.argtypes = [ctypes.c_int]
            lib.ds_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.ds_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
