"""ctypes binding of the thread-pool .npy writer ``csrc/fastio.cpp`` (port
of ``hydra_pspec_tpu/utils/fastio.py``), built at first use and, where no
compiler is found, replaced by synchronous ``np.save``.

Python owns the .npy format (``numpy.lib.format`` builds the header bytes,
so a file is byte-for-byte what ``np.save`` writes); the C++ pool writes
header and payload on worker threads, each file to a temporary name and
then renamed. The runner's flush goes through it, so the hundreds of
per-baseline sample files of a write interval do not serialize on the host
thread (the reference's overwrite-all contract: pspec.py:625-638).

The library is compiled with ``g++ -O2 -std=c++17 -fPIC -pthread -shared``
into ``hydra_pspec_torch/_build/`` (git-ignored, beside the kernels); its
file name carries a hash of the source, so an edit rebuilds. Nothing is
built when this module is imported.
"""
import ctypes
import hashlib
import io
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fastio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lib = None
_lib_tried = False


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libhydra_fastio-{h}.so"


def _build() -> Path:
    """Compile the source unless its library exists; raises on failure."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("no C++ compiler found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)   # atomic: concurrent builders each rename whole
    return so


def _load_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.fastio_create.restype = ctypes.c_void_p
    lib.fastio_create.argtypes = [ctypes.c_int]
    lib.fastio_submit.restype = ctypes.c_int
    lib.fastio_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.fastio_wait.restype = ctypes.c_longlong
    lib.fastio_wait.argtypes = [ctypes.c_void_p]
    lib.fastio_write_seconds.restype = ctypes.c_double
    lib.fastio_write_seconds.argtypes = [ctypes.c_void_p]
    lib.fastio_destroy.restype = None
    lib.fastio_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _npy_header_full(arr: np.ndarray) -> bytes:
    """Complete .npy header bytes (magic, version, header struct) from
    numpy's own format helpers, so ``np.load`` reads the file."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    out = buf.getvalue()
    # numpy >= 2 writes the magic inside write_array_header_1_0; older
    # versions expect the caller to prepend it
    return (out if out.startswith(b"\x93NUMPY")
            else np.lib.format.magic(1, 0) + out)


class AsyncNpyWriter:
    """Thread-pool writer: ``save()`` queues a file, ``wait()`` drains the
    queue. Falls back to synchronous ``np.save`` when the library cannot
    be built or loaded (``is_native`` False)."""

    def __init__(self, nthreads: Optional[int] = None):
        self._lib = _load_lib()
        self._pool = None
        if self._lib is not None:
            n = nthreads or min(8, os.cpu_count() or 1)
            self._pool = ctypes.c_void_p(self._lib.fastio_create(n))

    @property
    def is_native(self) -> bool:
        return self._pool is not None

    def save(self, path, arr):
        arr = np.ascontiguousarray(np.asarray(arr))
        if self._pool is None:
            np.save(path, arr)
            return
        header = _npy_header_full(arr)
        # fastio_submit copies both buffers before it returns, so ``arr``
        # and ``header`` need to live for this call only
        self._lib.fastio_submit(
            self._pool, str(path).encode(), header, len(header),
            ctypes.c_void_p(arr.ctypes.data), arr.nbytes)

    def wait(self) -> int:
        """Drain the queue; returns the number of failed writes so far."""
        if self._pool is None:
            return 0
        return int(self._lib.fastio_wait(self._pool))

    def write_seconds(self) -> float:
        """Seconds the pool's threads spent writing, summed over threads."""
        if self._pool is None:
            return 0.0
        return float(self._lib.fastio_write_seconds(self._pool))

    def close(self):
        if self._pool is not None:
            self._lib.fastio_wait(self._pool)
            self._lib.fastio_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
