"""Build, load and count the hand-written CUDA kernels.

The sources in ``hydra_pspec_torch/csrc/*.cu`` have a plain C interface.
They are compiled with nvcc by hand, one nvcc per source and all started
together (``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-Xcompiler -fPIC -c``), then linked into one shared library, at first use,
into ``hydra_pspec_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a hash of the sources, so an edit always
rebuilds. Nothing is built when a module is imported.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`call` raises if that is not 0. Each launch adds one to its kernel's
count in :data:`LAUNCHES`; each call on the card of an entry composed from
the kernels adds one to the entry's count there (:func:`count_entry`).
Inside a CUDA graph capture (:mod:`graph`) a launch is recorded, not made:
the capture's counts are taken back, and each replay of the graph adds
them (:func:`counted`, :func:`add_launches`).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint

# argument types of every C entry point (all return int: cudaError_t)
SIGNATURES = {
    "hk_cgemm": [P, P, P, P, I, I, I, I, I, I, F, F, P, P],
    "hk_cgemm_tile": [P, P, P, P, I, I, I, I, I, I, F, F, P, I, P],
    "hk_cgemm_plan": [I, I, I, I],
    "hk_herm_inv": [P, P, I, I, P, P, P, F, I, P, P],
    "hk_herm_chol_solve": [P, P, P, P, I, I, I, P],
    "hk_draw_rhs": [P, P, P, U, P, U, P, P, I, I, I, I, P, P],
    "hk_draw_system": [P, P, P, P, U, P, U, P, P, P, P, P, I, I, I, I, I,
                       P, P],
    "hk_row_scale_sumsq": [P, P, P, P, P, I, I, P],
    "hk_draw_resid": [P, P, P, P, P, P, P, P, P, P, P, P,
                      I, I, I, I, I, P, P],
    "hk_rng_fields": [U, P, U, P, P, I, I, I, I, I, P, P, P, I, I, P],
    "hk_bandpower": [P, P, P, I, U, P, U, P, I, P, P, I, P, P, P, I,
                     P, P, I, I, I, P],
    "hk_philox_raw": [P, P, P, I, P],
}

# launches per kernel since the last reset_launches(), and calls of the two
# entries composed from kernels (``hermitian_solve``, ``gcr_megastep``) on
# the card
LAUNCHES = {"cgemm": 0, "herm_inv": 0, "herm_chol_solve": 0, "draw_rhs": 0,
            "draw_system": 0, "row_scale_sumsq": 0, "draw_resid": 0,
            "rng_fields": 0, "bandpower": 0, "philox_raw": 0,
            "hermitian_solve": 0, "gcr_megastep": 0}


class _Library:
    """The loaded shared library; one per process, built on first use."""

    def __init__(self):
        self.lib = None
        self.build_seconds = None
        self.build_log = ""


_LIB = _Library()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class counted:
    """``with counted() as rec:`` -- ``rec`` holds the launches counted in
    the block (by kernel, zeros left out), and the block leaves
    :data:`LAUNCHES` as it found it: a graph capture's launches are
    recorded, not made, and its warm-up is set-up work."""

    def __enter__(self):
        self._before = dict(LAUNCHES)
        self.launches = {}
        return self

    def __exit__(self, *exc):
        self.launches = {k: v - self._before[k] for k, v in LAUNCHES.items()
                         if v != self._before[k]}
        LAUNCHES.update(self._before)


def add_launches(launches: dict):
    """Count the launches of one graph replay (recorded by :class:`counted`
    around its capture)."""
    for k, v in launches.items():
        LAUNCHES[k] += v


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this exact source set is not built yet) and
    return the library path. ``verbose`` adds ``-Xptxas -v``."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libhydra_kernels-{h.hexdigest()[:16]}.so"
    if so.exists() and not verbose:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = [(obj, p.communicate()[0], p.returncode) for obj, p in procs]
    failed = [f"{obj.name} ({rc}):\n{log}" for obj, log, rc in logs if rc]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *[str(obj) for obj, _ in procs]],
                             capture_output=True, text=True)
        if res.returncode:
            failed.append(f"link ({res.returncode}):\n{res.stdout}"
                          f"{res.stderr}")
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    _LIB.build_seconds = time.perf_counter() - t0
    _LIB.build_log = "".join(log for _, log, _ in logs)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    if _LIB.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hk_error_string.argtypes = [ctypes.c_int]
        lib.hk_error_string.restype = ctypes.c_char_p
        _LIB.lib = lib
    return _LIB.lib


def build_info():
    """(seconds of the last nvcc run in this process or None, its log)."""
    return _LIB.build_seconds, _LIB.build_log


def call(kernel: str, entry: str, *args):
    """Launch ``entry`` (its last argument, the stream, is appended here),
    count one launch of ``kernel``, and raise on a CUDA error."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry}: CUDA error {err}: "
            f"{lib.hk_error_string(err).decode()}")
    LAUNCHES[kernel] += 1


def count_entry(entry: str):
    """Count one call of an entry composed from the kernels (it launches
    those kernels; the caller counts it only on the card)."""
    LAUNCHES[entry] += 1


def ptr(x):
    """Device pointer of a tensor, or None for an absent optional operand."""
    return None if x is None else x.data_ptr()


def iteration_args(g, g_off, device):
    """``(g, g_dev)`` of a keyed C entry for the iteration ``g + g_off``:
    ``g`` an int gives ``(g + g_off, None)``; ``g`` a (1,) int32 tensor on
    ``device`` gives ``(g_off, its pointer)``, and the kernel reads the
    iteration as ``*g_dev + g_off`` at run time (graph replays)."""
    if torch.is_tensor(g):
        check(g, "g", torch.int32, (1,), device)
        return int(g_off) & 0xFFFFFFFF, ptr(g)
    return (int(g) + int(g_off)) & 0xFFFFFFFF, None


def check(x, name, dtype, shape=None, device=None):
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (None entries match any size) on ``device``."""
    if not torch.is_tensor(x) or not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        if len(shape) != x.dim() or any(
                s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                             f"expected {shape}")


def on_cpu(*xs) -> bool:
    """True when every given tensor is on the CPU (the plain-version
    route); False when all are CUDA tensors; raises on a mix or on any
    other device."""
    devs = {x.device.type for x in xs if x is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"operands on devices {sorted(devs)}: expected all "
                     f"on the CPU or all on one CUDA device")
