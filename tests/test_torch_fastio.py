"""The port's native thread-pool .npy writer (``hydra_pspec_torch/utils/
fastio.py`` over its own copy ``csrc/fastio.cpp``): the JAX module's
contract (round trip, many files and overwrite, a failed write reported,
the np.save fallback), files byte-equal to ``np.save``'s for every dtype
the runner writes, and a build that never touches ``native/``."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from hydra_pspec_tpu.utils import fastio as jfastio
from hydra_pspec_torch.utils import fastio

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(5)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ compiler")

# what the runner writes: gcr-eor and fg-amps (complex64 samples), cov-eor
# (complex128), dps-eor, chisq and ln-post (float32), the empty arrays of a
# lean run (float64), and the checkpoint-adjacent int64
RUNNER_ARRAYS = {
    "gcr-eor.npy": (RNG.standard_normal((4, 7, 12))
                    + 1j * RNG.standard_normal((4, 7, 12))
                    ).astype(np.complex64),
    "cov-eor.npy": (RNG.standard_normal((12, 12))
                    + 1j * RNG.standard_normal((12, 12))),
    "dps-eor.npy": RNG.standard_normal((4, 12)).astype(np.float32),
    "fg-amps.npy": (RNG.standard_normal((4, 7, 3))
                    + 1j * RNG.standard_normal((4, 7, 3))
                    ).astype(np.complex64),
    "chisq.npy": RNG.standard_normal((4, 7, 12)).astype(np.float32),
    "ln-post.npy": RNG.standard_normal(4).astype(np.float32),
    "empty.npy": np.zeros(0),
    "ids.npy": RNG.integers(0, 100, size=(11,)).astype(np.int64),
    "f64.npy": RNG.standard_normal((64, 128)),
}


def _native(nthreads):
    w = fastio.AsyncNpyWriter(nthreads=nthreads)
    assert w.is_native, "the port's native writer failed to build or load"
    return w


@needs_gxx
def case_roundtrip_and_bytes(tmp_path):
    """Every array reads back equal, and each file is byte for byte the
    file np.save writes, as the JAX writer's is."""
    w = _native(4)
    (tmp_path / "ref").mkdir()
    (tmp_path / "jax").mkdir()
    jw = jfastio.AsyncNpyWriter(nthreads=2)
    for name, arr in RUNNER_ARRAYS.items():
        w.save(tmp_path / name, arr)
        jw.save(tmp_path / "jax" / name, arr)
        np.save(tmp_path / "ref" / name, arr)
    assert w.wait() == 0 and jw.wait() == 0
    for name, arr in RUNNER_ARRAYS.items():
        got = np.load(tmp_path / name)
        assert got.dtype == arr.dtype and np.array_equal(got, arr), name
        raw = (tmp_path / name).read_bytes()
        assert raw == (tmp_path / "ref" / name).read_bytes(), name
        assert raw == (tmp_path / "jax" / name).read_bytes(), name
    assert w.write_seconds() > 0
    w.close()
    jw.close()


@needs_gxx
def case_many_files_and_overwrite(tmp_path):
    """The reference's overwrite-all contract (pspec.py:625-638): three
    rounds over 60 files, the last round's contents win."""
    w = _native(8)
    for rounds in range(3):
        for i in range(60):
            w.save(tmp_path / f"f{i}.npy", np.full((50,), rounds + i, float))
        assert w.wait() == 0
    for i in range(60):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"f{i}.npy"), np.full((50,), 2 + i, float))
    assert not list(tmp_path.glob("*.tmp"))
    w.close()


@needs_gxx
def case_failed_write_reported(tmp_path):
    w = _native(2)
    w.save(tmp_path / "missing-dir" / "x.npy", np.zeros(3))
    w.save(tmp_path / "ok.npy", np.ones(3))
    assert w.wait() == 1
    np.testing.assert_array_equal(np.load(tmp_path / "ok.npy"), np.ones(3))
    w.close()


def case_fallback_without_native(tmp_path, monkeypatch):
    monkeypatch.setattr(fastio, "_load_lib", lambda: None)
    w = fastio.AsyncNpyWriter()
    assert not w.is_native
    w.save(tmp_path / "x.npy", np.arange(4))
    assert w.wait() == 0 and w.write_seconds() == 0.0
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), np.arange(4))
    w.close()


@needs_gxx
def case_builds_from_its_own_source(tmp_path, monkeypatch):
    """The library is compiled from the port's csrc/fastio.cpp into the
    port's _build directory, its name keyed on the source; the committed
    native/ library and its Makefile are never used."""
    so = fastio.library_path()
    assert so.parent == REPO / "hydra_pspec_torch" / "_build"
    assert so.name.startswith("libhydra_fastio-") and so.suffix == ".so"
    src = REPO / "hydra_pspec_torch" / "csrc" / "fastio.cpp"
    body = lambda p: [l for l in p.read_text().splitlines()
                      if not l.startswith("//")]
    assert body(src) == body(REPO / "native" / "fastio.cpp")
    assert "native" not in fastio._SRC.parts
    # a rebuild into a fresh directory
    monkeypatch.setattr(fastio, "_BUILD_DIR", tmp_path / "build")
    built = fastio._build()
    assert built.exists() and built.parent == tmp_path / "build"
    assert built.name == so.name


CASES = {f.__name__[5:]: f for f in (case_roundtrip_and_bytes,
                                      case_many_files_and_overwrite,
                                      case_failed_write_reported,
                                      case_fallback_without_native,
                                      case_builds_from_its_own_source)}


@pytest.mark.parametrize("case", list(CASES))
def test_writer(case, tmp_path, monkeypatch):
    CASES[case](tmp_path, monkeypatch) if "monkeypatch" in \
        CASES[case].__code__.co_varnames else CASES[case](tmp_path)
