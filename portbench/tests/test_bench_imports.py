"""The import guard: no file of the benchmark imports JAX, the JAX package
or the JAX-era scripts, and the reference imports nothing of the program;
names are compared by their whole top-level part (the port's name begins
with the JAX package's)."""
import ast
import subprocess
import sys

import pytest

import bench_util  # noqa: F401  (puts portbench on the path)
import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "hydra_pspec_tpu", "bench",
             "chip_smoke"}
PROGRAM = "hydra_pspec_torch"


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if ".cache" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(harness.HERE))
                              for p in FILES])
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path",
                         sorted((harness.HERE / "reference").glob("*.py")))
def test_reference_is_independent(path):
    assert PROGRAM not in _imports(path)


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hydra_pspec_tpu_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hydra_pspec_tpu.models", sys)
    assert harness.forbidden_modules() == ["hydra_pspec_tpu"]


def test_run_loads_no_jax():
    """The command's imports and a tiny run leave no JAX module behind (in a
    fresh process)."""
    code = ("import sys; sys.path[:0] = ['portbench/tests']; "
            "import bench_util, harness; "
            "out = bench_util.run_tiny('h1c_main'); "
            "assert out['correct']; print(harness.forbidden_modules())")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_command_without_a_card_prints_no_result(tmp_path):
    """Off the card the command exits non-zero and prints no result, also
    from a directory that holds only the benchmark."""
    import shutil
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", ".trace",
                                                  "__pycache__"))
    for cwd in (harness.REPO, tmp_path):
        res = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "h1c_main",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert res.stdout.strip() == ""
