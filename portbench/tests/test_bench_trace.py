"""The reduction of a Chrome trace to busy time, window, kernel records and
idle gaps; and, on the card only, one short run of the command."""
import json
import subprocess
import sys

import pytest

import bench_util  # noqa: F401  (puts portbench on the path)
import harness
import chrometrace as trace


def _trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "hydra:staging",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20,
           "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 15,
           "args": {"device": 0}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70,
           "dur": 10, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 50,
           "args": {"device": 1}},
          {"ph": "i", "name": "marker", "ts": 5}]
    p = tmp_path / "chunk-1.trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(p)


def test_busy_window_and_gaps(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s[0] == pytest.approx(40e-6)      # 10-40 and 70-80
    assert tr.busy_s[1] == pytest.approx(50e-6)
    assert len(tr.kernels) == 3
    # device 1 idles 60-100, device 0 40-70: the longest gaps first
    assert tr.gaps[0] == (pytest.approx(40e-6), "hydra:staging")
    assert tr.gaps[1] == (pytest.approx(30e-6), "hydra:staging")
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(70e-6)]
    assert len(b["idle_gaps"]) <= 10


@pytest.mark.cuda
def test_command_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the command measures the card")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "h1c_main",
         "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", "1"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["metrics"]["megachain_roofline"]["value"] <= 100
