"""The port's scripts (``hydra_pspec_torch/scripts/``) and the walkthrough
of ``examples/3bl-example-torch/`` on the synthetic problem, on the CPU:
``simple_example`` at a small size; ``make_scaling_data`` then
``calc_vis_cov_matrices`` through uvh5, the latter held against the JAX
package's script on the same file; the scaling harness with two gloo
ranks and with two CPU shards in one process, and the shell launcher,
each writing the files of one rank; ``plot_test_data_results`` on a run's
output; the example's YAML through the CLI. Tiny shapes: 8 times x 16
channels."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hydra_pspec_torch.cli import run as tcli
from hydra_pspec_torch.scripts import (calc_vis_cov_matrices,
                                       make_scaling_data,
                                       plot_test_data_results, scaling_test,
                                       simple_example)
from hydra_pspec_torch.utils.uvh5 import read_uvh5
from hydra_pspec_torch.validation import synth

REPO = Path(__file__).resolve().parents[1]
NT, NF = 8, 16
SMALL = ["--ntimes", str(NT), "--nfreqs", str(NF)]
SWEEP = ["--device", "cpu", "--n", "3", "--niter", "4", "--write_niter", "2",
         "--nchains", "2", *SMALL]


def test_simple_example():
    """One synthetic baseline through ``gibbs_sample_with_fg`` on the CPU:
    finite samples of the run's shape, chi^2 near 1 and the recovered EoR
    power near the truth."""
    got = simple_example.main(["--device", "cpu", "--ntimes", "30",
                               "--nfreqs", "32", "--niter", "40", "--burn",
                               "10"])
    assert got["finite"] and got["signal_ps"].shape == (40, 32)
    assert abs(got["chi2"] - 1.0) < 0.1
    assert 0.5 < got["ratio"] < 2.0


def test_scaling_data_and_cov_matrices(tmp_path):
    """``make_scaling_data`` writes the synthetic baselines to uvh5 exactly,
    with their aux arrays; ``calc_vis_cov_matrices`` on that file writes
    the covariances and eigenmodes of the JAX package's script on the
    same file, and the synthetic baselines in memory give the same
    covariances."""
    data = tmp_path / "data"
    jobs = make_scaling_data.main(["--n", "3", "--out", str(data), *SMALL])
    bls, freqs = read_uvh5(data / "vis.uvh5")
    assert [b.antpair for b in bls] == [j.antpair for j in jobs]
    assert freqs.shape == (NF,)
    for b, j in zip(bls, jobs):
        assert np.array_equal(b.vis, j.d)
        aux = data / "aux" / f"{j.antpair[0]}-{j.antpair[1]}"
        assert np.array_equal(np.load(aux / "noise-cov.npy"), np.eye(NF))
        assert np.array_equal(np.load(aux / "fgmodes.npy"), j.fgmodes)
        assert np.allclose(np.load(aux / "eor-cov.npy"),
                           synth.eor_covariance(NF))
    covs = calc_vis_cov_matrices.main([str(data / "vis.uvh5"), "--out-dir",
                                       str(tmp_path / "prep"), "--eig"])
    subprocess.run([sys.executable, str(REPO / "scripts" /
                                        "calc_vis_cov_matrices.py"),
                    str(data / "vis.uvh5"), "--out-dir",
                    str(tmp_path / "jax"), "--eig"], check=True, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"),
                   capture_output=True)
    names = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*-*/*.npy"))
    assert len(names) == 9
    for name in names:
        assert np.array_equal(np.load(tmp_path / "prep" / name),
                              np.load(tmp_path / "jax" / name)), name
    mem = calc_vis_cov_matrices.synthetic_baselines(3, ntimes=NT, nf=NF)[0]
    for b in mem:
        assert np.array_equal(np.cov(b.vis.T), covs[b.antpair])


def test_scaling_harness(tmp_path, monkeypatch):
    """The sweep over one and two gloo ranks and two CPU shards in one
    process, 3 baselines x 2 chains: every point writes the sample files
    of one rank, its ``timings.json`` beside its run; the table has each
    point's speed-up and efficiency. ``plot_test_data_results`` reads a
    baseline's run against its synthetic truth."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "sweep"
    assert scaling_test.main(["--out", str(out), "--ranks", "1,2",
                              "--device_sweep", "2", *SWEEP]) == 0
    rows, ok = scaling_test.table(out)
    assert ok and [r["point"] for r in rows] == ["ranks-1", "ranks-2",
                                                 "devices-2"]
    assert [(r["processes"], r["devices"]) for r in rows] == [(1, 1), (2, 2),
                                                              (1, 2)]
    assert rows[0]["speedup_process"] == 1.0
    assert all(r["identical"] for r in rows)
    assert len(scaling_test._sample_files(out / "ranks-1" / "res")) == 36
    got = plot_test_data_results.main([
        "--res-dir", str(out / "ranks-1" / "res" / "1-2" / "chain-0"),
        "--baseline", "1", *SMALL])
    assert got["nbins"] == NF and np.isfinite(got["pwm"]).all()
    assert np.allclose(got["dps_true"], synth.delay_spectrum(
        synth.eor_component(1, ntimes=NT, nf=NF)))
    # a point whose files differ is reported
    victim = out / "devices-2" / "res" / "0-1" / "chain-1" / "chisq.npy"
    np.save(victim, np.load(victim) + 1.0)
    assert scaling_test.main(["--table", str(out)]) == 1


@pytest.mark.skipif(shutil.which("bash") is None, reason="needs bash")
def test_scaling_launcher(tmp_path, monkeypatch):
    """``launch_scaling_sweep.sh`` starts the points' processes from the
    shell (one and two ranks on the CPU) and prints the table: every file
    identical to one rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "sh"
    res = subprocess.run(
        ["bash", str(REPO / "hydra_pspec_torch" / "scripts" /
                     "launch_scaling_sweep.sh"), str(out), "1 2",
         *[a for a in SWEEP if a not in ("--device", "cpu")]],
        env=dict(os.environ, DEVICE="cpu", PORT=str(_free_port())),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "identical to ranks-1: True" in res.stdout
    assert (out / "ranks-2" / "timings.json").exists()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_example_walkthrough(tmp_path):
    """``examples/3bl-example-torch/``: its data made by
    ``make_scaling_data``, its YAML through the CLI on the CPU (two
    iterations), the results where the walkthrough reads them."""
    ex = REPO / "examples" / "3bl-example-torch"
    shutil.copy(ex / "config-3bl.yaml", tmp_path / "config-3bl.yaml")
    make_scaling_data.main(["--n", "3", "--out", str(tmp_path / "data"),
                            *SMALL])
    assert tcli.main(["--config", str(tmp_path / "config-3bl.yaml"),
                      "--Niter", "2", "--write_Niter", "2", "--no-verbose"],
                     device="cpu") == 0
    res = tmp_path / "out" / "results-3bl-seed-7123689"
    for bl in ("0-1", "1-2", "2-3"):
        assert np.load(res / bl / "dps-eor.npy").shape == (2, NF)
    assert (res / "timings.json").exists()
