"""Time-dependent flags over several devices in one process
(``runner.run_baselines(mesh_devices=...)`` with ``flags_tf``), on the CPU,
held against the port's own one-device runs: every signature's
(baseline x chain) rows split over three CPU shards in blocks of whole
chains give the files, results and checkpoints of one device, on grouped
megachain (signatures of G = 4 and G = 2 time groups, so a chain's G rows
fall beside a shard edge), on the grouped real engine (11 flag patterns)
and on the complex engine; a run checkpointed on three devices resumes on
one. ``tests/test_torch_tflags.py`` and ``test_torch_fallback_runner.py``
hold the one-device paths against the JAX package, so no JAX runs here.
Also the CLI's devices: in one process it hands the runner every local
card. Tiny shapes: 12 times x 16 channels, 2 modes, 4 iterations."""
from pathlib import Path

import numpy as np
import pytest
import torch

from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.cli import run as tcli
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.parallel import dist
from hydra_pspec_torch.utils import io as tio
from hydra_pspec_torch.utils import uvh5 as tuv

NT, NF, NM = 12, 16, 2
THREE = ["cpu"] * 3


def _signature(kind):
    """Flag arrays: ``"G4"`` has 4 time groups, ``"G2"`` 2, ``"P11"`` 11
    (channel r + 2 flagged from time r on, r = 1..10)."""
    f = np.zeros((NT, NF), dtype=bool)
    if kind == "G4":
        f[2:5, 3] = f[6:9, 9:11] = f[10:, 5] = True
    elif kind == "G2":
        f[4:8, 12] = True
    else:
        for r in range(1, 11):
            f[r:, r + 2] = True
    return f


def _jobs(root, kinds, seed=3):
    """A baseline per entry of ``kinds``, its flags that signature's."""
    rng = np.random.default_rng(seed)
    crandn = lambda *s: (rng.standard_normal(s)
                         + 1j * rng.standard_normal(s)) / np.sqrt(2)
    return [trunner.BaselineJob(
        antpair=(0, b + 1), d=crandn(NT, NF) * 2.0, w=np.ones(NF),
        fgmodes=crandn(NF, NM), S_initial=np.abs(
            rng.standard_normal(NF)) * 10.0 + 0.5,
        Ninv=np.abs(rng.standard_normal(NF)) + 1.0,
        flags_tf=_signature(k),
        out_dir=None if root is None else Path(root) / f"0-{b + 1}")
        for b, k in enumerate(kinds)]


def _prior():
    prior = np.zeros((2, NF))
    prior[0, 7:10], prior[1, 7:10] = 300.0, 0.5
    return prior


def _same_files(a, b, nbl, nchains):
    for bl in range(1, nbl + 1):
        for c in range(nchains):
            for name in tio.SAMPLE_FILENAMES.values():
                pa = trunner._chain_dir(Path(a) / f"0-{bl}", c, nchains)
                pb = trunner._chain_dir(Path(b) / f"0-{bl}", c, nchains)
                pa, pb = pa / name, pb / name
                assert pa.read_bytes() == pb.read_bytes(), (bl, c, name)


def _same_results(r1, r2):
    assert len(r1) == len(r2)
    for a, b in zip(r1, r2):
        assert (a.antpair, a.chain) == (b.antpair, b.chain)
        for k in ("signal_ps", "ln_post", "chisq", "signal_cr", "fg_amps"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k


# 3 G4 baselines x 2 chains (6 chains: 2, 2, 2 over the shards) and 2 G2
# baselines (4 chains: 2, 1, 1); 2 baselines of 11 patterns (real engine)
CASES = {"megachain": (["G4", "G2", "G4", "G2", "G4"], "auto", 2),
         "real": (["P11", "P11"], "auto", 2),
         "complex": (["G4", "G2", "G4"], "complex", 1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tflags_shards_equal_one_device(tmp_path, case):
    """``mesh_devices=["cpu"] * 3`` writes every sample file, result and
    per-signature checkpoint of the one-device run bit for bit, on the
    engine the run routes to."""
    kinds, engine, nchains = CASES[case]
    kw = dict(device="cpu", seed=11, write_niter=2, nchains=nchains,
              engine=engine)
    r1, t1 = trunner.run_baselines(_jobs(tmp_path / "one", kinds), _prior(),
                                   4, **kw)
    r3, t3 = trunner.run_baselines(_jobs(tmp_path / "three", kinds),
                                   _prior(), 4, mesh_devices=THREE, **kw)
    assert t1["engine"] == t3["engine"] == case
    assert t3["device"] == ("cpu" if case == "complex" else "cpu, cpu, cpu")
    _same_results(r1, r3)
    _same_files(tmp_path / "one", tmp_path / "three", len(kinds), nchains)
    nsig = len(kinds) if case == "complex" else len(set(kinds))
    for si in range(nsig):
        a = tio.load_checkpoint(tmp_path / "one", tag=f"-tf{si}")
        b = tio.load_checkpoint(tmp_path / "three", tag=f"-tf{si}")
        assert a["iteration"] == b["iteration"] == 4
        assert np.array_equal(a["ps"], b["ps"])
    if case == "megachain":
        groups = {k: len(ttf.group_flag_patterns(_signature(k)))
                  for k in ("G4", "G2")}
        assert groups == {"G4": 4, "G2": 2}
    if case == "real":
        assert len(ttf.group_flag_patterns(_signature("P11"))) == 11


def test_tflags_checkpoint_on_three_resumes_on_one(tmp_path):
    """A grouped megachain run stopped at 2 on three devices and resumed to
    4 on one writes the files of the one-device run, and so does the
    reverse."""
    kinds = ["G4", "G2", "G4"]
    kw = dict(device="cpu", seed=11, write_niter=2, nchains=2)
    trunner.run_baselines(_jobs(tmp_path / "one", kinds), _prior(), 4, **kw)
    for name, first, then in (("a", THREE, None), ("b", None, THREE)):
        jobs = _jobs(tmp_path / name, kinds)
        trunner.run_baselines(jobs, _prior(), 2, mesh_devices=first, **kw)
        _, tim = trunner.run_baselines(jobs, _prior(), 4, resume=True,
                                       mesh_devices=then, **kw)
        assert tim["start_iter"] == 2
        _same_files(tmp_path / "one", tmp_path / name, len(kinds), 2)


def test_tflags_shards_policy():
    """More devices than chains leaves the extra devices idle; external
    randomness over more than one device is refused."""
    kinds = ["G2"]
    kw = dict(device="cpu", seed=11, write_niter=2, nchains=1)
    r1, _ = trunner.run_baselines(_jobs(None, kinds), _prior(), 2, **kw)
    r3, t3 = trunner.run_baselines(_jobs(None, kinds), _prior(), 2,
                                   mesh_devices=THREE, **kw)
    assert t3["device"] == "cpu"
    _same_results(r1, r3)
    with pytest.raises(ValueError, match="one device"):
        trunner.run_baselines(_jobs(None, kinds), _prior(), 2,
                              mesh_devices=THREE,
                              randomness=lambda it, k, **s: {}, **kw)


class _Stop(Exception):
    pass


def test_cli_one_process_uses_every_card(tmp_path, monkeypatch):
    """``cli.run.main`` in one process on ``"cuda"`` passes every local card
    (three here, ``torch.cuda.device_count`` patched) to the runner as
    ``mesh_devices``, the first as ``device``; an explicit ``cuda:1``, and
    a rank of ``--num_processes 2``, pass their one card; ``"cpu"`` stays
    on the CPU. The runner is recorded, not run."""
    rng = np.random.default_rng(1)
    fp = tmp_path / "data.uvh5"
    tuv.write_uvh5(fp, {(1, 2 + b): rng.standard_normal((NT, NF)) + 0j
                        for b in range(3)},
                   freqs_hz=1e8 + np.arange(NF) * 1e5)
    seen = []

    def record(jobs, prior, niter, **kw):
        seen.append((str(kw["device"]),
                     [str(d) for d in kw["mesh_devices"] or []]))
        raise _Stop

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(tcli, "run_baselines", record)
    monkeypatch.setattr(dist, "initialize_distributed", lambda *a: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    argv = [str(fp), "--out_dir", str(tmp_path), "--dirname", "res",
            "--Niter", "2", "--Nfgmodes", "2"]
    rank1 = ["--num_processes", "2", "--process_id", "1", "--coordinator",
             "localhost:1"]
    for extra, device in (([], "cuda"), ([], "cuda:1"), (rank1, "cuda"),
                          ([], "cpu")):
        with pytest.raises(_Stop):
            tcli.main(argv + extra, device=device)
    assert seen == [("cuda:0", ["cuda:0", "cuda:1", "cuda:2"]),
                    ("cuda:1", []), ("cuda:1", []), ("cpu", [])]
