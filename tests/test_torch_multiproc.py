"""Multi-process and multi-device runs of the port (``parallel/dist.py``,
``runner.run_baselines(process_id=, num_processes=, mesh_devices=)``, the
CLI's ``--num_processes``), on the CPU over gloo, held against the port's
own one-process, one-device runs: ``tests/test_torch_cli.py`` already
holds the one-process CLI against the JAX CLI, so no JAX worker process
starts here. Tiny shapes: 8 times x 16 channels, 2 modes, 4 iterations."""
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.cli import run as jcli
from hydra_pspec_torch import entry
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.cli import run as tcli
from hydra_pspec_torch.parallel import dist
from hydra_pspec_torch.utils import io as tio
from hydra_pspec_torch.utils import uvh5 as tuv
from hydra_pspec_torch.utils.config import RunConfig

REPO = Path(__file__).resolve().parents[1]
NT, NF = 8, 16


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(tmp, nbl=3):
    """A uvh5 file of ``nbl`` baselines and one time-dependent flag array
    shared by all of them (one flag signature)."""
    rng = np.random.default_rng(42)
    pairs = [(1, 2 + b) for b in range(nbl)]
    fp = tmp / "data.uvh5"
    tuv.write_uvh5(fp, {p: rng.standard_normal((NT, NF))
                        + 1j * rng.standard_normal((NT, NF)) for p in pairs},
                   freqs_hz=1e8 + np.arange(NF) * 1e5)
    flags = np.zeros((NT, NF), dtype=bool)
    flags[2:5, 3] = flags[6, 9:11] = True
    np.save(tmp / "flags.npy", flags)
    return fp, [f"{a}-{b}" for a, b in pairs]


def _argv(fp, out, *extra, niter=4):
    return [str(fp), "--out_dir", str(out), "--dirname", "res", "--Niter",
            str(niter), "--write_Niter", "2", "--seed", "7", "--Nfgmodes",
            "2", "--nchains", "2", *extra]


def _same_files(a, b, bl_strs, nchains=2):
    for bl in bl_strs:
        for c in range(nchains):
            for name in tio.SAMPLE_FILENAMES.values():
                pa = Path(a) / bl / f"chain-{c}" / name
                pb = Path(b) / bl / f"chain-{c}" / name
                assert pa.read_bytes() == pb.read_bytes(), (bl, c, name)


def _workers(runs):
    """Two ranks, each a ``python -c`` process running ``main(argv,
    device='cpu')`` for every argv of ``runs`` in turn, each run with a
    process group of its own."""
    procs = []
    for pid in range(2):
        argvs = [argv + ["--num_processes", "2", "--process_id", str(pid),
                         "--coordinator", f"localhost:{port}"]
                 for argv, port in runs]
        code = ("from hydra_pspec_torch.cli.run import main\n"
                f"for a in {argvs!r}:\n    main(a, device='cpu')\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so}\n{se}"


def test_two_processes_equal_one(tmp_path):
    """Two gloo processes through the CLI (3 baselines x 2 chains: 2 on
    rank 0, 1 on rank 1) write every sample file bit-identical to the
    one-process run, with the per-process checkpoints, ``timings.json``
    over 2 ranks and the gathered ``rhat.json``; a two-process run stopped
    at 2 and resumed to 4 equals it too; so does the time-flags path with
    one signature split across the ranks."""
    fp, bls = _inputs(tmp_path)
    tf = ["--time_flags", "--flags", str(tmp_path / "flags.npy")]
    one, one_tf = tmp_path / "one", tmp_path / "one-tf"
    assert tcli.main(_argv(fp, one), device="cpu") == 0
    assert tcli.main(_argv(fp, one_tf, *tf), device="cpu") == 0
    two, res, two_tf = tmp_path / "two", tmp_path / "res", tmp_path / "tf"
    _workers([(_argv(fp, two), _free_port()),
              (_argv(fp, res, niter=2), _free_port()),
              (_argv(fp, res, "--resume"), _free_port()),
              (_argv(fp, two_tf, *tf), _free_port())])

    _same_files(one / "res", two / "res", bls)
    _same_files(one / "res", res / "res", bls)
    _same_files(one_tf / "res", two_tf / "res", bls)
    got = sorted(p.name for p in (two / "res").iterdir())
    assert got == sorted(bls + ["args.json", "checkpoint-p0.npz",
                                "checkpoint-p1.npz", "git.json",
                                "resources.json", "rhat.json",
                                "timings.json"])
    tj = json.loads((two / "res" / "timings.json").read_text())
    assert tj["num_ranks"] == 2 and tj["num_baselines"] == 3
    assert [e["ant_pairs"] for e in tj["write_data"]] == [["1_2", "1_3"],
                                                          ["1_4"]]
    rhat = json.loads((two / "res" / "rhat.json").read_text())
    want = json.loads((one / "res" / "rhat.json").read_text())
    assert rhat == want
    for pid, n in ((0, 2), (1, 1)):
        ck = tio.load_checkpoint(res / "res", tag=f"-p{pid}")
        assert ck["iteration"] == 4 and ck["ps"].shape == (2 * n, NF)
    assert (two_tf / "res" / "checkpoint-tf0-p1.npz").exists()


def test_global_ids_key_the_streams(tmp_path):
    """Rank 1's block of five baselines (global ids 3 and 4), run alone in
    one process through ``run_jobs`` with the ids ``prepare_jobs`` gives,
    writes the files of baselines 3 and 4 of the one-process run of all
    five: the streams are keyed on the global ids, not on the block's
    positions."""
    fp, bls = _inputs(tmp_path, nbl=5)
    cfg = RunConfig.from_dict(dict(
        file_paths=[str(fp)], Nfgmodes=2, Niter=4, write_Niter=2, seed=7,
        nchains=2))
    full = tmp_path / "full"
    jobs, nf, nbl, t_load, ids = tcli.prepare_jobs(cfg, full)
    tcli.run_jobs(cfg, jobs, nf, nbl, t_load, full, device="cpu",
                  global_baseline_ids=ids)
    block = tmp_path / "block"
    jobs, nf, nbl, t_load, ids = tcli.prepare_jobs(cfg, block, process_id=1,
                                                   num_processes=2)
    assert ids == [3, 4] and nbl == 5
    assert [j.antpair for j in jobs] == [(1, 5), (1, 6)]
    tcli.run_jobs(cfg, jobs, nf, nbl, t_load, block, device="cpu",
                  global_baseline_ids=ids)
    _same_files(full, block, bls[3:])


def _jobs(root, nbl=3, seed=2, flags_tf=False):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(nbl):
        d = rng.standard_normal((NT, NF)) + 1j * rng.standard_normal((NT, NF))
        f = None
        if flags_tf:
            f = np.zeros((NT, NF), dtype=bool)
            f[1:3, 4] = True
        out.append(trunner.BaselineJob(
            (0, b + 1), d * 2.0, np.ones(NF),
            rng.standard_normal((NF, 2)) + 0j, np.eye(NF),
            np.ones(NF) * 5.0, flags_tf=f,
            out_dir=None if root is None else root / f"0-{b + 1}"))
    return out


def _prior():
    prior = np.zeros((2, NF))
    prior[0, 7:10], prior[1, 7:10] = 300.0, 0.5
    return prior


@pytest.mark.parametrize("engine", ["megachain", "mega", "real", "complex"])
def test_mesh_devices_equal_one_device(tmp_path, monkeypatch, engine):
    """``mesh_devices=["cpu"] * 3``: 3 baselines x 2 chains split 2, 2, 2
    over three shards give the results, files and checkpoint of one
    device, on every engine of the plain path; a sharded run stopped at 2
    and resumed on the shards equals them too. A finished run's shards are
    freed without the garbage collector (a cycle would hold their chunk
    graphs' memory until its next pass); a graph cache whose slots were
    freed says so."""
    kw = dict(device="cpu", seed=5, write_niter=2, nchains=2, engine=engine)
    res1, tim1 = trunner.run_baselines(_jobs(tmp_path / "one"), _prior(), 4,
                                       **kw)
    shards, init = [], trunner._Shard.__init__

    def tracked(self, *a, **k):
        init(self, *a, **k)
        shards.append(weakref.ref(self))

    monkeypatch.setattr(trunner._Shard, "__init__", tracked)
    gc.disable()
    try:
        res3, tim3 = trunner.run_baselines(_jobs(tmp_path / "three"),
                                           _prior(), 4,
                                           mesh_devices=["cpu"] * 3, **kw)
        assert len(shards) == 3 and all(r() is None for r in shards)
        slots = trunner.GraphSlots(2)
        cache = slots.cache(0)
        cache["key"] = "graph"
        ref = weakref.ref(slots)
        del slots
        assert ref() is None
        with pytest.raises(RuntimeError, match="GraphSlots was freed"):
            cache.slots
    finally:
        gc.enable()
    assert tim1["engine"] == tim3["engine"] == engine
    assert tim3["device"] == "cpu, cpu, cpu"
    for a, b in zip(res1, res3):
        for k in ("signal_ps", "ln_post", "chisq", "signal_cr", "fg_amps"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    ck1 = tio.load_checkpoint(tmp_path / "one")
    ck3 = tio.load_checkpoint(tmp_path / "three")
    assert np.array_equal(ck1["ps"], ck3["ps"])
    part = _jobs(tmp_path / "part")
    trunner.run_baselines(part, _prior(), 2, mesh_devices=["cpu"] * 3, **kw)
    _, tim = trunner.run_baselines(part, _prior(), 4, resume=True,
                                   mesh_devices=["cpu"] * 2, **kw)
    assert tim["start_iter"] == 2
    for j1, jp in zip(_jobs(tmp_path / "one"), part):
        a, b = tio.load_samples(j1.out_dir / "chain-0"), \
            tio.load_samples(jp.out_dir / "chain-0")
        for k in tio.SAMPLE_FILENAMES:
            assert np.array_equal(a[k], b[k]), k


def test_runner_process_policy(tmp_path, capsys):
    """A process's block runs on its own with its global ids and its own
    checkpoint tag; what is refused is refused, and time flags over two
    devices in a process equal one device; the dry run splits the
    megachain path over three devices; ``entry()``'s step runs on the CPU,
    with the iteration as a number and as a device counter."""
    jobs = _jobs(tmp_path / "a")
    kw = dict(device="cpu", seed=5, write_niter=2, nchains=2)
    res_all, _ = trunner.run_baselines(jobs, _prior(), 2, **kw)
    block = [dataclasses.replace(j, out_dir=tmp_path / "b" / j.out_dir.name)
             for j in jobs[1:]]
    res_b, _ = trunner.run_baselines(block, _prior(), 2, process_id=1,
                                     num_processes=2, n_global_baselines=3,
                                     global_baseline_ids=[1, 2], **kw)
    for a, b in zip(res_all[2:], res_b):
        assert np.array_equal(a.signal_ps, b.signal_ps)
    assert tio.load_checkpoint(tmp_path / "b", tag="-p1")["iteration"] == 2
    assert tio.load_checkpoint(tmp_path / "b") is None
    with pytest.raises(ValueError, match="global_baseline_ids"):
        trunner.run_baselines(block, _prior(), 2, num_processes=2, **kw)
    with pytest.raises(ValueError, match="global_baseline_ids"):
        trunner.run_baselines(block, _prior(), 2, global_baseline_ids=[1, 3],
                              n_global_baselines=3, **kw)
    tjobs = _jobs(None, flags_tf=True)   # time flags over two devices run
    res_one, _ = trunner.run_baselines(tjobs, _prior(), 2, **kw)
    res_two, tim = trunner.run_baselines(tjobs, _prior(), 2,
                                         mesh_devices=["cpu"] * 2, **kw)
    assert tim["device"] == "cpu, cpu"
    for a, b in zip(res_one, res_two):
        assert np.array_equal(a.signal_cr, b.signal_cr)
    with pytest.raises(NotImplementedError, match="one process"):
        trunner.run_baselines(tjobs, _prior(), 2, engine="complex",
                              num_processes=2, global_baseline_ids=[0, 1, 2],
                              **{k: v for k, v in kw.items()})
    entry.dryrun_multichip(3, device="cpu")
    assert "dryrun_multichip OK" in capsys.readouterr().out
    fn, args = entry.entry(device="cpu")   # one real-engine step, 203 x 120
    out = fn(*args)
    assert [tuple(t.shape) for t in out] == [(1, 120), (1,), (1, 120)]
    assert all(t.device.type == "cpu" and bool(torch.isfinite(t).all())
               for t in out)
    # the iteration as a (1,) int32 counter, as a graph replay reads it
    rand = dict(args[0], g=torch.zeros((1,), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(out, fn(rand, *args[1:])))


def test_gather_and_shards_layout():
    """``gather_per_baseline`` with one process returns the JAX CLI's
    ``_gather_per_baseline`` layout, for scalars and arrays; ``shard_rows``
    is the reference's block rule, without padding."""
    jobs = _jobs(None)
    for local in ({"0_1": 1.5, "0_2": 2, "0_3": 0.25},
                  {f"0_{b}": np.arange(4.0) * b for b in (1, 2, 3)}):
        got = dist.gather_per_baseline(local, jobs, 1)
        want = jcli._gather_per_baseline(local, jobs, 3, 1)
        assert [[bl for bl, _ in r] for r in got] == \
            [[bl for bl, _ in r] for r in want]
        for r, w in zip(got, want):
            for (_, a), (_, b) in zip(r, w):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [list(r) for r in dist.shard_rows(7, 3)] == [[0, 1, 2], [3, 4],
                                                        [5, 6]]
    assert [len(r) for r in dist.shard_rows(2, 3)] == [1, 1, 0]
    assert dist.initialize_distributed(None, 1, 0) is False
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize_distributed(None, 2, 0)
    assert str(dist.rank_device("cpu", 3)) == "cpu"
