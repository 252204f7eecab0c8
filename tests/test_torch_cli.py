"""The port's production entry point against the JAX package's: the CLI
(``hydra_pspec_torch/cli/run.py``), its configuration, uvh5, partition and
provenance modules, and the runner's host side (the overlapped chunk loop
with the native writer) against the serial composition. No JAX Pallas
kernel runs here: the JAX side is its host code and its CLI's complex
engine."""
import json
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.cli import run as jcli
from hydra_pspec_tpu.parallel import partition as jpart
from hydra_pspec_tpu.utils import config as jconfig
from hydra_pspec_tpu.utils import provenance as jprov
from hydra_pspec_tpu.utils import uvh5 as juv
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.cli import run as tcli
from hydra_pspec_torch.parallel import partition as tpart
from hydra_pspec_torch.utils import config as tconfig
from hydra_pspec_torch.utils import io as tio
from hydra_pspec_torch.utils import provenance as tprov
from hydra_pspec_torch.utils import uvh5 as tuv
from test_multihost import _write_inputs

NT, NF = 8, 16


def _argv(fp, out_dir, *extra):
    # tests/test_multihost.py::_argv: 3 baselines, 8 x 16, 4 iterations
    return [str(fp), "--out_dir", str(out_dir), "--dirname", "res",
            "--Niter", "4", "--write_Niter", "2", "--seed", "7",
            "--Nfgmodes", "2", *extra]


def _aux_inputs(tmp, bl_strs):
    """Per-baseline directories of noise, nsamples, flags (with a time
    dependence), noise covariances and foreground modes, and one shared
    initial covariance file, for the uvh5 file of :func:`_write_inputs`."""
    rng = np.random.default_rng(3)
    freq = "100.000-101.500MHz"
    for bl in bl_strs:
        for name, arr in {
            "noise": rng.standard_normal((NT, NF))
            + 1j * rng.standard_normal((NT, NF)),
            "nsamples": rng.integers(1, 5, size=(NT, NF)).astype(float),
            "flags": rng.random((NT, NF)) < 0.1,
            "ncov": np.diag(rng.random(NF) + 0.5),
            "fg": rng.standard_normal((NF, 4)),
        }.items():
            d = tmp / name / bl
            d.mkdir(parents=True, exist_ok=True)
            np.save(d / (f"evecs-{freq}.npy" if name == "fg"
                         else f"{name}.npy"), arr)
    np.save(tmp / "sigcov0.npy", np.eye(NF) * 2.0)
    return dict(noise=str(tmp / "noise"), noise_file="noise.npy",
                nsamples=str(tmp / "nsamples"), nsamples_file="nsamples.npy",
                flags=str(tmp / "flags"), flags_file="flags.npy",
                noise_cov=str(tmp / "ncov"), noise_cov_file="ncov.npy",
                fgmodes=str(tmp / "fg"), sigcov0=str(tmp / "sigcov0.npy"),
                Nfgmodes=3)


def _equal_jobs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.antpair == w.antpair and g.out_dir == w.out_dir
        for k in ("d", "w", "fgmodes", "S_initial", "Ninv", "flags_tf"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("time_flags", [False, True])
def test_prepare_jobs_equals_jax(tmp_path, time_flags):
    """The same jobs, exactly, from the same uvh5 file and auxiliary
    directories: noise scaled by nsamples, flags, dense noise covariance,
    per-baseline foreground modes by their default name, and per-time
    flags."""
    fp, bl_strs = _write_inputs(tmp_path)
    raw = dict(_aux_inputs(tmp_path, bl_strs), file_paths=[str(fp)],
               time_flags=time_flags, out_dir=str(tmp_path))
    out = tmp_path / "res"
    tj = tcli.prepare_jobs(tconfig.RunConfig.from_dict(raw), out)
    jj = jcli.prepare_jobs(jconfig.RunConfig.from_dict(raw), out)
    _equal_jobs(tj[0], jj[0])
    assert tj[1:3] == jj[1:3] and tj[4] == jj[4]
    # a rank-local block
    tj = tcli.prepare_jobs(tconfig.RunConfig.from_dict(raw), out, 1, 2)
    jj = jcli.prepare_jobs(jconfig.RunConfig.from_dict(raw), out, 1, 2)
    _equal_jobs(tj[0], jj[0])
    assert tj[4] == jj[4] == [2]


def _config_case(tmp):
    a = {f.name: f.default for f in fields(tconfig.RunConfig)
         if f.name != "file_paths"}
    b = {f.name: f.default for f in fields(jconfig.RunConfig)
         if f.name != "file_paths"}
    assert a == b
    raw = {"file_paths": ["vis.uvh5"], "noise": "n.npy", "Niter": 7,
           "out_dir": "out", "engine": "megachain"}
    (tmp / "c.yaml").write_text(
        "\n".join(f"{k}: {json.dumps(v)}" for k, v in raw.items()))
    for build in (lambda m: m.RunConfig.from_dict(raw, Nfgmodes=3),
                  lambda m: m.RunConfig.from_dict(raw, base_dir=tmp),
                  lambda m: m.RunConfig.from_yaml(tmp / "c.yaml", seed=4)):
        assert build(tconfig).to_dict() == build(jconfig).to_dict()
    for m in (tconfig, jconfig):
        with pytest.raises(ValueError, match="Unknown config keys"):
            m.RunConfig.from_dict({"Niterr": 3})


def _resolve_case(tmp):
    (tmp / "1-2").mkdir()
    np.save(tmp / "1-2" / "noise.npy", np.arange(3.0))
    np.save(tmp / "shared.npy", np.ones(2))
    for args in ((str(tmp), "noise.npy", "1-2"),
                 (str(tmp / "shared.npy"), None, "1-2"),
                 # the compatibility fallback: a missing file beside a
                 # per-baseline directory holding it
                 (str(tmp / "noise.npy"), None, "1-2"),
                 (None, "x.npy", "1-2")):
        got = tconfig.resolve_per_baseline(*args)
        want = jconfig.resolve_per_baseline(*args)
        assert (got is None and want is None) or np.array_equal(got, want)
    assert tconfig.check_load_path(tmp)[0] is True
    for m in (tconfig, jconfig):
        with pytest.raises(ValueError, match="Need a filename"):
            m.resolve_per_baseline(str(tmp), None, "1-2")


def _partition_case(tmp):
    for n in (3, 7, 10):
        for r in (1, 2, 3):
            assert tpart.split_for_ranks(list(range(n)), r) == \
                jpart.split_for_ranks(list(range(n)), r)
            for p in range(r):
                assert tpart.local_indices(n, p, r) == \
                    jpart.local_indices(n, p, r)
            for ndev, nch in ((4, 1), (8, 3)):
                assert tpart.padded_baseline_slots(n, r, ndev, nch) == \
                    jpart.padded_baseline_slots(n, r, ndev, nch)
    for m in (tpart, jpart):
        with pytest.raises(ValueError):
            m.split_for_ranks([1], 2)


def _uvh5_case(tmp):
    for s in ("cross", "all", "", " 1_2,3_4 "):
        assert tuv.parse_ant_str(s) == juv.parse_ant_str(s)
    f = 100.0 + np.arange(16) * 0.1
    for s in ("100.2-100.9", "100.31,101", "100.5"):
        assert np.array_equal(tuv.filter_freqs(s, f), juv.filter_freqs(s, f))
    rng = np.random.default_rng(1)
    w = (rng.random(9) > 0.3).astype(float)
    for x in (rng.random(9), rng.random((9, 9))):
        assert np.array_equal(tuv.trim_flagged_channels(w, x),
                              juv.trim_flagged_channels(w, x))
    fl = rng.random((5, 9)) < 0.2
    assert np.array_equal(tuv.collapse_flags_any_time(fl),
                          juv.collapse_flags_any_time(fl))
    a, b = rng.random(4), rng.random(4)
    assert np.array_equal(tuv.form_pseudo_stokes(a, b, -1.0),
                          juv.form_pseudo_stokes(a, b, -1.0))
    # the port's writer read by both readers, two polarizations, flags
    vis = {p: rng.standard_normal((NT, NF)) + 1j * rng.standard_normal(
        (NT, NF)) for p in ((2, 1), (1, 3))}
    flags = {p: rng.random((NT, NF)) < 0.1 for p in vis}
    fp = tuv.write_uvh5(tmp / "t.uvh5", vis, 1e8 + np.arange(NF) * 1e5,
                        pols=("xx", "yy"), flags_by_baseline=flags)
    for kw in ({}, {"antpairs": [(1, 3)], "freq_range": "100.2-100.9"}):
        got, fg = tuv.read_uvh5(fp, **kw)
        want, fw = juv.read_uvh5(fp, **kw)
        assert np.array_equal(fg, fw) and len(got) == len(want)
        for g, w_ in zip(got, want):
            assert g.antpair == w_.antpair
            for k in ("vis", "flags", "nsamples", "freqs", "times", "lsts",
                      "uvw"):
                assert np.array_equal(getattr(g, k), getattr(w_, k)), k


def _provenance_case(tmp, monkeypatch):
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    for m, d in ((tprov, tmp / "t"), (jprov, tmp / "j")):
        d.mkdir()
        m.write_git_json(d)
        m.write_args_json(d, {"Niter": 3, "out": Path("x")})
        m.write_timings_json(d, num_ranks=1, num_baselines=2, load_data=0.1,
                             scatter=0.2, process=0.3, barrier=0.0,
                             total=0.7, write_data=[{"rank": 0}])
        m.write_rhat_json(d, [[("1_2", np.array([1.01, 1.2, np.nan]))]])
        m.write_resources_json(d)
        m.touch_slurm_job_file(d)
    names = sorted(p.name for p in (tmp / "t").iterdir())
    assert names == sorted(p.name for p in (tmp / "j").iterdir())
    assert "4242" in names
    for name in ("args.json", "timings.json", "rhat.json"):
        assert (tmp / "t" / name).read_text() == \
            (tmp / "j" / name).read_text(), name
    for name in ("git.json", "resources.json"):
        assert json.loads((tmp / "t" / name).read_text()).keys() == \
            json.loads((tmp / "j" / name).read_text()).keys(), name
    assert tprov.get_git_version_info().keys() == \
        jprov.get_git_version_info().keys()


CASES = {"config": _config_case, "resolve_per_baseline": _resolve_case,
         "partition": _partition_case, "uvh5": _uvh5_case,
         "provenance": _provenance_case}


@pytest.mark.parametrize("case", list(CASES))
def test_modules_equal_jax(case, tmp_path, monkeypatch):
    fn = CASES[case]
    fn(tmp_path, monkeypatch) if case == "provenance" else fn(tmp_path)


def _artifacts(res):
    """Relative file names under a results directory, and each JSON
    artifact's key tree (two levels)."""
    names = sorted(str(p.relative_to(res)) for p in res.rglob("*")
                   if p.is_file())
    keys = {}
    for p in res.glob("*.json"):
        obj = json.loads(p.read_text())
        keys[p.name] = {k: sorted(v) if isinstance(v, dict) else None
                        for k, v in obj.items()}
        if p.name == "timings.json":
            keys[p.name]["write_data"] = [sorted(e) for e in
                                          obj["write_data"]]
    return names, keys


def test_main_end_to_end_against_jax_cli(tmp_path):
    """``main(argv, device="cpu")``: the JAX CLI's artifact file names and
    JSON keys; the sample files exactly those of ``run_baselines`` on the
    JAX-prepared jobs; ``profile_dir`` gets the trace; ``--precision x64``
    runs the complex engine with the JAX CLI's files (names, shapes and
    dtypes, complex128 samples); more than one process without a
    coordinator's address raises."""
    fp, bl_strs = _write_inputs(tmp_path)
    prof = tmp_path / "trace"
    assert tcli.main(_argv(fp, tmp_path / "t", "--profile_dir", str(prof)),
                     device="cpu") == 0
    assert jcli.main(_argv(fp, tmp_path / "j")) == 0
    res_t, res_j = tmp_path / "t" / "res", tmp_path / "j" / "res"
    names_t, keys_t = _artifacts(res_t)
    names_j, keys_j = _artifacts(res_j)
    assert names_t == names_j and keys_t == keys_j
    assert json.loads((res_t / "args.json").read_text()).keys() == \
        json.loads((res_j / "args.json").read_text()).keys()
    assert list(prof.glob("chunk-*.trace.json"))

    # the same run through the runner on the JAX package's jobs
    cfg = jconfig.RunConfig.from_dict(dict(
        file_paths=[str(fp)], Nfgmodes=2, out_dir=str(tmp_path)))
    jjobs, nfreqs = jcli.prepare_jobs(cfg, tmp_path / "r")[:2]
    jobs = [trunner.BaselineJob(**{f.name: getattr(j, f.name)
                                   for f in fields(trunner.BaselineJob)})
            for j in jjobs]
    trunner.run_baselines(jobs, tcli.build_prior(cfg, nfreqs), 4,
                          device="cpu", seed=7, write_niter=2)
    for bl in bl_strs:
        for name in tio.SAMPLE_FILENAMES.values():
            assert (res_t / bl / name).read_bytes() == \
                (tmp_path / "r" / bl / name).read_bytes(), (bl, name)

    # a default name from the band, and the port's policy
    assert tcli.main(_argv(fp, tmp_path / "t")[:3] + [
        "--Niter", "2", "--write_Niter", "2", "--Nfgmodes", "2"],
        device="cpu") == 0
    assert (tmp_path / "t" / "results-100.000-101.500MHz-Niter-2").is_dir()
    # precision x64: the complex float64 engine, as the JAX CLI runs here
    assert tcli.main(_argv(fp, tmp_path / "x", "--precision", "x64"),
                     device="cpu") == 0
    res_x = tmp_path / "x" / "res"
    assert _artifacts(res_x) == (names_j, keys_j)
    for bl in bl_strs:
        for name in tio.SAMPLE_FILENAMES.values():
            a, b = np.load(res_x / bl / name), np.load(res_j / bl / name)
            assert (a.shape, a.dtype) == (b.shape, b.dtype), (bl, name)
    assert np.load(res_x / bl_strs[0] / "gcr-eor.npy").dtype == np.complex128
    with pytest.raises(ValueError, match="coordinator"):
        tcli.main(_argv(fp, tmp_path / "x", "--num_processes", "2"),
                  device="cpu")


def _jobs(root, nbl=3, nt=10, nf=16, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(nbl):
        d = rng.standard_normal((nt, nf)) + 1j * rng.standard_normal((nt, nf))
        out.append(trunner.BaselineJob(
            (0, b + 1), d * 2.0, np.ones(nf),
            rng.standard_normal((nf, 2)) + 0j, np.ones(nf) * 5.0,
            np.abs(rng.standard_normal(nf)) + 1.0,
            out_dir=root / f"0-{b + 1}"))
    return out


class _RecordingWriter:
    """np.save behind the writer's API, logging every call."""

    log = []

    def __init__(self, nthreads=None):
        self.is_native = False

    def save(self, path, arr):
        self.log.append(("save", Path(path).name))
        np.save(path, np.ascontiguousarray(arr))

    def wait(self):
        self.log.append(("wait",))
        return 0

    def write_seconds(self):
        return 0.0

    def close(self):
        self.log.append(("close",))


@pytest.mark.parametrize("engine", ["megachain", "mega", "real"])
def test_overlapped_loop_equals_serial(tmp_path, monkeypatch, engine):
    """The overlapped loop (chunk i+1 dispatched before chunk i is fetched,
    flushed and checkpointed) writes the files and returns the results of
    the serial loop, bit for bit; with a recording writer, every checkpoint
    follows a ``wait()`` after the last file of its flush, each chunk's
    flush comes after the next chunk's dispatch, and the checkpoint holds
    the state of its own chunk."""
    prior = np.zeros((2, 16))
    prior[0, 7:10], prior[1, 7:10] = 300.0, 0.5
    kw = dict(device="cpu", seed=5, write_niter=3, engine=engine)
    res_s, tim_s = trunner.run_baselines(_jobs(tmp_path / "s"), prior, 8,
                                         overlap=False, **kw)
    log = _RecordingWriter.log
    log.clear()
    monkeypatch.setattr(trunner, "AsyncNpyWriter", _RecordingWriter)
    saved = []
    real_ck = trunner.hio.save_checkpoint

    def save_checkpoint(run_dir, **ck):
        log.append(("checkpoint", ck["iteration"]))
        saved.append(ck)
        real_ck(run_dir, **ck)

    monkeypatch.setattr(trunner.hio, "save_checkpoint", save_checkpoint)
    chunks = {"megachain": (trunner.megachain, "run_chain_megachain"),
              "mega": (trunner.mega, "run_chain_mega"),
              "real": (trunner.rgibbs, "run_chain")}[engine]
    run = getattr(*chunks)

    def dispatch(*a, **k):
        log.append(("chunk", k["iter0"]))
        return run(*a, **k)

    monkeypatch.setattr(*chunks, dispatch)
    res_o, tim_o = trunner.run_baselines(_jobs(tmp_path / "o"), prior, 8,
                                         overlap=True, **kw)
    assert tim_o["engine"] == tim_s["engine"] == engine
    for a, b in zip(res_o, res_s):
        for k in ("signal_ps", "ln_post", "chisq", "signal_cr", "fg_amps",
                  "signal_S"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for j in range(3):
        for name in tio.SAMPLE_FILENAMES.values():
            assert (tmp_path / "o" / f"0-{j + 1}" / name).read_bytes() == \
                (tmp_path / "s" / f"0-{j + 1}" / name).read_bytes()
    # chunks of 3, 3, 2: each flush (its six files per row) after the next
    # chunk's dispatch, then a wait, then the checkpoint
    kinds = [e[0] for e in log]
    assert [e for e in log if e[0] == "chunk"] == [("chunk", 0),
                                                   ("chunk", 3),
                                                   ("chunk", 6)]
    assert [e[1] for e in log if e[0] == "checkpoint"] == [3, 6, 8]
    for i, e in enumerate(log):
        if e[0] == "checkpoint":
            last_save = max(j for j in range(i) if kinds[j] == "save")
            assert "wait" in kinds[last_save:i], log
    first_save = kinds.index("save")
    assert kinds[:first_save].count("chunk") == 2
    assert kinds[-1] == "close"
    # each checkpoint holds its own chunk's state: the last bandpowers
    for ck, it in zip(saved, (3, 6, 8)):
        want = np.stack([r.signal_ps[it - 1] for r in res_s])
        assert np.array_equal(ck["ps"], want.astype(ck["ps"].dtype))
    assert tim_o["fetch_wait"] >= 0 and tim_o["write"] > 0


def test_failed_writes_raise(tmp_path, monkeypatch):
    class Failing(_RecordingWriter):
        def wait(self):
            return 2

    monkeypatch.setattr(trunner, "AsyncNpyWriter", Failing)
    with pytest.raises(IOError, match="2 asynchronous sample writes"):
        trunner.run_baselines(_jobs(tmp_path), np.zeros((2, 16)), 4,
                              device="cpu", seed=1, write_niter=2)
    assert not (tmp_path / "checkpoint.npz").exists()


class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _Stream:
    def __init__(self, device=None):
        pass

    def wait_event(self, ev):
        pass


def test_pinned_staging_streams_every_byte(tmp_path, monkeypatch):
    """The card's fetch path on CPU stand-ins for the copy stream, its
    events and pinned memory, with staging buffers of 1000 bytes (every
    field crosses in several pieces, ragged at its end): the files of the
    serial loop, bit for bit, and 2 x 1000 staging bytes."""
    import contextlib

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    monkeypatch.setattr(trunner, "STAGING_PIECE_BYTES", 1000)
    init = trunner._Fetch.__init__

    def pinned_on_cpu(self, device, pinned, nslots=2):
        init(self, device, False, nslots)
        self.pinned, self.stream = pinned, _Stream()

    monkeypatch.setattr(trunner._Fetch, "__init__", pinned_on_cpu)
    kw = dict(device="cpu", seed=3, write_niter=3)
    for engine in ("megachain", "real"):
        _, tim = trunner.run_baselines(_jobs(tmp_path / engine / "p"),
                                       np.zeros((2, 16)), 7, engine=engine,
                                       overlap=True, **kw)
        trunner.run_baselines(_jobs(tmp_path / engine / "s"),
                              np.zeros((2, 16)), 7, engine=engine,
                              overlap=False, **kw)
        assert tim["pinned_bytes"] == 2000 and tim["staging"] > 0
        for j in range(3):
            for name in tio.SAMPLE_FILENAMES.values():
                got = tmp_path / engine / "p" / f"0-{j + 1}" / name
                want = tmp_path / engine / "s" / f"0-{j + 1}" / name
                assert got.read_bytes() == want.read_bytes(), (engine, name)


def test_graph_slots_capture_ahead(monkeypatch):
    """Chunk i replays the graphs of slot i % 2; a key's first use
    captures it in both slots (each from its own body) unless no later
    chunk of the key follows, and a captured graph is replayed, never
    captured again (a stand-in for the CUDA graph)."""
    from hydra_pspec_torch.ops.kernels import graph

    made = []

    class Captured:
        def __init__(self, body, ps, k_total):
            made.append(self)
            self.body, self.k_total, self.replays = body, k_total, []

        def replay(self, ps, iter0):
            self.replays.append(iter0)
            return self.body

    monkeypatch.setattr(graph, "ChunkGraph", Captured)
    slots = graph.GraphSlots(2)
    body = iter(range(100))
    run = lambda i, key, ahead=True: graph.replay_chunk(
        slots.cache(i, ahead), key, lambda: next(body), None, 4, 10 * i)
    assert run(0, "k4") == 0 and len(made) == 2   # both slots at once
    assert run(1, "k4") == 1 and run(2, "k4") == 0 and run(3, "k4") == 1
    assert run(4, "k2", ahead=False) == 2 and len(made) == 3
    assert "k2" in slots.caches[0] and "k2" not in slots.caches[1]
    assert [g.replays for g in made] == [[0, 20], [10, 30], [40]]
    # a plain dict (one graph per key) is unchanged
    plain = {}
    graph.replay_chunk(plain, "k", lambda: "b", None, 4, 0)
    assert list(plain) == ["k"] and len(made) == 4


@pytest.mark.cuda
def test_two_graph_slots_on_card(tmp_path):
    """On the card: the overlapped loop (chunk graphs in two alternating
    slots, pinned staging on a copy stream) writes the files of the serial
    eager loop, bit for bit, over four chunks (each slot replayed twice),
    and its resume from the second chunk too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    prior = np.zeros((2, 16))
    prior[0, 7:10], prior[1, 7:10] = 300.0, 0.5
    kw = dict(device="cuda", seed=5, write_niter=3, warm_ns=3,
              drift_max=0.6)
    _, tim = trunner.run_baselines(_jobs(tmp_path / "o"), prior, 12,
                                   overlap=True, **kw)
    trunner.run_baselines(_jobs(tmp_path / "s"), prior, 12, overlap=False,
                          **kw)
    assert all(b > 0 for b in tim["graph_pool_bytes"])
    assert tim["pinned_bytes"] > 0 and tim["is_native"]
    trunner.run_baselines(_jobs(tmp_path / "r"), prior, 6, **kw)
    trunner.run_baselines(_jobs(tmp_path / "r"), prior, 12, resume=True,
                          **kw)
    for j in range(3):
        for name in tio.SAMPLE_FILENAMES.values():
            want = (tmp_path / "s" / f"0-{j + 1}" / name).read_bytes()
            for got in ("o", "r"):
                assert (tmp_path / got / f"0-{j + 1}" / name
                        ).read_bytes() == want, (got, name)
