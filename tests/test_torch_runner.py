"""The port's run_baselines (CPU, plain kernel versions) against the JAX
runner's megachain engine, and the runner's own contracts: output files,
checkpoint/resume, and subset invariance of the Philox streams."""
import functools

import numpy as np
import pytest

from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.utils import io as tio

NT, NF, NM = 10, 16, 2
NITER, WRITE = 6, 3
SEED = 7


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _jobs(job_cls, out_root, nbl=2):
    rng = np.random.default_rng(23)
    jobs = []
    crandn = lambda *s: (rng.standard_normal(s)
                         + 1j * rng.standard_normal(s)) / np.sqrt(2)
    # the problem of tests/test_megachain.py:30-38, one per baseline
    for b in range(nbl):
        d = crandn(NT, NF) * 2.0
        fg = crandn(NF, NM)
        ninv = np.abs(rng.standard_normal(NF)) + 1.0
        ps0 = np.abs(rng.standard_normal(NF)) * 10.0 + 0.5
        jobs.append(job_cls(
            antpair=(0, b + 1), d=d, w=np.ones(NF), fgmodes=fg,
            S_initial=ps0, Ninv=ninv,
            out_dir=None if out_root is None else out_root / f"0-{b + 1}"))
    return jobs


def _prior():
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 1: NF // 2 + 2] = 300.0
    prior[1, NF // 2 - 1: NF // 2 + 2] = 0.5
    return prior


@functools.lru_cache(maxsize=None)
def jax_reference(tmp_root):
    """The JAX runner's results, files, and its per-chunk randomness."""
    import jax
    from hydra_pspec_tpu import runner as jrunner
    from hydra_pspec_tpu.models import mega as jmega
    from hydra_pspec_tpu.models import megachain as jmc
    from hydra_pspec_tpu.models import rgibbs as jrg

    from pathlib import Path
    root = Path(tmp_root)
    jobs = _jobs(jrunner.BaselineJob, root)
    results, timings = jrunner.run_baselines(
        jobs, _prior(), NITER, seed=SEED, write_niter=WRITE,
        engine="megachain", use_mesh=False)
    assert timings["engine"] == "megachain"
    _, dims = jmega.from_chain_operators(jrg.stack_chain_operators(
        [jrg.build_chain_operators(j.d, j.w, j.fgmodes, j.Ninv)
         for j in jobs]))
    base = jax.random.key(SEED)
    sids = np.arange(len(jobs), dtype=np.int32)

    # the JAX runner's key schedule (runner.py:558, megachain.py:551)
    def randomness(done, k_total):
        ck = jax.random.fold_in(
            jax.random.fold_in(base, 1_000_000 + done), 0)
        rnd = jmc.draw_chunk_randomness(ck, sids, dims, k_total,
                                        dims.ntimes - 1)
        return {k: np.asarray(v) for k, v in rnd.items()}

    files = {j.antpair: tio.load_samples(j.out_dir) for j in jobs}
    return results, files, randomness


def _run(tmp_path, name, **kw):
    jobs = _jobs(trunner.BaselineJob, tmp_path / name, kw.pop("nbl", 2))
    kw.setdefault("niter", NITER)
    niter = kw.pop("niter")
    return jobs, trunner.run_baselines(
        jobs, _prior(), niter, device="cpu", seed=SEED, write_niter=WRITE,
        **kw)


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-30)


def case_matches_jax(tmp_path, jax_root):
    ref, _, randomness = jax_reference(str(jax_root))
    _, (res, tim) = _run(tmp_path, "port", randomness=randomness)
    assert tim["engine"] == "megachain"
    for r, j in zip(res, ref):
        np.testing.assert_allclose(r.signal_ps, j.signal_ps, rtol=2e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(r.ln_post, j.ln_post, rtol=2e-3)
        for part in (np.real, np.imag):
            assert _rel(part(r.signal_cr), part(j.signal_cr)) < 2e-4
            assert _rel(part(r.fg_amps), part(j.fg_amps)) < 2e-4
        assert np.abs(r.chisq - j.chisq).max() < 5e-3


def case_output_files(tmp_path, jax_root):
    _, jfiles, _ = jax_reference(str(jax_root))
    jobs, (res, _) = _run(tmp_path, "port")
    want_shapes = {"signal_cr": (NITER, NT, NF), "signal_S": (NF, NF),
                   "signal_ps": (NITER, NF), "fg_amps": (NITER, NT, NM),
                   "chisq": (NITER, NT, NF), "ln_post": (NITER,)}
    for job, r in zip(jobs, res):
        got = tio.load_samples(job.out_dir)
        assert set(got) == set(tio.SAMPLE_FILENAMES)
        for k, shape in want_shapes.items():
            assert got[k].shape == shape, k
            assert got[k].shape == jfiles[job.antpair][k].shape, k
            assert got[k].dtype == jfiles[job.antpair][k].dtype, k
            assert np.isfinite(got[k]).all(), k
        assert np.array_equal(got["signal_ps"], r.signal_ps)


def case_resume(tmp_path, jax_root):
    full_jobs, _ = _run(tmp_path, "full")
    part_jobs, _ = _run(tmp_path, "part", niter=WRITE)
    ck = tio.load_checkpoint(part_jobs[0].out_dir.parent)
    assert ck["iteration"] == WRITE
    _, (res, tim) = _run(tmp_path, "part", resume=True)
    assert tim["start_iter"] == WRITE
    for jf, jp, r in zip(full_jobs, part_jobs, res):
        a, b = tio.load_samples(jf.out_dir), tio.load_samples(jp.out_dir)
        for k in tio.SAMPLE_FILENAMES:
            assert np.array_equal(a[k], b[k]), k
        assert np.array_equal(r.signal_ps, a["signal_ps"])


def case_subset_invariance(tmp_path, jax_root):
    _, (res_all, _) = _run(tmp_path, "all", nbl=3, nchains=2)
    jobs = _jobs(trunner.BaselineJob, None, 3)[1:2]
    res_one, _ = trunner.run_baselines(
        jobs, _prior(), NITER, device="cpu", seed=SEED, write_niter=WRITE,
        nchains=2, global_baseline_ids=[1])
    for c in range(2):
        a, b = res_all[2 + c], res_one[c]
        assert (a.antpair, a.chain) == (b.antpair, b.chain)
        assert np.array_equal(a.signal_ps, b.signal_ps)
        assert np.array_equal(a.signal_cr, b.signal_cr)
    # the same block as process 1's of a two-process run: the same chains
    res_p, _ = trunner.run_baselines(
        jobs, _prior(), NITER, device="cpu", seed=SEED, write_niter=WRITE,
        nchains=2, global_baseline_ids=[1], process_id=1, num_processes=2)
    for a, b in zip(res_one, res_p):
        assert np.array_equal(a.signal_ps, b.signal_ps)


CASES = {f.__name__[5:]: f for f in (case_matches_jax, case_output_files,
                                      case_resume, case_subset_invariance)}


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_run")


@pytest.mark.parametrize("case", list(CASES))
def test_runner(case, tmp_path, jax_root):
    CASES[case](tmp_path, jax_root)
