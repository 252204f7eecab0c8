"""The port's run_baselines on its fallback engines (CPU, plain kernel
versions) against the JAX runner: the routing table of
``hydra_pspec_tpu/runner.py:180-211``, the real engine with a dense
``Ninv``, MAP mode, the grouped real path with 10 flag patterns, and the
mega engine with 11 bounded prior bins, each on external randomness that
reproduces the JAX runner's key schedule; and the runner's own contracts
on those engines: resume and subset invariance. The JAX real engine runs
``solver="chol"`` (no Pallas kernel); the mega engine's JAX kernel runs in
Pallas interpret mode."""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.utils import io as tio

NT, NF, NM, NBL = 12, 16, 2, 3
NITER, WRITE, SEED = 6, 3, 7
PATTERNS = 10


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _dense_ninv(b):
    i = np.arange(NF)
    return np.linalg.inv((1.0 + 0.2 * b) * 0.5 ** np.abs(i[:, None]
                                                          - i[None, :]))


def _flags():
    """10 distinct flag rows: channel r flagged from time r on."""
    f = np.zeros((NT, NF), dtype=bool)
    for r in range(1, PATTERNS):
        f[r:, r + 2] = True
    assert len(ttf.group_flag_patterns(f)) == PATTERNS
    return f


def _jobs(job_cls, root, *, dense=False, flags=None, nbl=NBL, ntimes=NT):
    rng = np.random.default_rng(19)
    crandn = lambda *s: (rng.standard_normal(s)
                         + 1j * rng.standard_normal(s)) / np.sqrt(2)
    jobs = []
    for b in range(nbl):
        d = crandn(ntimes, NF) * 2.0
        fg = crandn(NF, NM)
        ninv = _dense_ninv(b) if dense else np.abs(
            rng.standard_normal(NF)) + 1.0
        ps0 = np.abs(rng.standard_normal(NF)) * 10.0 + 0.5
        jobs.append(job_cls(
            antpair=(0, b + 1), d=d, w=flagged_w(b), fgmodes=fg,
            S_initial=ps0, Ninv=ninv, flags_tf=flags,
            out_dir=None if root is None else Path(root) / f"0-{b + 1}"))
    return jobs


def flagged_w(b):
    """Channel weights of baseline ``b``: two channels of baseline 1 are
    flagged (as in tests/test_torch_mega.py)."""
    w = np.ones(NF)
    if b == 1:
        w[[3, 11]] = 0.0
    return w


def _prior(nbins=3):
    prior = np.zeros((2, NF))
    sl = slice(NF // 2 - nbins // 2, NF // 2 + nbins - nbins // 2)
    prior[0, sl] = 300.0
    prior[1, sl] = 0.5
    return prior


# --- the JAX runner's key schedules, in the port's randomness layout -------

def _pairs(out):
    """Complex omegas -> the ``_re``/``_im`` float32 pairs."""
    for name in ("oa", "ob"):
        z = np.asarray(out.pop(name))
        out[f"{name}_re"] = z.real.astype(np.float32)
        out[f"{name}_im"] = z.imag.astype(np.float32)
    return out


def _bandpower_draws(k_ps, alpha, n, npb):
    """``sample_bandpowers_from_beta``'s draws (``invgamma.py:223-257``,
    alpha <= 512): Gamma(alpha) (n,) and the prior uniforms (npb,)."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    k_gamma, k_u = jax.random.split(k_ps)
    u = jax.random.uniform(k_gamma, (alpha, n), dtype=f32)
    gam = -jnp.sum(jnp.log(jnp.maximum(u, jnp.finfo(f32).tiny)), axis=0)
    return np.asarray(gam), np.asarray(jax.random.uniform(k_u, (npb,),
                                                          dtype=f32))


def _iteration_keys(done, k_total):
    """The JAX runner's per-iteration keys of a chunk (``runner.py:558``,
    ``rgibbs.py:376``)."""
    import jax

    ck = jax.random.fold_in(jax.random.key(SEED), 1_000_000 + done)
    return [jax.random.fold_in(ck, i) for i in range(k_total)]


def real_randomness(npb, ntimes=NT):
    """The real engine's draws (``rgibbs.py:294-336``) per chain id."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    def fn(done, k_total, sids=None):
        sids = range(NBL) if sids is None else sids
        out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
        for key in _iteration_keys(done, k_total):
            rows = {k: [] for k in out}
            for sid in sids:
                ka, kb, kp = jax.random.split(jax.random.fold_in(key, sid),
                                              3)
                oa = cplx.standard_normal(ka, (ntimes, NF), dtype=jnp.float32)
                s = np.sqrt(NF).astype(np.float32)
                rows["oa"].append(np.asarray(oa.re * s)
                                  + 1j * np.asarray(oa.im * s))
                ob = cplx.standard_normal(kb, (ntimes, NF), dtype=jnp.float32)
                rows["ob"].append(np.asarray(ob.re) + 1j * np.asarray(ob.im))
                g, u = _bandpower_draws(kp, ntimes - 1, NF, npb)
                rows["gam"].append(g)
                rows["u_pb"].append(u)
            for k in out:
                out[k].append(np.stack(rows[k]))
        return _pairs({k: np.stack(v) for k, v in out.items()})
    return fn


def tflags_real_randomness(npb, flags):
    """The grouped real engine's draws (``tflags.py:216-276``): per chain
    ``row_key = fold_in(key, sid)``, group g's omegas from
    ``split(fold_in(row_key, g))`` placed at the group's times, the pooled
    draw from ``fold_in(row_key, 999_983)`` at the total alpha."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    groups = [idx for _, idx in ttf.group_flag_patterns(flags)]

    def fn(done, k_total, sids):
        out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
        for key in _iteration_keys(done, k_total):
            rows = {k: [] for k in out}
            for sid in sids:
                rk = jax.random.fold_in(key, int(sid))
                oa = np.zeros((NT, NF), complex)
                ob = np.zeros((NT, NF), complex)
                for g, idx in enumerate(groups):
                    ka, kb = jax.random.split(jax.random.fold_in(rk, g))
                    za = cplx.standard_normal(ka, (idx.size, NF),
                                              dtype=jnp.float32)
                    s = np.sqrt(NF).astype(np.float32)
                    oa[idx] = np.asarray(za.re * s) + 1j * np.asarray(
                        za.im * s)
                    ob[idx] = cplx.to_numpy(cplx.standard_normal(
                        kb, (idx.size, NF), dtype=jnp.float32))
                g_, u = _bandpower_draws(jax.random.fold_in(rk, 999_983),
                                         NT - 1, NF, npb)
                for k, v in zip(out, (oa, ob, g_, u)):
                    rows[k].append(v)
            for k in out:
                out[k].append(np.stack(rows[k]))
        return _pairs({k: np.stack(v) for k, v in out.items()})
    return fn


def mega_randomness(npb, dims):
    """The mega engine's draws (``mega.py:212-243``) per chain id."""
    import jax
    import jax.numpy as jnp

    half = np.sqrt(0.5).astype(np.float32)
    sa = half * np.sqrt(np.float32(NF))

    def fn(done, k_total):
        out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
        for key in _iteration_keys(done, k_total):
            rows = {k: [] for k in out}
            for sid in range(NBL):
                ka, kb, kp = jax.random.split(jax.random.fold_in(key, sid),
                                              3)
                shape = (2, dims.n, dims.t)
                oa = np.asarray(jax.random.normal(ka, shape, jnp.float32)
                                * sa)
                ob = np.asarray(jax.random.normal(kb, shape, jnp.float32)
                                * half)
                g, u = _bandpower_draws(kp, NT - 1, dims.n, npb)
                for k, v in zip(out, (oa[0] + 1j * oa[1],
                                      ob[0] + 1j * ob[1], g, u)):
                    rows[k].append(v)
            for k in out:
                out[k].append(np.stack(rows[k]))
        return _pairs({k: np.stack(v) for k, v in out.items()})
    return fn


def _blocking(fn):
    """``fn`` followed by a wait for its outputs. Pallas interpret mode
    runs the kernel through host callbacks that dispatch JAX ops; an eager
    op dispatched while they run can deadlock against them, so no eager op
    may follow the kernel before it is done."""
    def call(*args, **kw):
        import jax

        return jax.block_until_ready(fn(*args, **kw))
    return call


def _eager_chain_mega(key, mops, dims, ps, prior, niter, store_cr=True,
                      prior_idx=None, sids=None):
    """``mega.run_chain_mega_jit`` as a Python loop of the same
    ``gibbs_step_mega`` calls (``mega.py:281-297``) with ``batch_tile`` =
    the batch: the JAX kernel then compiles once, as the standalone
    ``gcr_megastep`` of tests/test_torch_mega.py does at these shapes."""
    import jax
    import jax.numpy as jnp

    outs = []
    for i in range(niter):
        ps, s = jmega.gibbs_step_mega(
            jax.random.fold_in(key, i), ps, mops, dims, prior,
            prior_idx=prior_idx, batch_tile=ps.shape[0], store_cr=store_cr,
            sids=sids)
        outs.append(s)
    return ps, jax.tree.map(lambda *xs: jnp.stack(xs), *outs)


@functools.lru_cache(maxsize=None)
def jax_run(kind, root):
    """The JAX runner on one fallback configuration: results and files."""
    from hydra_pspec_tpu import runner as jrunner

    kw = dict(engine="real", solver="chol")
    jobs_kw, prior = {}, _prior()
    if kind == "dense":
        jobs_kw = dict(dense=True)
    elif kind == "map":
        kw["map_estimate"] = True
    elif kind == "tflags":
        jobs_kw = dict(flags=_flags())
    elif kind == "mega":
        kw = dict(engine="mega")
        prior = _prior(11)
    jobs = _jobs(jrunner.BaselineJob, Path(root) / kind, **jobs_kw)
    chain, step = jmega.run_chain_mega_jit, jmega.gcr_megastep
    if kind == "mega":
        jmega.run_chain_mega_jit = _eager_chain_mega
        jmega.gcr_megastep = _blocking(step)
    try:
        results, tim = jrunner.run_baselines(
            jobs, prior, NITER, seed=SEED, write_niter=WRITE, use_mesh=False,
            **kw)
    finally:
        jmega.run_chain_mega_jit, jmega.gcr_megastep = chain, step
    assert tim["engine"] == kw["engine"]
    files = {j.antpair: tio.load_samples(j.out_dir) for j in jobs}
    return results, files


def _run(root, name, jobs_kw=None, prior=None, **kw):
    jobs = _jobs(trunner.BaselineJob, Path(root) / name, **(jobs_kw or {}))
    kw.setdefault("niter", NITER)
    niter = kw.pop("niter")
    return jobs, trunner.run_baselines(
        jobs, _prior() if prior is None else prior, niter, device="cpu",
        seed=SEED, write_niter=WRITE, **kw)


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-30)


def _match(res, jres, jobs, jfiles):
    """Samples and files at the tolerances of tests/test_torch_runner.py."""
    for r, j, job in zip(res, jres, jobs):
        np.testing.assert_allclose(r.signal_ps, j.signal_ps, rtol=2e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(r.ln_post, j.ln_post, rtol=2e-3)
        for part in (np.real, np.imag):
            assert _rel(part(r.signal_cr), part(j.signal_cr)) < 3e-3
            assert _rel(part(r.fg_amps), part(j.fg_amps)) < 3e-3
        assert np.abs(r.chisq - j.chisq).max() < 3e-2 * np.abs(
            j.chisq).mean()
        got, want = tio.load_samples(job.out_dir), jfiles[job.antpair]
        assert set(got) == set(want) == set(tio.SAMPLE_FILENAMES)
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k


# --- cases ------------------------------------------------------------------

def case_routing(tmp_path, jax_root):
    """Each rule of ``runner.py:180-211`` sends a job where JAX sends it."""
    J = trunner.BaselineJob
    plain = _jobs(J, None)
    few = np.zeros((NT, NF), dtype=bool)
    few[5:, 3] = True
    table = [
        (dict(jobs=plain), "megachain"),
        (dict(jobs=plain, map_estimate=True), "real"),
        (dict(jobs=plain, ps_prior=_prior(9)), "mega"),
        (dict(jobs=plain, ps_prior=_prior(8)), "megachain"),
        (dict(jobs=_jobs(J, None, ntimes=1026)), "mega"),
        (dict(jobs=_jobs(J, None, ntimes=1025)), "megachain"),
        (dict(jobs=_jobs(J, None, dense=True)), "real"),
        (dict(jobs=plain, engine="mega"), "mega"),
        (dict(jobs=_jobs(J, None, dense=True), engine="mega"), "real"),
        (dict(jobs=plain, engine="real"), "real"),
        (dict(jobs=_jobs(J, None, flags=few)), "megachain"),
        (dict(jobs=_jobs(J, None, flags=_flags())), "real"),
        (dict(jobs=_jobs(J, None, flags=few), ps_prior=_prior(9)), "real"),
        (dict(jobs=_jobs(J, None, flags=few), engine="mega"), "real"),
    ]
    for kw, want in table:
        kw.setdefault("ps_prior", _prior())
        assert trunner.route_engine(**kw) == want, (kw.keys(), want)
    # the complex engine, asked for, runs everything itself
    for kw in (dict(jobs=plain), dict(jobs=plain, map_estimate=True),
               dict(jobs=_jobs(J, None, dense=True)),
               dict(jobs=_jobs(J, None, flags=_flags()))):
        assert trunner.route_engine(ps_prior=_prior(9), engine="complex",
                                    **kw) == "complex", kw.keys()


def case_dense_matches_jax(tmp_path, jax_root):
    jres, jfiles = jax_run("dense", str(jax_root))
    jobs, (res, tim) = _run(tmp_path, "port", dict(dense=True),
                            randomness=real_randomness(3))
    assert tim["engine"] == "real"
    _match(res, jres, jobs, jfiles)


def case_dense_resume(tmp_path, jax_root):
    full, _ = _run(tmp_path, "full", dict(dense=True))
    part, _ = _run(tmp_path, "part", dict(dense=True), niter=WRITE)
    assert tio.load_checkpoint(part[0].out_dir.parent)["iteration"] == WRITE
    _, (_, tim) = _run(tmp_path, "part", dict(dense=True), resume=True)
    assert tim["start_iter"] == WRITE and tim["engine"] == "real"
    for jf, jp in zip(full, part):
        a, b = tio.load_samples(jf.out_dir), tio.load_samples(jp.out_dir)
        for k in tio.SAMPLE_FILENAMES:
            assert np.array_equal(a[k], b[k]), k


def case_map_matches_jax(tmp_path, jax_root):
    jres, jfiles = jax_run("map", str(jax_root))
    jobs, (res, tim) = _run(tmp_path, "port", map_estimate=True,
                            randomness=real_randomness(3))
    assert tim["engine"] == "real" and tim["niter"] == 1
    assert res[0].signal_ps.shape == (1, NF)
    _match(res, jres, jobs, jfiles)


def case_tflags_matches_jax(tmp_path, jax_root):
    jres, jfiles = jax_run("tflags", str(jax_root))
    jobs, (res, tim) = _run(tmp_path, "port", dict(flags=_flags()),
                            randomness=tflags_real_randomness(3, _flags()))
    assert tim["engine"] == "real"
    _match(res, jres, jobs, jfiles)


def case_tflags_resume_and_all_false(tmp_path, jax_root):
    """Per-signature checkpoints resume bit for bit; a single all-False
    pattern on the grouped real path draws what the plain real engine
    draws (the omegas at each time's global index)."""
    kw = dict(flags=_flags())
    full, _ = _run(tmp_path, "full", kw)
    part, _ = _run(tmp_path, "part", kw, niter=WRITE)
    assert tio.load_checkpoint(part[0].out_dir.parent,
                               tag="-tf0")["iteration"] == WRITE
    _run(tmp_path, "part", kw, resume=True)
    for jf, jp in zip(full, part):
        a, b = tio.load_samples(jf.out_dir), tio.load_samples(jp.out_dir)
        for k in tio.SAMPLE_FILENAMES:
            assert np.array_equal(a[k], b[k]), k
    none = np.zeros((NT, NF), dtype=bool)
    _, (res_tf, tim) = _run(tmp_path, "none", dict(flags=none),
                            engine="real")
    plain = [dataclasses.replace(j, w=np.ones(NF))       # = all-False flags
             for j in _jobs(trunner.BaselineJob, tmp_path / "plain")]
    res_pl, _ = trunner.run_baselines(plain, _prior(), NITER, device="cpu",
                                      seed=SEED, write_niter=WRITE,
                                      engine="real")
    assert tim["engine"] == "real"
    for a, b in zip(res_tf, res_pl):
        for f in ("signal_ps", "signal_cr", "fg_amps", "chisq"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def case_mega_matches_jax(tmp_path, jax_root):
    from hydra_pspec_torch.models import mega as tmega
    from hydra_pspec_torch.models import rgibbs as trg

    jres, jfiles = jax_run("mega", str(jax_root))
    jobs = _jobs(trunner.BaselineJob, None)
    _, dims = tmega.from_chain_operators(trg.build_chain_operators(
        jobs[0].d, jobs[0].w, jobs[0].fgmodes, jobs[0].Ninv), "cpu",
        layout="jax")
    jobs, (res, tim) = _run(tmp_path, "port", prior=_prior(11),
                            randomness=mega_randomness(11, dims))
    assert tim["engine"] == "mega"
    _match(res, jres, jobs, jfiles)


def case_subset_invariance(tmp_path, jax_root):
    """The second baseline (the flagged one: a batch's ``all_unflagged``
    is batch-wide, as in JAX) alone reproduces its samples bit for bit on
    each fallback engine."""
    engines = {"real": dict(jobs_kw=dict(dense=True)),
               "mega": dict(prior=_prior(11)),
               "real-tflags": dict(jobs_kw=dict(flags=_flags()))}
    for name, kw in engines.items():
        _, (res_all, tim) = _run(tmp_path, name, nchains=2, **kw)
        assert tim["engine"] == name.split("-")[0]
        one = _jobs(trunner.BaselineJob, None,
                    **kw.get("jobs_kw", {}))[1:2]
        res_one, _ = trunner.run_baselines(
            one, kw.get("prior", _prior()), NITER, device="cpu", seed=SEED,
            write_niter=WRITE, nchains=2, global_baseline_ids=[1])
        for c in range(2):
            a, b = res_all[2 + c], res_one[c]
            assert (a.antpair, a.chain) == (b.antpair, b.chain)
            for f in ("signal_ps", "signal_cr", "fg_amps", "chisq",
                      "ln_post"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), \
                    (name, f)


CASES = {f.__name__[5:]: f for f in (
    case_routing, case_dense_matches_jax, case_dense_resume,
    case_map_matches_jax, case_tflags_matches_jax,
    case_tflags_resume_and_all_false, case_mega_matches_jax,
    case_subset_invariance)}


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_fallback")


@pytest.mark.parametrize("case", list(CASES))
def test_fallback_runner(case, tmp_path, jax_root):
    CASES[case](tmp_path, jax_root)
