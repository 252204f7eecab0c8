"""The port's complex float64 engine against the JAX package's complex
engine on the CPU under x64 (``tests/conftest.py`` enables it): the
Fourier, noise, special-function and inverse-gamma operators, the GCR
draw on the same omegas and as the MAP draw, one Gibbs step and one
grouped time-flags step on the JAX key schedule's own draws (the port
given them as external randomness), the reference-API mirrors, the
``recinv`` and ``identity`` solvers of the real engine, and the runner's
complex engine (files and keys as the JAX runner writes them, subset bit
identity, resume). Two problems: 10 times x 16 channels with diagonal
noise, and 24 x 20 with a dense ``Ninv`` and flagged channels.

Tolerances: both sides compute in complex128 with their own product
orders, so 1e-9 of the largest magnitude; with a dense ``Ninv`` 1e-6,
because the masked noise matrix is singular and the square roots of its
zero eigenvalues (about 1e-8) are rounding that each ``eigh`` makes
differently.
"""
import dataclasses
import filecmp
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydra_pspec_tpu import runner as jrunner
from hydra_pspec_tpu.models import gcr as jgcr
from hydra_pspec_tpu.models import gibbs as jgibbs
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_tpu.models import tflags as jtf
from hydra_pspec_tpu.ops import cplx as jcplx
from hydra_pspec_tpu.ops import fourier as jfo
from hydra_pspec_tpu.ops import invgamma as jinv
from hydra_pspec_tpu.ops import linalg as jla
from hydra_pspec_tpu.ops import special as jsp
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.models import gcr as tgcr
from hydra_pspec_torch.models import gibbs as tgibbs
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops import fourier as tfo
from hydra_pspec_torch.ops import invgamma as tinv
from hydra_pspec_torch.ops import linalg as tla
from hydra_pspec_torch.ops import special as tsp
from hydra_pspec_torch.utils import io as tio

TOL, TOL_DENSE = 1e-9, 1e-6
PROBLEMS = {"10x16": (10, 16, 3, False), "24x20_dense_flagged": (24, 20, 4,
                                                                 True)}
F64 = jnp.float64


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _problem(name, seed=0):
    """(d, w, fgmodes, Ninv, tolerance) of a named problem."""
    nt, nf, nm, dense = PROBLEMS[name]
    rng = np.random.default_rng(seed)
    d = _crandn(rng, nt, nf) * 2.0
    w = np.ones(nf)
    fg = _crandn(rng, nf, nm)
    if dense:
        w[[3, 7, 8]] = 0.0
        i = np.arange(nf)
        ninv = np.linalg.inv(1.5 * 0.5 ** np.abs(i[:, None] - i[None, :]))
    else:
        ninv = rng.uniform(0.5, 2.0, nf)
    return d, w, fg, ninv, TOL_DENSE if dense else TOL


def _prior(nf, half=2):
    prior = np.zeros((2, nf))
    prior[0, nf // 2 - half: nf // 2 + half + 1] = 50.0
    prior[1, nf // 2 - half: nf // 2 + half + 1] = 0.1
    return prior


def _close(got, want, tol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (what, err)


def T(x):
    return torch.as_tensor(np.array(x))


J_GCR = jax.jit(jgcr.gcr_solve)
J_STEP = jax.jit(jgibbs.gibbs_step, static_argnames=("map_estimate",))


def _jax_bandpower_draws(key, beta_shape, ntimes, npb=None):
    """The Gamma draws and uniforms ``sample_bandpowers_from_beta`` of the
    JAX package takes from ``key`` (``invgamma.py:225-264``)."""
    k_gamma, k_u = jax.random.split(key)
    u = jax.random.uniform(k_gamma, (ntimes - 1,) + beta_shape, dtype=F64)
    gam = -jnp.sum(jnp.log(jnp.maximum(u, jnp.finfo(F64).tiny)), axis=0)
    shape = beta_shape if npb is None else beta_shape[:-1] + (npb,)
    return gam, jax.random.uniform(k_u, shape, dtype=F64)


def _jax_step_randomness(key, nt, nf, npb):
    """The omegas and bandpower draws of one JAX ``gibbs_step``."""
    k_a, k_b, k_ps = jax.random.split(key, 3)
    oa = jax.random.normal(k_a, (nt, nf), dtype=jnp.complex128)
    ob = jax.random.normal(k_b, (nt, nf), dtype=jnp.complex128)
    gam, u = _jax_bandpower_draws(k_ps, (nf,), nt, npb)
    return dict(oa=T(oa), ob=T(ob), gam=T(gam), u=T(u))


# --- operators -------------------------------------------------------------

def case_fourier():
    rng = np.random.default_rng(1)
    for n in (16, 17):
        jf, tf = jfo.fourier_operator(n), tfo.fourier_operator(n,
                                                               device="cpu")
        _close(tf, jf, 1e-15, "fourier_operator")
        x = _crandn(rng, 5, n)
        _close(tfo.cfft(T(x)), jfo.cfft(jnp.asarray(x)), TOL, "cfft")
        _close(tfo.icfft(T(x)), jfo.icfft(jnp.asarray(x)), TOL, "icfft")
        _close(tfo.cfft(T(x), dim=0), jfo.cfft(jnp.asarray(x), axis=0), TOL,
               "cfft axis 0")
        ps = rng.uniform(0.1, 3.0, n)
        c = tfo.covariance_from_pspec(T(ps), tf)
        _close(c, jfo.covariance_from_pspec(jnp.asarray(ps), jf), TOL,
               "covariance_from_pspec")
        _close(tfo.pspec_from_covariance(c, tf),
               jfo.pspec_from_covariance(jnp.asarray(c.numpy()), jf), TOL,
               "pspec_from_covariance")


def case_linalg():
    for name in PROBLEMS:
        _, w, _, ninv, tol = _problem(name)
        more = (0.7, np.diag(np.full(w.size, 1.3))) if tol == TOL else ()
        for nv in (ninv,) + more:
            jn = jla.make_noise_operators(jnp.asarray(w), jnp.asarray(nv))
            tn = tla.make_noise_operators(T(w), T(nv))
            assert tn.is_diagonal == jn.is_diagonal, name
            for a, b in zip(tn, jn):
                assert (a is None) == (b is None)
                if a is not None:
                    _close(a, b, tol, f"noise {name}")
            x = _crandn(np.random.default_rng(2), 6, w.size)
            _close(tn.apply_ni(T(x)), jn.apply_ni(jnp.asarray(x)), tol)
            _close(tn.apply_nih(T(x)), jn.apply_nih(jnp.asarray(x)), tol)
    rng = np.random.default_rng(3)
    a = _crandn(rng, 12, 12)
    m = a @ a.conj().T + 12 * np.eye(12)
    _close(tla.hermitian_sqrt(T(m)), jla.hermitian_sqrt(jnp.asarray(m)), TOL,
           "hermitian_sqrt")
    b = _crandn(rng, 12, 5)
    for jitter in (0.0, 1e-3):
        x, info = tla.cholesky_solve(T(m), T(b), jitter=jitter)
        _close(x, jla.cholesky_solve(jnp.asarray(m), jnp.asarray(b),
                                     jitter=jitter), TOL, "cholesky_solve")
        assert int(info) == 0
    _, info = tla.cholesky_solve(T(-m), T(b))
    assert int(info) != 0


def case_special():
    for a in (0.5, 2.0, 10.0, 50.0, 202.0, 204.0, 1000.0):
        x = np.concatenate([np.logspace(-3, np.log10(a * 5 + 10), 60),
                            np.linspace(max(a - 50, 0.1), a + 50, 40),
                            [0.0, -1.0]])
        for iters in (None, jsp.iters_for_shape(a)):
            want = np.asarray(jsp.gammaincc_fixed(F64(a), jnp.asarray(x),
                                                  iters=iters))
            got = tsp.gammaincc_fixed(T(a), T(x), iters=iters).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-14)
            np.testing.assert_allclose(
                tsp.gammainc_fixed(T(a), T(x), iters=iters).numpy(),
                np.asarray(jsp.gammainc_fixed(F64(a), jnp.asarray(x),
                                              iters=iters)),
                rtol=1e-11, atol=1e-12)
    assert tsp.iters_for_shape(5000.0) == jsp.iters_for_shape(5000.0)


def case_invgamma():
    rng = np.random.default_rng(4)
    x = np.logspace(-1, 3, 50)
    _close(tinv.invgamma_cdf(T(x), 203.0, 150.0),
           jinv.invgamma_cdf(jnp.asarray(x), 203.0, 150.0), 1e-12, "cdf")
    u = rng.uniform(size=40)
    beta = rng.uniform(50.0, 400.0, 40)
    lo, hi = rng.uniform(0.05, 0.5, 40), rng.uniform(2.0, 20.0, 40)
    iters = jsp.iters_for_shape(204.0)
    _close(tinv.truncated_invgamma_sample(T(u), 203.0, T(beta), T(lo), T(hi),
                                          iters=iters),
           jinv.truncated_invgamma_sample(
               jnp.asarray(u), 203.0, jnp.asarray(beta), jnp.asarray(lo),
               jnp.asarray(hi), iters=iters), 1e-11, "truncated")
    key = jax.random.key(5)
    want = jinv.inversion_sample_invgamma(10.0, 30.0, 0.5, 8.0, key=key)
    got = tinv.inversion_sample_invgamma(10.0, 30.0, 0.5, 8.0,
                                         u=float(jax.random.uniform(key)),
                                         device="cpu")
    _close(got, want, 1e-11, "inversion_sample_invgamma")
    with pytest.raises(ValueError):
        tinv.inversion_sample_invgamma(10.0, 30.0, 2.0, 1.0, u=0.5)
    nt, nf = 12, 16
    sk = _crandn(rng, nt, nf) * 3.0
    prior = _prior(nf)
    pidx = np.nonzero(np.any(prior > 0, axis=0))[0]
    beta = (np.abs(sk) ** 2).sum(0)
    for idx in (None, pidx):
        want = jinv.sample_bandpowers(key, jnp.asarray(sk),
                                      jnp.asarray(prior),
                                      None if idx is None
                                      else jnp.asarray(idx))
        gam, u = _jax_bandpower_draws(key, (nf,), nt,
                                      None if idx is None else idx.size)
        got = tinv.sample_bandpowers(T(sk), T(prior), gam=T(gam), u=T(u),
                                     prior_idx=None if idx is None
                                     else T(idx))
        _close(got, want, 1e-11, f"sample_bandpowers idx={idx is not None}")
    s = _crandn(rng, nt, nf)
    gam, u = _jax_bandpower_draws(key, (nf,), nt)
    _close(tinv.sample_S(s=T(s), gam=T(gam), u=T(u)),
           jinv.sample_S(key, s=jnp.asarray(s)), 1e-11, "sample_S")
    _close(tinv.sprior(T(s), 2, 5.0), jinv.sprior(jnp.asarray(s), 2, 5.0),
           1e-12, "sprior")
    assert np.isfinite(beta).all()


# --- the engine ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ops(name):
    d, w, fg, ninv, tol = _problem(name)
    return (jgcr.build_chain_operators(d, w, fg, ninv),
            tgcr.build_chain_operators(d, w, fg, ninv), tol)


def case_gcr():
    for name in PROBLEMS:
        jops, tops, tol = _ops(name)
        for field in ("d_w", "ni_d", "ni_fg", "maa", "a0"):
            _close(getattr(tops, field), getattr(jops, field), tol, field)
        nt, nf = tops.d_w.shape
        rng = np.random.default_rng(6)
        ps = rng.uniform(0.5, 30.0, nf)
        _close(tgcr.signal_sqrt_operator(tops, T(ps)),
               jgcr.signal_sqrt_operator(jops, jnp.asarray(ps)), TOL, "Sh")
        oa, ob = _crandn(rng, nt, nf), _crandn(rng, nt, nf)
        for omegas in ((oa, ob), (None, None)):
            jr = J_GCR(jops, jnp.asarray(ps),
                       *(None if o is None else jnp.asarray(o)
                         for o in omegas))
            tr = tgcr.gcr_solve(tops, T(ps),
                                *(None if o is None else T(o)
                                  for o in omegas))
            what = f"{name} {'MAP' if omegas[0] is None else 'draw'}"
            _close(tr.signal_cr, jr.signal_cr, tol, what)
            _close(tr.fg_amps, jr.fg_amps, tol, what)
            assert int(tr.info) == 0


def case_gibbs_step():
    for name in PROBLEMS:
        jops, tops, tol = _ops(name)
        nt, nf = tops.d_w.shape
        prior = _prior(nf)
        pidx = np.nonzero(np.any(prior > 0, axis=0))[0]
        ps = np.random.default_rng(7).uniform(0.5, 30.0, nf)
        key = jax.random.key(8)
        for mapx in (False, True)[:2 if name == "10x16" else 1]:
            jps, js = J_STEP(key, jnp.asarray(ps), jops, jnp.asarray(prior),
                             map_estimate=mapx, prior_idx=jnp.asarray(pidx))
            tps, ts, info = tgibbs.gibbs_step(
                tops, T(ps), T(prior),
                _jax_step_randomness(key, nt, nf, pidx.size),
                map_estimate=mapx, prior_idx=T(pidx))
            for f in ("signal_cr", "fg_amps", "chisq", "ps"):
                _close(getattr(ts, f), getattr(js, f), tol, f"{name} {f}")
            _close(ts.ln_post, js.ln_post, tol, f"{name} ln_post")
            _close(tps, jps, tol, name)
            assert int(info) == 0


def case_gibbs_step_tflags():
    d, _, fg, ninv, tol = _problem("24x20_dense_flagged")
    nt, nf = d.shape
    flags = np.zeros((nt, nf), dtype=bool)
    flags[3:9, 5] = True
    flags[15:20, [11, 12]] = True
    jgroups = jtf.build_grouped_operators(d, flags, fg, ninv)
    tgroups = ttf.build_grouped_operators(d, flags, fg, ninv)
    assert [g.idx.tolist() for g in tgroups] == [g.idx.tolist()
                                                 for g in jgroups]
    prior = _prior(nf)
    pidx = np.nonzero(np.any(prior > 0, axis=0))[0]
    ps = np.random.default_rng(9).uniform(0.5, 30.0, nf)
    key = jax.random.key(10)
    jps, js = jax.jit(lambda k, p: jtf.gibbs_step_tflags(
        k, p, jgroups, jnp.asarray(prior), prior_idx=jnp.asarray(pidx)))(
            key, jnp.asarray(ps))
    oa = np.zeros((nt, nf), complex)
    ob = np.zeros((nt, nf), complex)
    for g, grp in enumerate(jgroups):
        k_a, k_b = jax.random.split(jax.random.fold_in(key, g))
        shape = (grp.idx.size, nf)
        oa[grp.idx] = jax.random.normal(k_a, shape, dtype=jnp.complex128)
        ob[grp.idx] = jax.random.normal(k_b, shape, dtype=jnp.complex128)
    gam, u = _jax_bandpower_draws(jax.random.fold_in(key, 999_983), (nf,),
                                  nt, pidx.size)
    tps, ts, info = ttf.gibbs_step_tflags(
        tgroups, T(ps), T(prior), dict(oa=T(oa), ob=T(ob), gam=T(gam),
                                       u=T(u)), prior_idx=T(pidx))
    for f in ("signal_cr", "fg_amps", "chisq", "ps", "ln_post"):
        _close(getattr(ts, f), getattr(js, f), tol, f"tflags {f}")
    _close(tps, jps, tol, "tflags ps")
    assert int(info) == 0


def case_reference_api():
    """``gibbs_step_fgmodes`` and ``gcr_fgmodes`` on the JAX key's draws;
    ``gibbs_sample_with_fg``'s outputs and files as the JAX function's."""
    d, w, fg, ninv, tol = _problem("10x16")
    nt, nf = d.shape
    S0 = tfo.covariance_from_pspec(T(np.linspace(1.0, 20.0, nf) / nf**2),
                                   tfo.fourier_operator(nf, device="cpu")
                                   ).numpy()
    key = jax.random.key(12)
    want = jgibbs.gibbs_step_fgmodes(key, d, w, S0, fg, ninv)
    got = tgibbs.gibbs_step_fgmodes(
        d, w, S0, fg, ninv, rand=_jax_step_randomness(key, nt, nf, nf),
        device="cpu")
    for g, j in zip(got, want):
        _close(g, j, tol, "gibbs_step_fgmodes")
    k_a, k_b = jax.random.split(key)
    oa = jax.random.normal(k_a, (nt, nf), dtype=jnp.complex128)
    ob = jax.random.normal(k_b, (nt, nf), dtype=jnp.complex128)
    _close(tgibbs.gcr_fgmodes(d, w, S0, fg, ninv, omega_a=T(oa),
                              omega_b=T(ob), device="cpu"),
           jgibbs.gcr_fgmodes(key, d, w, S0, fg, ninv), tol, "gcr_fgmodes")
    _close(tgibbs.gcr_fgmodes(d, w, S0, fg, ninv, map_estimate=True,
                              device="cpu"),
           jgibbs.gcr_fgmodes(key, d, w, S0, fg, ninv, map_estimate=True),
           tol, "gcr_fgmodes MAP")
    assert tgibbs.gcr_fgmodes(d, w, S0, fg, ninv,
                              device="cpu").shape == (nt, nf + 3)


def case_sample_with_fg(tmp_path):
    """``gibbs_sample_with_fg``: the JAX function's outputs (shapes and
    dtypes) and sample files, chunk by chunk."""
    d, w, fg, ninv, _ = _problem("10x16")
    kw = dict(Niter=3, seed=2, verbose=False, write_Niter=2)
    want = jgibbs.gibbs_sample_with_fg(d, w, np.eye(16), fg, ninv,
                                       _prior(16), out_dir=tmp_path / "j",
                                       **kw)
    got = tgibbs.gibbs_sample_with_fg(d, w, np.eye(16), fg, ninv,
                                      _prior(16), out_dir=tmp_path / "t",
                                      device="cpu", **kw)
    for g, j in zip(got[:6], want[:6]):
        assert (g.shape, g.dtype) == (np.shape(j), np.asarray(j).dtype)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    assert np.isfinite(got[2]).all() and got[0].dtype == np.complex128


def case_recinv_identity():
    """The real engine's ``recinv`` and ``identity`` solvers against JAX
    ``rgibbs._solve`` on float32 Hermitian systems (``recinv``: the
    inverse and one refinement in float32 on both sides, 1e-4 of the
    solution)."""
    rng = np.random.default_rng(13)
    a = _crandn(rng, 2, 12, 12)
    m = (a @ a.conj().transpose(0, 2, 1) + 12 * np.eye(12)).astype(
        np.complex64)
    b = _crandn(rng, 2, 12, 7).astype(np.complex64)
    jm, jb = jcplx.from_numpy(m), jcplx.from_numpy(b)
    for solver, tol in (("recinv", 1e-4), ("identity", 0.0)):
        for jitter in (0.0, 1e-3):
            want = jcplx.to_numpy(jrg._solve(jm, jb, jitter, solver))
            got = trg.solve(T(m), T(b), jitter, solver).numpy()
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= tol, (solver, jitter, err)


# --- the runner ------------------------------------------------------------

def _jobs(cls, root, nbl=2, flags=None):
    rng = np.random.default_rng(14)
    out = []
    for b in range(nbl):
        d, w, fg, ninv, _ = _problem("10x16", seed=20 + b)
        out.append(cls((0, b + 1), d, w, fg, np.eye(16), ninv,
                       out_dir=None if root is None else root / f"0-{b + 1}",
                       **({} if flags is None else {"flags_tf": flags})))
        rng.standard_normal()
    return out


def case_runner_files_and_keys(tmp_path):
    """``run_baselines(engine="complex")`` writes the JAX complex runner's
    files: the same names, shapes and dtypes in the same chain
    directories, and a checkpoint at the last iteration; complex128
    samples."""
    prior = _prior(16)
    kw = dict(nchains=2, write_niter=2, seed=3)
    jres, jtim = jrunner.run_baselines(
        _jobs(jrunner.BaselineJob, tmp_path / "jax"), prior, 4,
        engine="complex", **kw)
    tres, ttim = trunner.run_baselines(
        _jobs(trunner.BaselineJob, tmp_path / "port"), prior, 4,
        device="cpu", engine="complex", **kw)
    assert jtim["engine"] == ttim["engine"] == "complex"
    jfiles = sorted(p.relative_to(tmp_path / "jax")
                    for p in (tmp_path / "jax").rglob("*.np*"))
    tfiles = sorted(p.relative_to(tmp_path / "port")
                    for p in (tmp_path / "port").rglob("*.np*"))
    assert jfiles == tfiles
    for rel in tfiles:
        if rel.suffix != ".npy":
            continue
        a, b = np.load(tmp_path / "jax" / rel), np.load(tmp_path / "port"
                                                        / rel)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), rel
    assert tres[0].signal_cr.dtype == np.complex128
    ck = tio.load_checkpoint(tmp_path / "port")
    assert ck["iteration"] == 4 and ck["ps"].dtype == np.float64
    assert [(r.antpair, r.chain) for r in tres] == [(r.antpair, r.chain)
                                                    for r in jres]


def case_runner_subset_and_resume(tmp_path):
    """Every chain's draws depend on (seed, stream id, iteration) only: the
    first baseline alone, and a run stopped at 2 and resumed, give the
    same files bit for bit; so does the time-flags path (one baseline at
    a time) for its first baseline. A chunk run in blocks of 2 chains, as
    the card runs blocks of ``CHAIN_BLOCK``, equals it run whole."""
    ops = tgcr.stack_chain_operators([tgcr.build_chain_operators(
        *_problem("10x16", seed=20 + b)[:4]) for b in range(4)])
    prior_t, idx = tgibbs.prior_on_device(_prior(16), "cpu")
    sids = torch.arange(4, dtype=torch.int32)
    ps0 = torch.full((4, 16), 3.0, dtype=torch.float64)
    whole, blocks = (tgibbs.chunk_body(ops, prior_t, idx, seed=3, sids=sids,
                                       block=block)(ps0, 5, 2)
                     for block in (None, 2))
    assert torch.equal(whole[0], blocks[0]) and all(
        torch.equal(a, b) for a, b in zip(whole[1], blocks[1]))
    prior = _prior(16)
    kw = dict(nchains=2, write_niter=2, seed=3, device="cpu",
              engine="complex")
    for flags in (None, np.eye(10, 16, dtype=bool)):
        tag = "plain" if flags is None else "tflags"
        full = _jobs(trunner.BaselineJob, tmp_path / tag / "full",
                     flags=flags)
        trunner.run_baselines(full, prior, 4, **kw)
        sub = [dataclasses.replace(j, out_dir=tmp_path / tag / "sub"
                                   / j.out_dir.name) for j in full[:1]]
        trunner.run_baselines(sub, prior, 4, **kw)
        res = [dataclasses.replace(j, out_dir=tmp_path / tag / "res"
                                   / j.out_dir.name) for j in full]
        trunner.run_baselines(res, prior, 2, **kw)
        _, tim = trunner.run_baselines(res, prior, 4, resume=True, **kw)
        assert tim["start_iter"] == 2, tag
        for other, jobs in (("sub", sub), ("res", res)):
            for j in jobs:
                for f in (full[0].out_dir.parent / j.out_dir.name).rglob(
                        "*.npy"):
                    g = tmp_path / tag / other / f.relative_to(
                        full[0].out_dir.parent)
                    assert filecmp.cmp(f, g, shallow=False), (tag, other, g)


CASES = {f.__name__[5:]: f for f in (
    case_fourier, case_linalg, case_special, case_invgamma, case_gcr,
    case_gibbs_step, case_gibbs_step_tflags, case_reference_api,
    case_recinv_identity)}
RUNNER_CASES = {f.__name__[5:]: f for f in (
    case_sample_with_fg, case_runner_files_and_keys,
    case_runner_subset_and_resume)}


@pytest.mark.parametrize("case", list(CASES))
def test_complex_engine_matches_jax(case):
    CASES[case]()


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_complex_runner(case, tmp_path):
    RUNNER_CASES[case](tmp_path)


@pytest.mark.cuda
def test_complex_chunk_graph_on_card():
    """On the card: a chunk of the complex engine as a CUDA graph replay
    equals the eager chunk bit for bit, and the float64 Philox words equal
    the CPU twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py on the "
                    "card)")
    from hydra_pspec_torch.ops import philox

    dev = torch.device("cuda", 0)
    d, w, fg, ninv, _ = _problem("24x20_dense_flagged")
    ops = tgcr.build_chain_operators(d, w, fg, ninv, device=dev)
    sids = torch.arange(4, dtype=torch.int32, device=dev)
    ps0 = torch.full((4, 20), 5.0, dtype=torch.float64, device=dev)
    prior = _prior(20)
    _, eager = tgibbs.run_chain(ops, ps0, prior, 6, seed=1, sids=sids,
                                iter0=9, graph=False)
    _, graph = tgibbs.run_chain(ops, ps0, prior, 6, seed=1, sids=sids,
                                iter0=9, graph=True)
    for a, b in zip(eager, graph):
        assert torch.equal(a, b)
    ctr = philox._layout64(24, 20, 23, 5, "cpu")
    on_card = philox.philox4x32(9, *(c.to(dev) for c in ctr), 1,
                                sids[:, None])
    on_cpu = philox.philox4x32(9, *ctr, 1, sids.cpu()[:, None])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
