"""The port's real engine (``models/rgibbs.py``) against the JAX package's:
the dense-``Ninv`` host build exactly, the GCR draw on the same omegas with
diagonal and dense noise and as the MAP draw, and one Gibbs step on
external randomness that reproduces the JAX step's key schedule
(``rgibbs.py:294-336``), with 11 bounded prior bins. The JAX side runs
``solver="chol"`` (no Pallas kernel), the port its plain versions."""
import numpy as np
import pytest
import torch

from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb

CPU = torch.device("cpu")
NT, NF, NM, B = 12, 20, 3, 2
SEED = 31
# both sides are float32 solvers with their own product orders: 3e-3 of
# the mean magnitude, as tests/test_mega.py:93 holds the mega draw
TOL = 3e-3


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _dense_ninv(sigma2=1.5, rho=0.5):
    i = np.arange(NF)
    return np.linalg.inv(sigma2 * rho ** np.abs(i[:, None] - i[None, :]))


def _inputs(b, dense):
    rng = np.random.default_rng(SEED + b)
    d = _crandn(rng, NT, NF) * 2.0
    w = np.ones(NF)
    if b == 1:
        w[[4, 13]] = 0.0
    fg = _crandn(rng, NF, NM)
    ninv = _dense_ninv() if dense else np.abs(rng.standard_normal(NF)) + 1.0
    return d, w, fg, ninv


def _ops(dense):
    """Both packages' stacked operators for B baselines."""
    ins = [_inputs(b, dense) for b in range(B)]
    j = jrg.stack_chain_operators([jrg.build_chain_operators(*x)
                                   for x in ins])
    t = trg.stack_chain_operators([trg.build_chain_operators(*x)
                                   for x in ins])
    return j, t


def _c(z):
    """A JAX C pair or array -> complex/real numpy."""
    if hasattr(z, "re"):
        return np.asarray(z.re) + 1j * np.asarray(z.im)
    return np.asarray(z)


def _prior():
    """11 bounded bins around delay 0."""
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 5: NF // 2 + 6] = 400.0
    prior[1, NF // 2 - 5: NF // 2 + 6] = 0.2
    return prior


def _ps():
    return (np.abs(np.random.default_rng(5).standard_normal((B, NF))) * 20.0
            + 1.0).astype(np.float32)


def _omegas(seed):
    rng = np.random.default_rng(seed)
    oa = _crandn(rng, B, NT, NF) * np.sqrt(NF)
    return oa.astype(np.complex64), _crandn(rng, B, NT, NF).astype(
        np.complex64)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).mean()


def case_dense_build_exact():
    j, t = _ops(dense=True)
    for f in trg.RChainOperators._fields:
        if f == "igt":
            continue
        a, b = getattr(t, f), _c(getattr(j, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert trg.is_dense(_dense_ninv()) and not trg.is_dense(np.eye(NF))


def _gcr(dense, omegas):
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    j, t = _ops(dense)
    ps = _ps()
    oa = ob = None
    if omegas:
        oa, ob = _omegas(41)
    cj = lambda z: None if z is None else cplx.from_numpy(z, jnp.float32)
    want = jrg.gcr_solve(j, jnp.asarray(ps), cj(oa), cj(ob), solver="chol")
    ct = lambda z: None if z is None else torch.from_numpy(z)
    got = trg.gcr_solve(trg.to_device(t, CPU), torch.from_numpy(ps), ct(oa),
                        ct(ob), solver="chol")
    for name, g, w in zip(("signal_cr", "fg_amps", "sk"), got, want):
        assert _rel(g.numpy(), _c(w)) < TOL, (name, _rel(g.numpy(), _c(w)))


def case_gcr_diag():
    _gcr(dense=False, omegas=True)


def case_gcr_dense():
    _gcr(dense=True, omegas=True)


def case_gcr_map():
    _gcr(dense=True, omegas=False)


def jax_step_randomness(key, sids):
    """The draws of JAX ``gibbs_step`` under ``key`` for chains ``sids``
    (``rgibbs.py:294-316``, ``invgamma.py:223-264`` with alpha <= 512), in
    the port's layout: complex ``oa``/``ob`` (B, Ntimes, Nfreqs), ``gam``
    (B, Nfreqs), ``u_pb`` (B, bounded bins)."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    npb = int(np.count_nonzero(np.any(_prior() > 0, axis=0)))
    out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
    f32 = jnp.float32
    for sid in sids:
        k_oma, k_omb, k_ps = jax.random.split(jax.random.fold_in(key, sid),
                                              3)
        oa = cplx.standard_normal(k_oma, (NT, NF), dtype=f32)
        scale = np.sqrt(NF).astype(np.float32)
        out["oa"].append(np.asarray(oa.re * scale)
                         + 1j * np.asarray(oa.im * scale))
        out["ob"].append(_c(cplx.standard_normal(k_omb, (NT, NF), dtype=f32)))
        k_gamma, k_u = jax.random.split(k_ps)
        u = jax.random.uniform(k_gamma, (NT - 1, NF), dtype=f32)
        out["gam"].append(np.asarray(-jnp.sum(
            jnp.log(jnp.maximum(u, jnp.finfo(f32).tiny)), axis=0)))
        out["u_pb"].append(np.asarray(jax.random.uniform(k_u, (npb,),
                                                         dtype=f32)))
    out["oa"] = np.asarray(out["oa"], np.complex64)
    out["ob"] = np.asarray(out["ob"], np.complex64)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _step(dense, map_estimate):
    import jax
    import jax.numpy as jnp

    j, t = _ops(dense)
    prior = _prior()
    prior_idx = np.nonzero(np.any(prior > 0, axis=0))[0]
    key = jax.random.fold_in(jax.random.key(SEED), 3)
    ps = _ps()
    ps_j, s_j = jrg.gibbs_step(key, jnp.asarray(ps), j,
                               jnp.asarray(prior, jnp.float32),
                               map_estimate=map_estimate,
                               prior_idx=jnp.asarray(prior_idx),
                               solver="chol")
    rand = jax_step_randomness(key, range(B))
    bins = trb.prior_bins(trb.bounded_bins(prior), CPU)
    ps_t, s_t = trg.gibbs_step(trg.to_device(t, CPU), torch.from_numpy(ps),
                               bins, rand, map_estimate=map_estimate,
                               solver="chol")
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), rtol=2e-3,
                               atol=1e-6)
    assert _rel(s_t.signal_cr.numpy(), _c(s_j.signal_cr)) < TOL
    chi_j = np.asarray(s_j.chisq)
    assert np.abs(s_t.chisq.numpy() - chi_j).max() < TOL * chi_j.mean() * 10
    np.testing.assert_allclose(s_t.ln_post.numpy(), np.asarray(s_j.ln_post),
                               rtol=2e-3)


def case_step_dense():
    _step(dense=True, map_estimate=False)


def case_step_diag():
    _step(dense=False, map_estimate=False)


def case_step_map():
    _step(dense=True, map_estimate=True)


def case_solver_menu():
    """Every solver of the menu on the CPU (their plain versions) solves
    the step's system alike; ``identity`` skips the solve."""
    _, t = _ops(dense=True)
    rops = trg.to_device(t, CPU)
    ps = torch.from_numpy(_ps())
    oa, ob = (torch.from_numpy(z) for z in _omegas(43))
    ref = trg.gcr_solve(rops, ps, oa, ob, solver="chol")[0].numpy()
    for solver in ("auto", "pallas", "pallas2", "pallas2f", "recinv"):
        got = trg.gcr_solve(rops, ps, oa, ob, solver=solver)[0].numpy()
        assert _rel(got, ref) < 1e-3, solver
    m = torch.eye(4, dtype=torch.complex64)[None]
    b = torch.ones((1, 4, 2), dtype=torch.complex64)
    assert trg.solve(m, b, 0.0, "identity") is b
    with pytest.raises(ValueError):
        trg.solve(m, b, 0.0, "lu")


CASES = {f.__name__[5:]: f for f in (
    case_dense_build_exact, case_gcr_diag, case_gcr_dense, case_gcr_map,
    case_step_dense, case_step_diag, case_step_map, case_solver_menu)}


@pytest.mark.parametrize("case", list(CASES))
def test_real_engine(case):
    CASES[case]()
