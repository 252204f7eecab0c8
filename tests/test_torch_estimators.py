"""The port's LSSA, OQE and DPSS estimators (``hydra_pspec_torch/models/
lssa.py``, ``oqe.py``, ``dpss.py``) against the JAX package's, on the same
seeded numpy inputs at complex128, within rtol 1e-10 (with an absolute
floor of 1e-10 of the largest magnitude, for entries that are zero up to
rounding); and, as ``tests/test_estimators.py`` does for the JAX package,
against the reference's loop and optimiser formulations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from hydra_pspec_tpu.models import dpss as jdpss
from hydra_pspec_tpu.models import lssa as jlssa
from hydra_pspec_tpu.models import oqe as joqe
from hydra_pspec_torch.models import dpss, lssa, oqe

RTOL = 1e-10


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    floor = rtol * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- LSSA (tests/test_estimators.py::TestLSSA) -------------------------------

def _lssa_problem(n=12):
    rng = np.random.default_rng(21)
    freqs = 100.0 + 0.1 * np.arange(n)   # MHz
    d = _crandn(rng, n)
    X = _crandn(rng, n, n)
    invcov = np.linalg.inv(X @ X.conj().T + np.eye(n))
    return rng, freqs, d, invcov


def case_lssa_fit_against_jax():
    rng, freqs, d, invcov = _lssa_problem()
    taper = 0.5 + rng.random(freqs.size)
    tau = jlssa.default_tau(freqs)
    _close(lssa.default_tau(_t(freqs), device="cpu"), tau)
    for amp_phase, kw in ((False, dict(invcov=invcov, tau=tau[:4])),
                          (True, dict(invcov=invcov, taper=taper)),
                          (True, dict())):
        got = lssa.lssa_fit_modes(_t(d), _t(freqs), fit_amp_phase=amp_phase,
                                  device="cpu",
                                  **{k: _t(v) for k, v in kw.items()})
        want = jlssa.lssa_fit_modes(d, freqs, fit_amp_phase=amp_phase, **kw)
        for g, w in zip(got, want):
            _close(g, w)


def case_lssa_fit_against_optimizer():
    """Reference lssa.py:170-207: L-BFGS-B on the GLS objective per tau."""
    _, freqs, d, invcov = _lssa_problem()
    tau = jlssa.default_tau(freqs)[:4]
    _, are, aim = lssa.lssa_fit_modes(_t(d), _t(freqs), _t(invcov),
                                      fit_amp_phase=False, tau=_t(tau),
                                      device="cpu")
    _, amp, phase = lssa.lssa_fit_modes(_t(d), _t(freqs), _t(invcov),
                                        fit_amp_phase=True, tau=_t(tau),
                                        device="cpu")
    np.testing.assert_allclose(_np(amp) * np.exp(1j * _np(phase)),
                               _np(are) + 1j * _np(aim), atol=1e-8)
    for i, t in enumerate(tau):
        def loglike(p):
            x = d - (p[0] + 1j * p[1]) * np.exp(-2j * np.pi * t * freqs)
            return 0.5 * np.real(x.conj() @ invcov @ x)

        r = min((minimize(loglike, p0, method="L-BFGS-B")
                 for p0 in ([0.2, 0.5], [-0.3, 2.0], [1.0, 4.0])),
                key=lambda r: r.fun)
        assert float(are[i]) == pytest.approx(r.x[0], abs=1e-4)
        assert float(aim[i]) == pytest.approx(r.x[1], abs=1e-4)


def case_lssa_models_and_decorrelation():
    rng, freqs, _, _ = _lssa_problem()
    w = np.ones(freqs.size)
    w[3] = 0
    tau = jlssa.default_tau(freqs)
    amp, ph = rng.random(), rng.random() * 6
    _close(lssa.model_ap(amp, ph, 0.37, _t(freqs), device="cpu"),
           jlssa.model_ap(amp, ph, 0.37, freqs))
    _close(lssa.model_aa(amp, ph, 0.37, _t(freqs), device="cpu"),
           jlssa.model_aa(amp, ph, 0.37, freqs))
    for t in (0.37, tau[5]):
        rot, ev = lssa.decorr_matrix(_t(w), t, _t(freqs), device="cpu")
        jrot, jev = jlssa.decorr_matrix(w, t, freqs)
        _close(rot, jrot)
        _close(ev, jev)
        # the reference formula (lssa.py:14-69)
        c = w * np.cos(2 * np.pi * t * freqs)
        s = w * np.sin(2 * np.pi * t * freqs)
        th = 0.5 * np.arctan2(2 * np.sum(c * s), np.sum(c**2) - np.sum(s**2))
        rot_ref = np.array([[np.cos(th), np.sin(th)],
                            [-np.sin(th), np.cos(th)]])
        np.testing.assert_allclose(_np(rot), rot_ref, atol=1e-12)
    are, aim = rng.standard_normal(tau.size), rng.standard_normal(tau.size)
    ours = _np(lssa.decorr_pspec(_t(are), _t(aim), _t(w), _t(tau),
                                 _t(freqs), device="cpu"))
    _close(ours, jlssa.decorr_pspec(are, aim, w, tau, freqs))
    for i, t in enumerate(tau):   # the reference loop (lssa.py:73-92)
        rot, ev = jlssa.decorr_matrix(w, t, freqs)
        a1, a2 = np.asarray(rot) @ np.array([are[i], aim[i]])
        ev = np.asarray(ev)
        want = ((a1 * ev[1]) ** 2 + (a2 * ev[0]) ** 2) / (ev[0]**2 + ev[1]**2)
        assert ours[i] == pytest.approx(want, rel=1e-9)


# --- OQE (tests/test_estimators.py::TestOQE) ---------------------------------

S = 10


def _oqe_problem():
    rng = np.random.default_rng(22)
    R = _crandn(rng, S, S) + 2.0 * np.eye(S)   # non-Hermitian weighting
    C = np.eye(S) * 0.3 + 0.05 * np.ones((S, S))
    return rng, R, C


def _Q_naive(tau):
    y = np.zeros(S)
    y[tau] = 1
    mv = np.fft.fft(y)
    return np.outer(mv.conj(), mv)


def case_oqe_estimator_values():
    rng, R, C = _oqe_problem()
    x, x1, x2 = _crandn(rng, S), _crandn(rng, S), _crandn(rng, S)
    for tau in (0, 3, 7):
        _close(oqe.m(tau, S, device="cpu"), joqe.m(tau, S))
        _close(oqe.Q(tau, S, device="cpu"), joqe.Q(tau, S))
        np.testing.assert_allclose(_np(oqe.Q(tau, S, device="cpu")),
                                   _Q_naive(tau),
                                   atol=1e-10)
    b = _np(oqe.bias(_t(R), _t(C), device="cpu"))
    _close(b, joqe.bias(jnp.asarray(R), jnp.asarray(C)))
    qa = _np(oqe.qhat_all(_t(x), _t(R), device="cpu"))
    _close(qa, joqe.qhat_all(jnp.asarray(x), jnp.asarray(R)))
    _close(oqe.qhat_all(_t(x), _t(R), _t(b), device="cpu"),
           joqe.qhat_all(jnp.asarray(x), jnp.asarray(R), jnp.asarray(b)))
    qh = _np(oqe.qhat_h_all(_t(x1), _t(x2), _t(R), device="cpu"))
    _close(qh, joqe.qhat_h_all(jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(R)))
    for tau in range(S):   # the reference's per-tau forms (oqe.py:23-40)
        Q = _Q_naive(tau)
        assert qa[tau] == pytest.approx(
            0.5 * (x.conj() @ R.conj() @ Q @ R @ x), rel=1e-9)
        assert qh[tau] == pytest.approx(
            0.5 * (R @ x1).conj() @ Q @ (R @ x2), rel=1e-9)
        assert b[tau] == pytest.approx(
            0.5 * np.trace(C @ R.conj() @ Q @ R), rel=1e-9)
        assert complex(oqe.qhat(_t(x), tau, S, _t(R), 0.25, device="cpu")) == \
            pytest.approx(complex(joqe.qhat(jnp.asarray(x), tau, S,
                                            jnp.asarray(R), 0.25)), rel=RTOL)
        assert complex(oqe.qhat_h(_t(x1), _t(x2), tau, S, _t(R),
                                  device="cpu")) == \
            pytest.approx(complex(joqe.qhat_h(jnp.asarray(x1),
                                              jnp.asarray(x2), tau, S,
                                              jnp.asarray(R))), rel=RTOL)


def case_oqe_fisher_and_normalisations():
    _, R, C = _oqe_problem()
    Fm = _np(oqe.F(_t(R), device="cpu"))
    _close(Fm, joqe.F(jnp.asarray(R)))
    want = np.array([[0.5 * np.trace(R.conj() @ _Q_naive(a) @ R
                                      @ _Q_naive(b))
                      for b in range(S)] for a in range(S)])
    np.testing.assert_allclose(Fm, want, atol=1e-8)
    _close(oqe.M_Finv(_t(Fm), device="cpu"), joqe.M_Finv(jnp.asarray(Fm)))
    _close(oqe.M_opt(_t(Fm), device="cpu"), joqe.M_opt(jnp.asarray(Fm)))
    # Hermitian PSD Fisher from Hermitian R
    Fh = _np(oqe.F(_t(C * 3.0), device="cpu"))
    Mh = _np(oqe.M_Fhalf(_t(Fh), device="cpu"))
    _close(Mh, joqe.M_Fhalf(jnp.asarray(Fh)))
    H = 0.5 * (Fh + Fh.conj().T)
    np.testing.assert_allclose(Mh @ H @ Mh, np.eye(S), atol=1e-7)
    got, want = oqe.matc(_t(R), device="cpu"), joqe.matc(jnp.asarray(R))
    assert got[0] == want[0]
    assert got[1:] == pytest.approx(want[1:], rel=RTOL)


def case_oqe_batches_and_error_bars():
    rng, R, C = _oqe_problem()
    V = _crandn(rng, 6, S)
    b = np.asarray(joqe.bias(jnp.asarray(R), jnp.asarray(C)))
    Fm = np.asarray(joqe.F(jnp.asarray(R)))
    qv = _np(oqe.q(_t(V), S, _t(R), _t(b), device="cpu"))
    _close(qv, joqe.q(V, S, jnp.asarray(R), b))
    _close(oqe.p(_t(qv[0]).to(torch.complex128), _t(Fm), device="cpu"),
           joqe.p(jnp.asarray(qv[0]), jnp.asarray(Fm)))
    _close(oqe.q_h(_t(V), S, _t(R), device="cpu"),
           joqe.q_h(V, S, jnp.asarray(R)))
    _close(oqe.q_hp(_t(V), S, _t(R), device="cpu"),
           joqe.q_hp(V, S, jnp.asarray(R)))
    got = oqe.getqs(_t(V), _t(C * 2.0), device="cpu")
    for g, w in zip(got, joqe.getqs(V, jnp.asarray(C * 2.0))):
        _close(g, w)
    Cs = np.eye(S) * 0.8 + 0.02
    for norm in (np.linspace(0.5, 1.5, S), 0.7):
        sn = _np(oqe.Sig_QEN(_t(R), _t(C), _t(np.asarray(norm)), device="cpu"))
        _close(sn, joqe.Sig_QEN(jnp.asarray(R), jnp.asarray(C), norm))
        ssn = _np(oqe.Sig_QESN(_t(R), _t(C), _t(Cs), _t(np.asarray(norm)),
                               device="cpu"))
        _close(ssn, joqe.Sig_QESN(jnp.asarray(R), jnp.asarray(C),
                                  jnp.asarray(Cs), norm))
    for i in range(S):   # the reference's traces (oqe.py:161-185), norm 0.7
        E = R @ _Q_naive(i) @ R * 0.7
        assert sn[i] == pytest.approx(
            0.5 * np.trace(E @ C @ E @ C), rel=1e-8)
        assert ssn[i] == pytest.approx(0.5 * np.trace(
            E @ C @ E @ C + E @ Cs @ E @ C + E @ C @ E @ Cs), rel=1e-8)


# --- DPSS (tests/test_estimators.py::TestDPSS) -------------------------------

def case_dpss_fit_against_jax_and_optimizer():
    rng = np.random.default_rng(23)
    n, nmodes = 24, 4
    freqs = 100 + 0.1 * np.arange(n)
    w = np.ones(n)
    w[5] = 0
    X = _crandn(rng, n, n)
    cov = X @ X.conj().T + 2.0 * np.eye(n)
    d = _crandn(rng, n) * 2
    taper = 0.5 + rng.random(n)
    for kw in (dict(), dict(taper=taper, alpha=1.5)):
        modes, amps = dpss.dpss_fit_modes(
            _t(d), _t(w), _t(freqs), _t(cov), nmodes=nmodes,
            device="cpu",
            **{k: (_t(v) if k == "taper" else v) for k, v in kw.items()})
        jmodes, jamps = jdpss.dpss_fit_modes(d, w, freqs, cov,
                                             nmodes=nmodes, **kw)
        _close(modes, jmodes)
        _close(amps, jamps)
    modes, amps = dpss.dpss_fit_modes(_t(d), _t(w), _t(freqs), _t(cov),
                                      nmodes=nmodes, device="cpu")
    invcov = np.linalg.inv(cov)
    basis = _np(modes)

    def loglike(p):   # reference dpss.py:78-89
        x = w * (d - ((p[0::2, None] + 1j * p[1::2, None]) * basis).sum(0))
        return 0.5 * np.real(x.conj() @ invcov @ x)

    r = minimize(loglike, np.zeros(2 * nmodes), method="L-BFGS-B")
    assert loglike(_np(amps)) <= r.fun + 1e-6
    np.testing.assert_allclose(_np(amps), r.x, atol=1e-3)


def case_dpss_basis_and_model():
    from scipy.signal.windows import dpss as sdpss

    b = dpss.dpss_basis(64, 6, alpha=1.5)
    np.testing.assert_array_equal(b, jdpss.dpss_basis(64, 6, alpha=1.5))
    np.testing.assert_allclose(b, sdpss(64, NW=1.5, Kmax=6, sym=False))
    np.testing.assert_array_equal(dpss.dpss_operator(64, 6, 1.5), b.T)
    modes = dpss.dpss_basis(16, 3)
    amps = np.array([1.0, -0.5, 0.3, 0.2, 0.0, 1.1])
    m = _np(dpss.dpss_model(_t(modes), _t(amps), device="cpu"))
    _close(m, jdpss.dpss_model(modes, amps))
    z = amps[0::2] + 1j * amps[1::2]
    np.testing.assert_allclose(m, (z[:, None] * modes).sum(0), atol=1e-12)


def case_device_argument():
    """Every estimator, and every API mirror the package re-exports, takes
    ``device``: with no tensor among its inputs it computes there (the
    card by default, so a machine without one refuses numpy inputs rather
    than computing on the CPU); tensors keep their device and the numbers
    beside them follow; numpy inputs with ``device="cpu"`` give the CPU
    tensor inputs' values bit for bit."""
    from hydra_pspec_torch.ops import fourier, invgamma

    rng, freqs, d, invcov = _lssa_problem()
    _, R, C = _oqe_problem()
    x = _crandn(rng, S)
    w = np.ones(freqs.size)
    w[3] = 0
    tau = np.asarray(jlssa.default_tau(freqs))
    are, aim = rng.standard_normal(tau.size), rng.standard_normal(tau.size)
    s = _crandn(rng, 12, S)
    gam, u = 5.0 + rng.random(S), rng.random(S)
    calls = (
        (lssa.lssa_fit_modes, (d, freqs, invcov), {}),
        (lssa.decorr_pspec, (are, aim, w, tau, freqs), {}),
        (lssa.model_aa, (0.3, 0.4, 0.37, freqs), {}),
        (oqe.F, (R,), {}), (oqe.qhat_all, (x, R), {}),
        (oqe.bias, (R, C), {}), (oqe.Sig_QESN, (R, C, C * 2.0, 0.7), {}),
        (oqe.m, (3, S), {}),
        (dpss.dpss_fit_modes, (d, w, freqs, np.linalg.inv(invcov)), {}),
        (dpss.dpss_model, (dpss.dpss_basis(freqs.size, 3),
                           np.arange(6.0)), {}),
        (fourier.fourier_operator, (S,), {}),
        (invgamma.sprior, (s, 2, 5.0), {}),
        (invgamma.sample_S, (s,), dict(gam=gam, u=u)),
        (invgamma.inversion_sample_invgamma, (10.0, 30.0, 0.5, 8.0),
         dict(u=0.25)),
    )
    as_t = lambda a: _t(a) if isinstance(a, np.ndarray) else a
    for fn, args, kw in calls:
        got = fn(*args, device="cpu", **kw)
        got = got if isinstance(got, tuple) else (got,)
        tensors = [as_t(a) for a in args]
        tkw = {k: as_t(v) for k, v in kw.items()}
        if any(torch.is_tensor(a) for a in tensors + list(tkw.values())):
            kept = fn(*tensors, **tkw)   # the default device, CPU tensors
            kept = kept if isinstance(kept, tuple) else (kept,)
            for g, k in zip(got, kept):
                assert g.device.type == k.device.type == "cpu"
                assert torch.equal(g, k)
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                fn(*args, **kw)


def case_package_exports():
    """The package re-exports the estimators and the reference API
    mirrors, as the JAX package's ``__init__.py:31-34`` does."""
    import hydra_pspec_torch as hpt
    from hydra_pspec_torch.models import gcr, gibbs
    from hydra_pspec_torch.ops import fourier, invgamma

    assert (hpt.lssa, hpt.oqe, hpt.dpss, hpt.gibbs, hpt.gcr) == \
        (lssa, oqe, dpss, gibbs, gcr)
    assert hpt.gibbs_sample_with_fg is gibbs.gibbs_sample_with_fg
    assert hpt.gibbs_step_fgmodes is gibbs.gibbs_step_fgmodes
    assert hpt.sample_S is invgamma.sample_S
    assert hpt.sprior is invgamma.sprior
    assert hpt.inversion_sample_invgamma is invgamma.inversion_sample_invgamma
    assert hpt.fourier_operator is fourier.fourier_operator
    with pytest.raises(AttributeError):
        hpt.pspec


CASES = {f.__name__[5:]: f for f in (
    case_lssa_fit_against_jax, case_lssa_fit_against_optimizer,
    case_lssa_models_and_decorrelation, case_oqe_estimator_values,
    case_oqe_fisher_and_normalisations, case_oqe_batches_and_error_bars,
    case_dpss_fit_against_jax_and_optimizer, case_dpss_basis_and_model,
    case_device_argument, case_package_exports)}


@pytest.mark.parametrize("case", list(CASES))
def test_estimators_equal_jax(case):
    CASES[case]()
