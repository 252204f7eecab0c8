"""The port's Hermitian factor-solve (``ops/kernels/spd_solve.py``, the
plain version of the ``herm_chol_solve`` kernel on the CPU) and its
``herm_inv`` solve entry against the JAX Pallas solves in interpret mode:
``hermitian_solve_pallas`` (``spd_factor_solve``) and
``hermitian_solve_pallas2`` (``spd_inv_solve``). The matrices are those of
tests/test_pallas_solve.py:52-68, with an e^8 dynamic range; both sides
are float32 solvers on that range, so they agree to 3e-3 of mean |x|, the
limit that test sets."""
import numpy as np
import pytest
import torch

from hydra_pspec_torch.ops.kernels import herm_inv as thi
from hydra_pspec_torch.ops.kernels import spd_solve as tss

B, N, K = 2, 120, 64
TOL = 3e-3


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _problem(seed):
    rng = np.random.default_rng(seed)
    crandn = lambda *s: (rng.standard_normal(s)
                         + 1j * rng.standard_normal(s)) / np.sqrt(2)
    X = crandn(B, N, N)
    m = np.einsum("bij,bkj->bik", X, X.conj()) / N + np.eye(N)
    scale = np.exp(rng.standard_normal(N))
    return m * np.outer(scale, scale)[None], crandn(B, N, K)


def _c64(z):
    return torch.from_numpy(np.asarray(z, np.complex64))


def _jax(fn, m, rhs, **kw):
    """The JAX solve as one jitted program: Pallas interpret mode's host
    callbacks can deadlock against eager ops dispatched while they run."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    run = jax.jit(lambda a, b: fn(a, b, batch_tile=2, **kw))
    return cplx.to_numpy(run(cplx.from_numpy(m, jnp.float32),
                             cplx.from_numpy(rhs, jnp.float32)))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).mean()


def case_chol_matches_pallas():
    from hydra_pspec_tpu.ops.pallas import spd_solve

    m, rhs = _problem(52)
    want = _jax(spd_solve.hermitian_solve_pallas, m, rhs)
    got = tss.hermitian_solve_chol(_c64(m), _c64(rhs)).numpy()
    assert _rel(got, want) < TOL, _rel(got, want)


def case_chol_jitter_matches_pallas():
    """``jitter`` lands on the equilibrated diagonal on both sides; 0.05
    moves the solution by far more than the tolerance."""
    from hydra_pspec_tpu.ops.pallas import spd_solve

    m, rhs = _problem(53)
    want = _jax(spd_solve.hermitian_solve_pallas, m, rhs, jitter=0.05)
    got = tss.hermitian_solve_chol(_c64(m), _c64(rhs), jitter=0.05).numpy()
    assert _rel(got, want) < TOL, _rel(got, want)
    plain = tss.hermitian_solve_chol(_c64(m), _c64(rhs)).numpy()
    assert _rel(plain, want) > 10 * TOL


def case_inv_solve_matches_pallas2():
    """``hermitian_solve`` (herm_inv + refine) against
    ``hermitian_solve_pallas2`` with one refinement step and jitter."""
    from hydra_pspec_tpu.ops.pallas import spd_inv

    m, rhs = _problem(54)
    want = _jax(spd_inv.hermitian_solve_pallas2, m, rhs, refine=1,
                jitter=0.05)
    got = thi.hermitian_solve(_c64(m), _c64(rhs), refine=1,
                              jitter=0.05).numpy()
    assert _rel(got, want) < TOL, _rel(got, want)


def case_residual_and_kernel_contract():
    """The plain factor-solve solves to float32 residual (the limit of
    tests/test_pallas_solve.py:33-39) at the real engine's odd K, and the
    wrapper takes the plain version only for CPU tensors."""
    rng = np.random.default_rng(55)
    a = rng.standard_normal((3, N, N)) + 1j * rng.standard_normal((3, N, N))
    m = np.einsum("bij,bkj->bik", a, a.conj()) / N + np.eye(N)
    rhs = rng.standard_normal((3, N, 203)) + 0j
    x = tss.herm_chol_solve(_c64(m), _c64(rhs)).numpy()
    resid = np.einsum("bij,bjk->bik", m.astype(np.complex64), x) - rhs
    assert np.abs(resid).max() < 2e-4, np.abs(resid).max()
    with pytest.raises(ValueError, match="devices"):
        tss.herm_chol_solve(_c64(m), _c64(rhs).to("meta"))


CASES = {f.__name__[5:]: f for f in (
    case_chol_matches_pallas, case_chol_jitter_matches_pallas,
    case_inv_solve_matches_pallas2, case_residual_and_kernel_contract)}


@pytest.mark.parametrize("case", list(CASES))
def test_spd_solve(case):
    CASES[case]()


@pytest.mark.cuda
def test_herm_chol_solve_kernel_on_card():
    """The kernel against its plain version on the card at the real
    engine's shapes (n = 120, K = 203); chip_smoke.py runs the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    dev = torch.device("cuda", 0)
    m, _ = _problem(56)
    rhs = np.random.default_rng(57).standard_normal((B, N, 203)) + 0j
    ms, _ = tss.equilibrate(_c64(m).to(dev))
    b = _c64(rhs).to(dev)
    got = tss.herm_chol_solve(ms, b)
    want = tss.plain_herm_chol_solve(ms, b)
    assert float(torch.abs(got - want).max()
                 / torch.abs(want).mean()) < TOL
