"""The port's Hermitian inverse and solve (plain torch versions of the
herm_inv and cgemm kernels) against the JAX recursive-inverse solve
``hermitian_solve_pallas2`` in interpret mode. Limits are those of
tests/test_pallas_inv.py: residual < 2e-4, agreement < 3e-3."""
import numpy as np
import pytest
import torch

from hydra_pspec_torch.ops.kernels import cgemm as tcg
from hydra_pspec_torch.ops.kernels import herm_inv as thi

RNG = np.random.default_rng(78)


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def crandn(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


def _hpd(b, n, spread=True):
    X = crandn(b, n, n)
    m = np.einsum("bij,bkj->bik", X, X.conj()) / n + np.eye(n)
    if spread:
        s = np.exp(RNG.standard_normal(n))
        m = m * np.outer(s, s)[None]
    return m


def c64(z):
    return torch.from_numpy(np.asarray(z, np.complex64))


def case_matches_pallas2():
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx
    from hydra_pspec_tpu.ops.pallas import spd_inv

    b, n, k = 2, 120, 64
    m, rhs = _hpd(b, n), crandn(b, n, k)
    want = cplx.to_numpy(spd_inv.hermitian_solve_pallas2(
        cplx.from_numpy(m, jnp.float32), cplx.from_numpy(rhs, jnp.float32),
        batch_tile=2))
    got = thi.hermitian_solve(c64(m), c64(rhs)).numpy()
    assert np.abs(got - want).max() / np.abs(want).mean() < 3e-3


def case_residual():
    b, n, k = 3, 128, 128
    m, rhs = _hpd(b, n, spread=False), crandn(b, n, k)
    x = thi.hermitian_solve(c64(m), c64(rhs)).numpy()
    resid = np.einsum("bij,bjk->bik", m.astype(np.complex64), x) - rhs
    assert np.abs(resid).max() < 2e-4, np.abs(resid).max()


def case_inverse():
    b, n = 2, 128
    m = c64(_hpd(b, n, spread=False))
    inv = thi.herm_inv(m)
    eye = torch.eye(n, dtype=torch.complex64)
    assert float(torch.abs(m @ inv - eye).max()) < 1e-4
    # Hermitian by construction (both triangles from one formula)
    assert torch.allclose(inv, inv.transpose(1, 2).conj(), atol=1e-6)


def case_cgemm_ops():
    """Every op, shared and per-chain A, and the epilogue, against complex128
    numpy; op N also against the JAX kernels' Gauss product _cmm."""
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops.pallas.megastep import _cmm

    B, M, K, N = 2, 16, 128, 40
    a_n, a_t = crandn(B, M, K), crandn(B, K, M)
    bb, x = crandn(B, K, N), crandn(B, M, N)
    cases = [("N", a_n, a_n), ("T", a_t, np.swapaxes(a_t, 1, 2)),
             ("H", a_t, np.swapaxes(a_t, 1, 2).conj()),
             ("N", a_n[0], a_n[0][None])]
    for op, a, aop in cases:
        got = tcg.cgemm(c64(a), c64(bb), op=op, x=c64(x), alpha=-0.5,
                        beta=2.0).numpy()
        want = -0.5 * (aop @ bb) + 2.0 * x
        assert np.abs(got - want).max() / np.abs(want).mean() < 1e-5, op
    jr, ji = _cmm(jnp.asarray(a_n.real, jnp.float32),
                  jnp.asarray(a_n.imag, jnp.float32),
                  jnp.asarray(bb.real, jnp.float32),
                  jnp.asarray(bb.imag, jnp.float32))
    got = tcg.cgemm(c64(a_n), c64(bb)).numpy()
    want = np.asarray(jr) + 1j * np.asarray(ji)
    # the JAX product is a Gauss 3-mult of 3-pass bf16-split matmuls:
    # f32 grade but with its own cancellation, ~1e-5 relative
    assert np.abs(got - want).max() / np.abs(want).mean() < 1e-4


CASES = {f.__name__[5:]: f for f in (case_matches_pallas2, case_residual,
                                      case_inverse, case_cgemm_ops)}


@pytest.mark.parametrize("case", list(CASES))
def test_hermitian_solve(case):
    CASES[case]()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Every hand-written kernel against its plain version on the card
    (chip_smoke.py's kernel phase, at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    import chip_smoke
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.cli.run import legendre_fgmodes

    jobs = chip_smoke.make_jobs(8, runner.BaselineJob, legendre_fgmodes)
    wide = chip_smoke.make_jobs(8, runner.BaselineJob, legendre_fgmodes,
                                nf=chip_smoke.WIDE_NF)
    errs = {}
    chip_smoke.phase_kernels(torch.device("cuda", 0), jobs, wide, errs)
    assert set(errs) == set(chip_smoke.KERNELS)
