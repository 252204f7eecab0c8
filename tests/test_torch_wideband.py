"""More than 128 channels in the port: the blocked Hermitian inverse
(``herm_inv.blocked_herm_inv``) and factor-solve
(``spd_solve.blocked_herm_chol_solve``) over their plain bases at several
recursion depths, and held against the JAX package at n = 140; the
equilibrated solves at n = 180 (one launch of each kernel on the card)
against the JAX package's; a megachain
chunk at 140 channels (n = 256) and the real engine with a dense ``Ninv``
at 140 channels against the JAX engines; and the ``cgemm`` wrapper's
contract on the CPU at the skinny, ragged and wide shapes its kernel
serves.

The JAX references run as their own tests run them: the megachain kernel
and ``hermitian_solve_pallas`` (``spd_factor_solve``) in Pallas interpret
mode (at n = 180 in a subprocess started before the module's first case,
so that its 20 s interpret compile overlaps them), the real engine with
``solver="chol"`` (XLA). The blocked inverse is
held against the XLA solve ``cplx.hermitian_solve``: the Pallas
recursive-inverse entry ``hermitian_solve_pallas2`` pads the 2n = 280 real
embedding of n = 140 to 384, which its power-of-two Schur recursion
cannot split (it recurses without end), and one more interpret compile
would double this file's time. Limits are those of the port's earlier
tests: residual 1e-4 (inverse) and 2e-4 (solve), agreement 3e-3 of the
mean magnitude (tests/test_pallas_inv.py), and the chain tolerances of
tests/test_torch_megachain.py."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.ops.kernels import cgemm as tcg
from hydra_pspec_torch.ops.kernels import herm_inv as thi
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.ops.kernels import spd_solve as tss
from hydra_pspec_torch.ops.kernels.impl import PLAIN

CPU = torch.device("cpu")
TOL = 3e-3
WIDE = 140                      # channels: the padded megachain n is 256


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _hpd(rng, b, n, spread=False):
    x = _crandn(rng, b, n, n)
    m = np.einsum("bij,bkj->bik", x, x.conj()) / n + np.eye(n)
    if spread:
        s = np.exp(rng.standard_normal(n))
        m = m * np.outer(s, s)[None]
    return m


def _c64(z):
    return torch.from_numpy(np.asarray(z, np.complex64))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).mean()


class _Spy:
    """A plain base that records the size of every block it is given."""

    def __init__(self, fn):
        self.fn, self.sizes = fn, []

    def __call__(self, a, *rest):
        self.sizes.append(a.shape[-1])
        return self.fn(a, *rest)


def _leaves(n, base_n):
    """The base block sizes of the recursion at ``n``, in call order."""
    if n <= base_n:
        return [n]
    n1 = tss.split_at(n, base_n)
    return _leaves(n1, base_n) + _leaves(n - n1, base_n)


DEPTHS = [(b, n) for b in (32, 64, 128) for n in (100, 140, 256, 300)]


@pytest.mark.parametrize("base_n,n", DEPTHS)
def test_blocked_inverse(base_n, n):
    """Equilibrated HPD matrices: |A X - I| < 1e-4, X Hermitian, and X
    against the whole-matrix plain inverse at 3e-3 of its mean; every
    base call of at most ``base_n``, one per leaf of the split."""
    rng = np.random.default_rng(n + base_n)
    ms, _ = tss.equilibrate(_c64(_hpd(rng, 2, n, spread=True)))
    base = _Spy(thi.plain_herm_inv)
    inv = thi.blocked_herm_inv(ms, base=base, mm=tcg.plain_cgemm,
                               base_n=base_n)
    assert base.sizes == _leaves(n, base_n)
    assert max(base.sizes) <= base_n
    eye = torch.eye(n, dtype=torch.complex64)
    assert float(torch.abs(ms @ inv - eye).max()) < 1e-4
    assert torch.allclose(inv, inv.transpose(1, 2).conj(), atol=1e-6)
    assert _rel(inv.numpy(), thi.plain_herm_inv(ms).numpy()) < TOL


@pytest.mark.parametrize("base_n,n", DEPTHS)
def test_blocked_factor_solve(base_n, n):
    """The residual of the block elimination < 2e-4 at an odd right-hand
    side count, agreement with the whole-matrix plain factor-solve, and
    one base call of at most ``base_n`` per leaf of the split."""
    rng = np.random.default_rng(7 * n + base_n)
    ms, _ = tss.equilibrate(_c64(_hpd(rng, 2, n, spread=True)))
    rhs = _c64(_crandn(rng, 2, n, 17))
    base = _Spy(tss.plain_herm_chol_solve)
    x = tss.blocked_herm_chol_solve(ms, rhs, base=base, mm=tcg.plain_cgemm,
                                    base_n=base_n)
    assert base.sizes == _leaves(n, base_n)
    assert max(base.sizes) <= base_n
    assert float(torch.abs(ms @ x - rhs).max()) < 2e-4
    assert _rel(x.numpy(), tss.plain_herm_chol_solve(ms, rhs).numpy()) < TOL


def _jax_solve(fn, m, rhs):
    """The JAX solve as one jitted program (Pallas interpret mode's host
    callbacks can deadlock against eager ops dispatched while they run)."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    run = jax.jit(fn)
    return cplx.to_numpy(run(cplx.from_numpy(m, jnp.float32),
                             cplx.from_numpy(rhs, jnp.float32)))


def case_inverse_solve_vs_xla():
    """``hermitian_solve`` with the blocked inverse (base 128: blocks of
    128 and 12) against ``cplx.hermitian_solve``."""
    from hydra_pspec_tpu.ops import cplx

    rng = np.random.default_rng(140)
    m, rhs = _hpd(rng, 1, WIDE, spread=True), _crandn(rng, 1, WIDE, 16)
    want = _jax_solve(cplx.hermitian_solve, m, rhs)
    inv = functools.partial(thi.blocked_herm_inv, base=thi.plain_herm_inv,
                            mm=tcg.plain_cgemm)
    got = thi.hermitian_solve(_c64(m), _c64(rhs), inv=inv,
                              mm=tcg.plain_cgemm).numpy()
    assert _rel(got, want) < TOL, _rel(got, want)


def case_factor_solve_vs_pallas():
    """``hermitian_solve_chol`` with the blocked factor-solve (base 64:
    blocks of 64, 64 and 12) against ``hermitian_solve_pallas``."""
    from hydra_pspec_tpu.ops.pallas import spd_solve

    rng = np.random.default_rng(141)
    m, rhs = _hpd(rng, 1, WIDE, spread=True), _crandn(rng, 1, WIDE, 16)
    want = _jax_solve(lambda a, b: spd_solve.hermitian_solve_pallas(
        a, b, batch_tile=1), m, rhs)
    solve = functools.partial(tss.blocked_herm_chol_solve,
                              base=tss.plain_herm_chol_solve,
                              mm=tcg.plain_cgemm, base_n=64)
    got = tss.hermitian_solve_chol(_c64(m), _c64(rhs), solve=solve).numpy()
    assert _rel(got, want) < TOL, _rel(got, want)


SOLVES = {f.__name__[5:]: f for f in (case_inverse_solve_vs_xla,
                                      case_factor_solve_vs_pallas)}


@pytest.mark.parametrize("case", list(SOLVES))
def test_blocked_solve_matches_jax(case):
    SOLVES[case]()


# n = 180, the width one launch of each kernel serves on the card
# (128 < n <= 192): an equilibrated system and 16 right-hand sides
ONE_LAUNCH_N = 180


@functools.lru_cache(maxsize=None)
def _one_launch_system():
    rng = np.random.default_rng(ONE_LAUNCH_N)
    ms, _ = tss.equilibrate(_c64(_hpd(rng, 1, ONE_LAUNCH_N, spread=True)))
    return ms, _crandn(rng, 1, ONE_LAUNCH_N, 16)


# ``hermitian_solve_pallas`` at n = 180 in Pallas interpret mode, in a
# fresh process with synchronous CPU dispatch (as tests/test_torch_tflags.py
# runs its kernel calls): its interpret compile takes about 20 s, which the
# module's earlier cases overlap. It imports numpy, jax and the JAX
# package only, and reads its inputs from an npz.
_PALLAS_SIDE = r"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_enable_x64", True)
from jax.experimental.pallas import tpu as pltpu

from hydra_pspec_tpu.ops import cplx
from hydra_pspec_tpu.ops.pallas import spd_solve

root = Path(sys.argv[1])
z = np.load(root / "inputs.npz")
run = jax.jit(lambda a, b: spd_solve.hermitian_solve_pallas(
    a, b, batch_tile=1))
with pltpu.force_tpu_interpret_mode():
    x = cplx.to_numpy(run(cplx.from_numpy(z["m"], jnp.float32),
                          cplx.from_numpy(z["rhs"], jnp.float32)))
np.save(root / "x.npy", x)
"""


@pytest.fixture(scope="module", autouse=True)
def pallas_solve_proc(tmp_path_factory):
    """The Pallas factor-solve at n = 180, started once before the
    module's first case: (process, its directory). Killed at the module's
    end if still running."""
    root = tmp_path_factory.mktemp("wide_pallas_solve")
    ms, rhs = _one_launch_system()
    np.savez(root / "inputs.npz", m=ms.numpy().astype(np.complex128),
             rhs=rhs)
    proc = subprocess.Popen(
        [sys.executable, "-c", _PALLAS_SIDE, str(root)],
        cwd=Path(__file__).resolve().parents[1],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, root
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_one_launch_solves_match_jax(pallas_solve_proc):
    """At n = 180: ``hermitian_solve`` (the ``herm_inv`` entry) against
    the XLA ``cplx.hermitian_solve`` and ``hermitian_solve_chol`` (the
    factor-solve) against ``hermitian_solve_pallas`` in interpret mode,
    on an equilibrated system: residuals under 1e-4 and 2e-4, agreement
    within 3e-3 of the mean magnitude."""
    from hydra_pspec_tpu.ops import cplx

    ms, rhs = _one_launch_system()
    m = ms.numpy().astype(np.complex128)
    proc, root = pallas_solve_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    for got, want, res in (
            (thi.hermitian_solve(ms, _c64(rhs)),
             _jax_solve(cplx.hermitian_solve, m, rhs), 1e-4),
            (tss.hermitian_solve_chol(ms, _c64(rhs)),
             np.load(root / "x.npy"), 2e-4)):
        assert float(torch.abs(ms @ got - _c64(rhs)).max()) < res
        assert _rel(got.numpy(), want) < TOL, _rel(got.numpy(), want)


# --- a megachain chunk at 140 channels -----------------------------------

def _jax_arrays(mops) -> dict:
    out = {f: np.asarray(getattr(mops, f)) for f in mops._fields
           if f != "igt"}
    out.update(igt_log_y=np.asarray(mops.igt.log_y),
               igt_q=np.asarray(mops.igt.q),
               igt_alpha=np.asarray(mops.igt.alpha))
    return out


@functools.lru_cache(maxsize=None)
def _chain_setup():
    """Ntimes = 10, Nfreqs = 140, 2 modes, K = 2, B = 2, 3 prior bins; the
    external randomness in the JAX layout (tests/test_torch_megachain.py)."""
    ntimes, K, B = 10, 2, 2
    rng = np.random.default_rng(5)
    d = _crandn(rng, ntimes, WIDE) * 2.0
    fg = _crandn(rng, WIDE, 2)
    ninv = np.abs(rng.standard_normal(WIDE)) + 1.0
    mops, dims = jmega.build_mega_operators(d, np.ones(WIDE), fg, ninv)
    mops_b = jmega.broadcast_mega_operators(mops, B)
    ps0 = np.abs(rng.standard_normal((B, WIDE))) * 10.0 + 0.5
    n, t = dims.n, dims.t
    sa = np.float32(np.sqrt(0.5) * np.sqrt(WIDE))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    rnd = {"oa_re": f32(rng.standard_normal((K, B, n, t))) * sa,
           "oa_im": f32(rng.standard_normal((K, B, n, t))) * sa,
           "ob_re": f32(rng.standard_normal((K, B, n, t))) * hf,
           "ob_im": f32(rng.standard_normal((K, B, n, t))) * hf,
           "gam": f32(rng.gamma(ntimes - 1, size=(K, B, n))),
           "u_pb": f32(rng.uniform(size=(K, B, 128)))}
    prior = np.zeros((2, WIDE))
    prior[0, WIDE // 2 - 1: WIDE // 2 + 2] = 300.0
    prior[1, WIDE // 2 - 1: WIDE // 2 + 2] = 0.5
    return mops_b, dims, ps0, rnd, prior, K


@functools.lru_cache(maxsize=None)
def _chain_jax():
    import jax.numpy as jnp

    mops_b, dims, ps0, rnd, prior, K = _chain_setup()
    j_ps, j_s = jmc.run_chunk_megachain(
        mops_b, jmc.make_chain_tables(mops_b), dims,
        jmega.pad_ps(jnp.asarray(ps0, jnp.float32), dims), K,
        jmc.prior_static_from(prior, dims),
        randomness={k: jnp.asarray(v) for k, v in rnd.items()},
        batch_tile=2)
    return dict(ps_final=np.asarray(j_ps), ps=np.asarray(j_s.ps),
                ln_post=np.asarray(j_s.ln_post),
                sig=np.asarray(j_s.signal_cr.re)
                + 1j * np.asarray(j_s.signal_cr.im),
                amp=np.asarray(j_s.fg_amps.re)
                + 1j * np.asarray(j_s.fg_amps.im),
                chisq=np.asarray(j_s.chisq))


@pytest.mark.parametrize("warm", [False, True], ids=["exact", "warm_ns"])
def test_wideband_chain_matches_jax(warm):
    """The port's chunk with the blocked inverse over the plain base at
    the wrappers' base (n = 256: blocks of 192 and 64, the route above
    192) against the JAX kernel; the warm
    start is held against the exact JAX chain at the warm-start
    tolerances, as tests/test_torch_megachain.py does."""
    mops_b, dims, ps0, rnd, prior, K = _chain_setup()
    assert dims.n == 256
    ref = _chain_jax()
    tdims = tmega.MegaDims(*dims)
    t_mops = tmega.from_jax_arrays(_jax_arrays(mops_b), tdims, CPU)
    base = _Spy(thi.plain_herm_inv)
    impl = PLAIN._replace(herm_inv=functools.partial(
        thi.blocked_herm_inv, base=base, mm=PLAIN.cgemm))
    kw = {"warm_ns": 3, "drift_max": 10.0} if warm else {}
    t_ps, t_s = tmc.run_chunk_megachain(
        t_mops, tmc.make_chain_tables(t_mops, CPU), tdims,
        tmega.pad_ps(ps0, tdims, CPU), K, tmc.prior_static_from(prior, tdims),
        randomness=rnd, impl=impl, **kw)
    assert base.sizes and set(base.sizes) == {thi.BASE_N, 256 - thi.BASE_N}
    ps_tol = dict(rtol=5e-4, atol=1e-7) if warm else dict(rtol=2e-3,
                                                          atol=1e-6)
    np.testing.assert_allclose(t_s.ps.numpy(), ref["ps"], **ps_tol)
    np.testing.assert_allclose(t_ps.numpy(), ref["ps_final"], **ps_tol)
    np.testing.assert_allclose(t_s.ln_post.numpy(), ref["ln_post"],
                               rtol=1e-3 if warm else 2e-3)
    sig = t_s.signal_cr.numpy()
    assert sig.shape == (K, 2, 10, WIDE)
    for part in (np.real, np.imag):
        assert _rel(part(sig), part(ref["sig"])) < (1e-3 if warm else 2e-4)
        assert _rel(part(t_s.fg_amps.numpy()), part(ref["amp"])) < 2e-4
    assert np.abs(t_s.chisq.numpy() - ref["chisq"]).max() < 5e-3


# --- the real engine with a dense Ninv at 140 channels ---------------------

NT_R, NM_R, B_R = 12, 3, 2


def _real_inputs(b):
    rng = np.random.default_rng(31 + b)
    d = _crandn(rng, NT_R, WIDE) * 2.0
    w = np.ones(WIDE)
    if b == 1:
        w[[4, 113]] = 0.0
    i = np.arange(WIDE)
    ninv = np.linalg.inv(1.5 * 0.5 ** np.abs(i[:, None] - i[None, :]))
    return d, w, _crandn(rng, WIDE, NM_R), ninv


def _real_prior():
    prior = np.zeros((2, WIDE))
    prior[0, WIDE // 2 - 5: WIDE // 2 + 6] = 400.0
    prior[1, WIDE // 2 - 5: WIDE // 2 + 6] = 0.2
    return prior


def _real_impl():
    """The plain versions, with the blocked factor-solve over the plain
    base at base 64 (blocks of 64, 64 and 12); records the base sizes."""
    base = _Spy(tss.plain_herm_chol_solve)
    return base, PLAIN._replace(herm_chol_solve=functools.partial(
        tss.blocked_herm_chol_solve, base=base, mm=PLAIN.cgemm, base_n=64))


def case_real_gcr_dense():
    """The GCR draw on the same omegas (rgibbs.py:173-242)."""
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    ins = [_real_inputs(b) for b in range(B_R)]
    j = jrg.stack_chain_operators([jrg.build_chain_operators(*x)
                                   for x in ins])
    t = trg.stack_chain_operators([trg.build_chain_operators(*x)
                                   for x in ins])
    rng = np.random.default_rng(41)
    ps = (np.abs(rng.standard_normal((B_R, WIDE))) * 20.0 + 1.0).astype(
        np.float32)
    oa = (_crandn(rng, B_R, NT_R, WIDE) * np.sqrt(WIDE)).astype(np.complex64)
    ob = _crandn(rng, B_R, NT_R, WIDE).astype(np.complex64)
    cj = lambda z: cplx.from_numpy(z, jnp.float32)
    want = jrg.gcr_solve(j, jnp.asarray(ps), cj(oa), cj(ob), solver="chol")
    base, impl = _real_impl()
    got = trg.gcr_solve(trg.to_device(t, CPU), torch.from_numpy(ps),
                        torch.from_numpy(oa), torch.from_numpy(ob),
                        solver="pallas", impl=impl)
    assert base.sizes == [64, 64, 12]
    for name, g, w in zip(("signal_cr", "fg_amps", "sk"), got, want):
        w = np.asarray(w.re) + 1j * np.asarray(w.im)
        assert _rel(g.numpy(), w) < TOL, (name, _rel(g.numpy(), w))


def case_real_step_dense():
    """One Gibbs step on the JAX step's randomness, 11 bounded bins."""
    import jax
    import jax.numpy as jnp

    ins = [_real_inputs(b) for b in range(B_R)]
    j = jrg.stack_chain_operators([jrg.build_chain_operators(*x)
                                   for x in ins])
    t = trg.stack_chain_operators([trg.build_chain_operators(*x)
                                   for x in ins])
    prior = _real_prior()
    prior_idx = np.nonzero(np.any(prior > 0, axis=0))[0]
    key = jax.random.fold_in(jax.random.key(31), 3)
    ps = (np.abs(np.random.default_rng(5).standard_normal((B_R, WIDE)))
          * 20.0 + 1.0).astype(np.float32)
    ps_j, s_j = jrg.gibbs_step(key, jnp.asarray(ps), j,
                               jnp.asarray(prior, jnp.float32),
                               prior_idx=jnp.asarray(prior_idx),
                               solver="chol")
    rand = _jax_step_randomness(key, prior)
    base, impl = _real_impl()
    ps_t, s_t = trg.gibbs_step(trg.to_device(t, CPU), torch.from_numpy(ps),
                               trb.prior_bins(trb.bounded_bins(prior), CPU),
                               rand, solver="pallas", impl=impl)
    assert base.sizes == [64, 64, 12]
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), rtol=2e-3,
                               atol=1e-6)
    sig_j = np.asarray(s_j.signal_cr.re) + 1j * np.asarray(s_j.signal_cr.im)
    assert _rel(s_t.signal_cr.numpy(), sig_j) < TOL
    chi_j = np.asarray(s_j.chisq)
    assert np.abs(s_t.chisq.numpy() - chi_j).max() < TOL * chi_j.mean() * 10
    np.testing.assert_allclose(s_t.ln_post.numpy(), np.asarray(s_j.ln_post),
                               rtol=2e-3)


def _jax_step_randomness(key, prior):
    """The draws of JAX ``gibbs_step`` under ``key`` in the port's layout
    (tests/test_torch_rgibbs.py::jax_step_randomness at these shapes)."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    npb = int(np.count_nonzero(np.any(prior > 0, axis=0)))
    out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
    f32 = jnp.float32
    c = lambda z: np.asarray(z.re) + 1j * np.asarray(z.im)
    for sid in range(B_R):
        k_oma, k_omb, k_ps = jax.random.split(jax.random.fold_in(key, sid),
                                              3)
        scale = np.sqrt(WIDE).astype(np.float32)
        oa = cplx.standard_normal(k_oma, (NT_R, WIDE), dtype=f32)
        out["oa"].append(np.asarray(oa.re * scale)
                         + 1j * np.asarray(oa.im * scale))
        out["ob"].append(c(cplx.standard_normal(k_omb, (NT_R, WIDE),
                                                dtype=f32)))
        k_gamma, k_u = jax.random.split(k_ps)
        u = jax.random.uniform(k_gamma, (NT_R - 1, WIDE), dtype=f32)
        out["gam"].append(np.asarray(-jnp.sum(
            jnp.log(jnp.maximum(u, jnp.finfo(f32).tiny)), axis=0)))
        out["u_pb"].append(np.asarray(jax.random.uniform(k_u, (npb,),
                                                         dtype=f32)))
    out["oa"] = np.asarray(out["oa"], np.complex64)
    out["ob"] = np.asarray(out["ob"], np.complex64)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


REAL = {f.__name__[5:]: f for f in (case_real_gcr_dense,
                                    case_real_step_dense)}


@pytest.mark.parametrize("case", list(REAL))
def test_wideband_real_engine_matches_jax(case):
    REAL[case]()


# --- the cgemm wrapper on the CPU --------------------------------------------

# (batch, M, K, N): the skinny products (M = 16, K = 16), the real engine's
# ragged shapes, the wide band and the blocked inverse's sub-blocks
CGEMM_SHAPES = {"skinny_m": (2, 16, 128, 40), "skinny_k": (2, 128, 16, 40),
                "ragged": (2, 120, 120, 203), "wide": (1, 256, 256, 24),
                "sub_block": (2, 52, 128, 52)}


@pytest.mark.parametrize("shape", list(CGEMM_SHAPES))
def test_cgemm_wrapper_cpu(shape):
    """Every op, shared and per-chain A, the epilogue, and ``out`` aliasing
    ``x``, against complex128 numpy (as tests/test_torch_spd_inv.py's
    case_cgemm_ops)."""
    B, M, K, N = CGEMM_SHAPES[shape]
    rng = np.random.default_rng(sum(CGEMM_SHAPES[shape]))
    a_n, a_t = _crandn(rng, B, M, K), _crandn(rng, B, K, M)
    bb, x = _crandn(rng, B, K, N), _crandn(rng, B, M, N)
    cases = [("N", a_n, a_n), ("T", a_t, np.swapaxes(a_t, 1, 2)),
             ("H", a_t, np.swapaxes(a_t, 1, 2).conj()),
             ("N", a_n[0], a_n[0][None]),
             ("H", a_t[0], np.swapaxes(a_t[0], 0, 1).conj()[None])]
    for op, a, aop in cases:
        got = tcg.cgemm(_c64(a), _c64(bb), op=op, x=_c64(x), alpha=-0.5,
                        beta=2.0).numpy()
        want = -0.5 * (aop @ bb) + 2.0 * x
        assert _rel(got, want) < 1e-5, op
        xt = _c64(x)
        tcg.cgemm(_c64(a), _c64(bb), op=op, x=xt, alpha=-1.0, out=xt)
        assert _rel(xt.numpy(), x - aop @ bb) < 1e-5, op
        got = tcg.cgemm(_c64(a), _c64(bb), op=op, alpha=0.25).numpy()
        assert _rel(got, 0.25 * (aop @ bb)) < 1e-5, op


@pytest.mark.cuda
def test_blocked_kernels_on_card():
    """The inverse and the factor-solve on the card against their plain
    versions: one launch each at n = 180 (the lower-tile kernels), and the
    blocked route at n = 256 (base launches of 192 and 64, cgemm
    products); chip_smoke.py's phase 3 holds the same at more widths."""
    from hydra_pspec_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(256)
    for n, herm, chol in ((180, {"herm_inv": 1}, {"herm_chol_solve": 1}),
                          (256, {"herm_inv": 2, "cgemm": 4},
                           {"herm_chol_solve": 2, "cgemm": 3})):
        ms, _ = tss.equilibrate(_c64(_hpd(rng, 4, n)).to(dev))
        _build.reset_launches()
        inv = thi.herm_inv(ms)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == herm
        eye = torch.eye(n, dtype=torch.complex64, device=dev)
        assert float(torch.abs(ms @ inv - eye).max()) < 1e-4
        rhs = _c64(_crandn(rng, 4, n, 203)).to(dev)
        _build.reset_launches()
        x = tss.herm_chol_solve(ms, rhs)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == chol
        assert _rel(x.cpu().numpy(),
                    tss.plain_herm_chol_solve(ms, rhs).cpu().numpy()) < TOL
    _build.reset_launches()
