"""The port's chain (hydra_pspec_torch) against the JAX megachain kernel.

Both sides get the same operators (built by the JAX package) and the same
numpy-made external randomness; the JAX kernel runs in Pallas interpret
mode on the CPU, the port through the plain torch versions of its kernels.
Tolerances are those of tests/test_megachain.py:114-128 (and :159-165 for
the Newton-Schulz warm start)."""
import functools

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.ops import invgamma as tig
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.kernels import rng_bandpower

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def jax_arrays(mops) -> dict:
    """A JAX MegaOperators as the numpy dict the port takes."""
    out = {f: np.asarray(getattr(mops, f)) for f in mops._fields
           if f != "igt"}
    out.update(igt_log_y=np.asarray(mops.igt.log_y),
               igt_q=np.asarray(mops.igt.q),
               igt_alpha=np.asarray(mops.igt.alpha))
    return out


def make_case(seed, ntimes, nfreqs, nmodes, B, flagged):
    rng = np.random.default_rng(seed)
    d = _crandn(rng, ntimes, nfreqs) * 2.0
    w = np.ones(nfreqs)
    if flagged:
        w[3] = 0.0
        w[9:11] = 0.0
    fg = _crandn(rng, nfreqs, nmodes)
    ninv = np.abs(rng.standard_normal(nfreqs)) + 1.0
    mops, dims = jmega.build_mega_operators(d, w, fg, ninv)
    mops_b = jmega.broadcast_mega_operators(mops, B)
    ps0 = np.abs(rng.standard_normal((B, nfreqs))) * 10.0 + 0.5
    return rng, mops_b, dims, ps0, w


def draw_randomness(rng, K, B, dims):
    n, t = dims.n, dims.t
    sa = np.float32(np.sqrt(0.5) * np.sqrt(dims.nfreqs))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    return {
        "oa_re": f32(rng.standard_normal((K, B, n, t))) * sa,
        "oa_im": f32(rng.standard_normal((K, B, n, t))) * sa,
        "ob_re": f32(rng.standard_normal((K, B, n, t))) * hf,
        "ob_im": f32(rng.standard_normal((K, B, n, t))) * hf,
        "gam": f32(rng.gamma(dims.ntimes - 1, size=(K, B, n))),
        "u_pb": f32(rng.uniform(size=(K, B, 128))),
    }


def _prior(nf, nbins):
    prior = np.zeros((2, nf))
    sl = slice(nf // 2 - nbins // 2, nf // 2 - nbins // 2 + nbins)
    prior[0, sl] = 300.0
    prior[1, sl] = 0.5
    return prior


# setup: (ntimes, nfreqs, nmodes, K, B, flagged, prior bins)
SETUPS = {
    "tiny": (10, 16, 2, 3, 2, False, 3),
    "tiny_flagged": (10, 16, 2, 3, 2, True, 3),
    "reference_shape": (203, 120, 12, 2, 2, False, 7),
}
# case: (setup, port kwargs). Each JAX run (one interpret-mode compile,
# ~13 s) serves every case of its setup: the warm start is held against
# the exact JAX chain at the warm-start tolerances, the lean run against
# the JAX full run's chi averaged over the unflagged channels.
CASES = {
    "full_3prior": ("tiny", {}),
    "warm_ns": ("tiny", {"warm_ns": 3, "drift_max": 10.0}),
    "flagged": ("tiny_flagged", {}),
    "lean_chi_mask": ("tiny_flagged", {"store_cr": False}),
    "reference_shape": ("reference_shape", {}),
}


@functools.lru_cache(maxsize=None)
def setup(name):
    ntimes, nfreqs, nmodes, K, B, flagged, nbins = SETUPS[name]
    rng, mops_b, dims, ps0, w = make_case(5, ntimes, nfreqs, nmodes, B,
                                          flagged)
    rnd = draw_randomness(rng, K, B, dims)
    return mops_b, dims, ps0, w, rnd, _prior(dims.nfreqs, nbins), K


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX chunk (full outputs) as numpy arrays."""
    import jax.numpy as jnp

    mops_b, dims, ps0, w, rnd, prior, K = setup(name)
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


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_jax(case):
    name, kw = CASES[case]
    mops_b, dims, ps0, w, rnd, prior, K = setup(name)
    B = ps0.shape[0]
    nf, nt = dims.nfreqs, dims.ntimes
    lean = not kw.get("store_cr", True)
    if lean:
        kw = dict(kw, chi_mask=w.astype(np.float32))
    ref = jax_run(name)

    tdims = tmega.MegaDims(*dims)
    t_mops = tmega.from_jax_arrays(jax_arrays(mops_b), tdims, CPU)
    t_static = tmc.prior_static_from(prior, tdims)
    assert t_static == jmc.prior_static_from(prior, dims)
    t_ps, t_s = tmc.run_chunk_megachain(
        t_mops, tmc.make_chain_tables(t_mops, CPU), tdims,
        tmega.pad_ps(ps0, tdims, CPU), K, t_static, randomness=rnd, **kw)

    warm = "warm_ns" in kw
    ps_tol = dict(rtol=5e-4, atol=1e-7) if warm else dict(rtol=2e-3,
                                                          atol=1e-6)
    np.testing.assert_allclose(t_s.ps.numpy(), ref["ps"], **ps_tol)
    np.testing.assert_allclose(t_ps.numpy(), ref["ps_final"], **ps_tol)
    np.testing.assert_allclose(t_s.ln_post.numpy(), ref["ln_post"],
                               rtol=1e-3 if warm else 2e-3)
    if lean:
        assert t_s.signal_cr is None and t_s.chisq.shape == (K, B)
        want = ref["chisq"][..., w.astype(bool)].mean(axis=(2, 3))
        assert np.abs(t_s.chisq.numpy() - want).max() < 5e-3
        return
    sig = t_s.signal_cr.numpy()
    assert sig.shape == (K, B, nt, nf)
    assert t_s.fg_amps.shape == (K, B, nt, dims.nmodes)
    for part in (np.real, np.imag):
        assert _rel(part(sig), part(ref["sig"])) < (1e-3 if warm else 2e-4)
        assert _rel(part(t_s.fg_amps.numpy()), part(ref["amp"])) < 2e-4
    assert np.abs(t_s.chisq.numpy() - ref["chisq"]).max() < 5e-3


def test_bandpower_conditional_matches_jax_body():
    """The port's plain conditional against _sample_bandpowers_body."""
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops.invgamma import make_invgamma_table
    from hydra_pspec_tpu.ops.pallas.megachain import _sample_bandpowers_body
    from hydra_pspec_torch.ops.invgamma import make_invgamma_table as t_mit

    rng = np.random.default_rng(11)
    B, n, ntimes = 4, 128, 203
    beta = (rng.gamma(ntimes, size=(B, n)) * 50.0).astype(np.float32)
    beta[:, 120:] = 0.0                       # pad bins
    gam = rng.gamma(ntimes - 1, size=(B, n)).astype(np.float32)
    u = rng.uniform(size=(B, 8)).astype(np.float32)
    static = ((57, 0.5, 300.0), (60, 30.0, 80.0), (63, 1e-3, 1e4))
    jt = make_invgamma_table(ntimes)
    ref = _sample_bandpowers_body(
        jnp.asarray(beta), jnp.asarray(gam), jnp.asarray(u), static,
        jnp.asarray(jt.log_y)[None, None], jnp.asarray(jt.q)[None, None])
    tt = t_mit(ntimes)
    got = rng_bandpower.bandpower(
        torch.from_numpy(beta), rng_bandpower.prior_bins(static, CPU),
        torch.from_numpy(tt.log_y), torch.from_numpy(tt.q),
        gam=torch.from_numpy(gam), u_pb=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert np.all(got.numpy()[:, 120:] == 0.0)


def test_philox_twin_known_answers_and_streams():
    """The plain Philox4x32-10 twin against published known-answer
    vectors; the streams are zero on pad time lanes and keyed on
    (seed, sid, iteration) only."""
    m = philox.MASK32
    kat = [((0, 0, 0, 0, 0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((m, m, m, m, m, m),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]
    for args, want in kat:
        assert tuple(int(x) for x in philox.philox4x32(*args)) == want

    sids = torch.tensor([3, 7, 8], dtype=torch.int32)
    oa, ob = philox.omega_fields(5, sids, 12, 8, 16, 10, 16)
    assert torch.all(oa[:, :, 10:] == 0) and torch.all(ob[:, :, 10:] == 0)
    oa1, ob1 = philox.omega_fields(5, sids[1:2], 12, 8, 16, 10, 16)
    assert torch.equal(oa1[0], oa[1]) and torch.equal(ob1[0], ob[1])
    g1 = philox.gamma_draws(5, sids, 12, 8, 9)
    assert torch.equal(philox.gamma_draws(5, sids[2:], 12, 8, 9)[0], g1[2])
    assert not torch.equal(philox.gamma_draws(5, sids, 13, 8, 9), g1)
    u = philox.prior_uniforms(5, sids, 12)
    assert u.shape == (3, 8) and float(u.min()) > 0 and float(u.max()) < 1


def _sem_dinv_floor():
    """dinv = rsqrt(max(1 + dd^2 diag(P~), tiny)) (megastep.py:162-163):
    a non-positive pivot is floored at tiny, not turned into NaN."""
    from hydra_pspec_torch.ops.kernels.draw_fused import plain_draw_system

    B, n, t = 1, 4, 8
    pt = torch.zeros((B, n, n), dtype=torch.complex64)
    pt[0, 1, 1] = -2.0                        # 1 + dd^2 * (-2) < 0
    ps = torch.full((B, n), 4.0)
    z = torch.zeros((B, n, t), dtype=torch.complex64)
    _, _, dd, dinv = plain_draw_system(pt, ps, z, z, t, 4)
    tiny = torch.finfo(torch.float32).tiny
    assert float(dinv[0, 1]) == float(torch.rsqrt(torch.tensor(tiny)))
    assert torch.all(dinv[0, [0, 2, 3]] == 1.0) and torch.all(dd == 1.0)


def _sem_prior_lanes():
    """Only lanes 0..np-1 of the 128 prior uniforms are read
    (megachain.py:337, 344)."""
    static = ((5, 0.5, 300.0), (6, 1.0, 50.0))
    beta = torch.full((2, 16), 40.0)
    gam = torch.full((2, 16), 9.0)
    u = torch.rand((2, 128), generator=torch.Generator().manual_seed(0))
    tt = tig.make_invgamma_table(10)
    args = (rng_bandpower.prior_bins(static, CPU), torch.from_numpy(tt.log_y),
            torch.from_numpy(tt.q))
    a = rng_bandpower.bandpower(beta, *args, gam=gam, u_pb=u)
    u2 = u.clone()
    u2[:, 2:] = float("nan")
    assert torch.equal(rng_bandpower.bandpower(beta, *args, gam=gam, u_pb=u2),
                       a)


def _sem_ns_gate():
    """The warm-start gate rebuilds at k == 0 and whenever the drift is not
    provably small: a NaN bandpower state selects the exact inverse
    (megachain.py:366-397)."""
    from hydra_pspec_torch.ops.kernels.impl import PLAIN
    from hydra_pspec_torch.ops.kernels.megachain import _WarmStart

    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 8, 8), generator=g, dtype=torch.complex64)
    s = torch.eye(8) + x @ x.transpose(1, 2).conj() / 8
    exact = PLAIN.herm_inv(s)
    ws = _WarmStart(2, 0.6, PLAIN)
    ps = torch.ones((3, 8))
    assert torch.equal(ws(s, ps, 0), exact)
    stale = torch.eye(8, dtype=torch.complex64).expand(3, 8, 8).clone()
    ws.inv = stale
    ps2 = ps.clone()
    ps2[1, 3] = float("nan")                  # chain 1: NaN drift
    ps2[2] *= 3.0                             # chain 2: drift 1.0 > 0.6
    got = ws(s, ps2, 1)
    assert torch.equal(got[1], exact[1]) and torch.equal(got[2], exact[2])
    assert not torch.equal(got[0], exact[0])  # chain 0 refreshed by NS
    assert torch.equal(ws(s, ps2, 0), exact)  # a new chunk starts exact


def _sem_gamma_shape():
    """The table is built at alpha = Ntimes (rgibbs.py:134) while the Gamma
    draw has shape Ntimes - 1 (models/megachain.py:284)."""
    from hydra_pspec_torch.models import rgibbs as trg
    from hydra_pspec_torch.ops.kernels.impl import PLAIN

    rng = np.random.default_rng(2)
    d = rng.standard_normal((9, 16)) + 1j * rng.standard_normal((9, 16))
    ops = trg.build_chain_operators(d, np.ones(16), np.ones((16, 1)),
                                    np.ones(16))
    assert float(ops.igt.alpha) == 9.0
    mops, dims = tmega.from_chain_operators(ops, CPU)
    seen = []

    def spy(*a, **kw):
        seen.append(kw["alpha"])
        return PLAIN.bandpower(*a, **kw)

    tmc.run_chunk_megachain(
        mops, tmc.make_chain_tables(mops, CPU), dims,
        tmega.pad_ps(np.ones((1, 16)), dims, CPU), 2, seed=3, sids=[0],
        impl=PLAIN._replace(bandpower=spy))
    assert seen == [8, 8]


SEMANTICS = {f.__name__[5:]: f for f in (_sem_dinv_floor, _sem_prior_lanes,
                                         _sem_ns_gate, _sem_gamma_shape)}


@pytest.mark.parametrize("case", list(SEMANTICS))
def test_semantics(case):
    SEMANTICS[case]()
