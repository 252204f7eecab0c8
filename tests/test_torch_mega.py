"""The port's single-step mega engine against the JAX package's: the
``gcr_megastep`` entry on the same omegas (the JAX kernel in Pallas
interpret mode, the port on the plain versions of its kernels), one
``gibbs_step_mega`` on external randomness that reproduces the JAX step's
key schedule (``mega.py:212-243``) with 11 bounded prior bins, and the
Philox Gamma draw of a long night (alpha = 1099) on its first two
moments. Tolerances are those of tests/test_mega.py:51-114. The problem is
that of tests/test_torch_fallback_runner.py (3 baselines x 12 times x 16
channels, baseline 1 with two flagged channels), so a run of both files in
one process compiles the JAX kernel once."""
import functools
import math

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.kernels import impl as timpl
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.ops.kernels.megastep import gcr_megastep

CPU = torch.device("cpu")
NT, NF, NM, B = 12, 16, 2, 3


@pytest.fixture(autouse=True)
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _problem():
    """Three baselines (the second with two flagged channels, so ``bmask``
    differs from ``beta``), both packages' mega operators."""
    rng = np.random.default_rng(19)
    ins = []
    for b in range(B):
        d = _crandn(rng, NT, NF) * 2.0
        fg = _crandn(rng, NF, NM)
        ninv = np.abs(rng.standard_normal(NF)) + 1.0
        rng.standard_normal(NF)                  # the runner test's ps0
        ins.append((d, flagged_w(b), fg, ninv))
    jm, jd = jmega.from_chain_operators(jrg.stack_chain_operators(
        [jrg.build_chain_operators(*x) for x in ins]))
    tm, td = tmega.from_chain_operators(trg.stack_chain_operators(
        [trg.build_chain_operators(*x) for x in ins]), CPU, layout="jax")
    ps = (np.abs(np.random.default_rng(217).standard_normal((B, NF))) * 10.0
          + 0.05).astype(np.float32)
    return jm, jd, tm, td, ps


def flagged_w(b):
    """Channel weights of baseline ``b``: two channels of baseline 1 are
    flagged."""
    w = np.ones(NF)
    if b == 1:
        w[[3, 11]] = 0.0
    return w


def _prior():
    """11 bounded bins around delay 0 (more than megachain's 8)."""
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 5: NF // 2 + 6] = 400.0
    prior[1, NF // 2 - 5: NF // 2 + 6] = 0.2
    return prior


@functools.lru_cache(maxsize=None)
def jax_step():
    """One JAX ``gibbs_step_mega`` (11 bounded bins) with its
    ``gcr_megastep`` call recorded: ``(key, ps_new, sample, omegas,
    megastep outputs)``. One interpret-mode run serves both pins."""
    import jax
    import jax.numpy as jnp

    jm, jd, tm, td, ps = _problem()
    prior = _prior()
    prior_idx = np.nonzero(np.any(prior > 0, axis=0))[0]
    prior_pad = np.zeros((2, td.n), np.float32)
    prior_pad[:, :NF] = prior
    key = jax.random.fold_in(jax.random.key(9), 2)
    seen = {}
    inner = jmega.gcr_megastep

    def recording(*args, **kw):
        # waits for the kernel before the step's next eager op: Pallas
        # interpret mode's host callbacks can deadlock against eager ops
        # dispatched while they run
        outs = jax.block_until_ready(inner(*args, **kw))
        seen["omegas"] = [np.array(kw[k]) for k in
                          ("oa_re", "oa_im", "ob_re", "ob_im")]
        seen["outs"] = [np.array(o) for o in outs]
        return outs

    jmega.gcr_megastep = recording
    try:
        ps_j, s_j = jmega.gibbs_step_mega(
            key, jnp.asarray(tmega.pad_ps(ps, td, CPU).numpy()), jm, jd,
            jnp.asarray(prior_pad), prior_idx=jnp.asarray(prior_idx),
            batch_tile=B)
    finally:
        jmega.gcr_megastep = inner
    return key, np.asarray(ps_j), s_j, seen["omegas"], seen["outs"]


def case_megastep_matches_jax():
    _, _, tm, td, ps = _problem()
    _, _, _, (oar, oai, obr, obi), outs = jax_step()
    j_sig_re, j_sig_im, j_amp_re, j_amp_im, j_chi, j_beta, j_noise, j_bm = (
        outs)
    oa = torch.complex(torch.from_numpy(oar), torch.from_numpy(oai))
    ob = torch.complex(torch.from_numpy(obr), torch.from_numpy(obi))
    ps_pad = tmega.pad_ps(ps, td, CPU)
    d = gcr_megastep(tm, ps_pad, oa, ob, nfreqs=td.nfreqs, ntimes=td.ntimes,
                     all_unflagged=td.all_unflagged)
    for got, re, im in ((d.sig, j_sig_re, j_sig_im),
                        (d.amp, j_amp_re, j_amp_im)):
        want = re + 1j * im
        assert np.abs(got.numpy() - want).max() / np.abs(want).mean() < 3e-3
    assert np.abs(d.chi.numpy() - j_chi).max() < 5e-2
    np.testing.assert_allclose(d.beta.numpy(), j_beta, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(d.bmask.numpy(), j_bm, rtol=5e-3, atol=1e-4)
    assert not np.allclose(j_bm[1], j_beta[1])
    assert np.abs(d.noise_nu.numpy().sum(1) - j_noise.sum(1)).max() \
        / np.abs(j_noise.sum(1)).max() < 5e-3
    assert np.abs(d.beta.numpy()[:, NF:]).max() == 0
    assert np.abs(d.chi.numpy()[:, :, NT:]).max() == 0
    lean = gcr_megastep(tm, ps_pad, oa, ob, nfreqs=td.nfreqs,
                        ntimes=td.ntimes, all_unflagged=td.all_unflagged,
                        lean=True)
    assert lean.sig is None and lean.chi is None
    torch.testing.assert_close(lean.chit, d.chi.sum(dim=2), rtol=1e-5,
                               atol=1e-4)


def jax_mega_randomness(key, sids, dims, npb):
    """The draws of JAX ``gibbs_step_mega`` under ``key`` for chains
    ``sids`` (``mega.py:212-243``, ``invgamma.py:223-264``), in the port's
    layout: complex ``oa``/``ob`` (B, n, t), ``gam`` (B, n), ``u_pb``."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    half = np.sqrt(0.5).astype(np.float32)
    sa = half * np.sqrt(np.float32(dims.nfreqs))
    out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
    for sid in sids:
        ka, kb, kp = jax.random.split(jax.random.fold_in(key, sid), 3)
        oa = np.asarray(jax.random.normal(ka, (2, dims.n, dims.t), f32) * sa)
        ob = np.asarray(jax.random.normal(kb, (2, dims.n, dims.t), f32)
                        * half)
        out["oa"].append(oa[0] + 1j * oa[1])
        out["ob"].append(ob[0] + 1j * ob[1])
        k_gamma, k_u = jax.random.split(kp)
        u = jax.random.uniform(k_gamma, (dims.ntimes - 1, dims.n), dtype=f32)
        out["gam"].append(np.asarray(-jnp.sum(
            jnp.log(jnp.maximum(u, jnp.finfo(f32).tiny)), axis=0)))
        out["u_pb"].append(np.asarray(jax.random.uniform(k_u, (npb,),
                                                         dtype=f32)))
    cast = {"oa": np.complex64, "ob": np.complex64}
    return {k: torch.from_numpy(np.asarray(v, cast.get(k, np.float32)))
            for k, v in out.items()}


def case_step_matches_jax():
    _, _, tm, td, ps = _problem()
    key, ps_j, s_j, (oar, oai, _, _), _ = jax_step()
    prior = _prior()
    rand = jax_mega_randomness(key, range(B), td, 11)
    # the schedule reproduced: the omegas the JAX step handed its kernel
    assert np.array_equal(rand["oa"].real.numpy(), oar)
    assert np.array_equal(rand["oa"].imag.numpy(), oai)
    tables = tmc.make_chain_tables(tm, CPU)
    bins = trb.prior_bins(trb.bounded_bins(prior), CPU)
    ps_pad = tmega.pad_ps(ps, td, CPU)
    ps_t, d = tmega.gibbs_step_mega(tm, td, ps_pad, bins, tables.tlog,
                                    tables.q, rand)
    np.testing.assert_allclose(ps_t.numpy(), ps_j, rtol=2e-3, atol=1e-6)
    assert np.abs(ps_t.numpy()[:, NF:]).max() == 0
    lnp = tmega.ln_post(d.noise_nu, d.bmask, ps_t).numpy()
    np.testing.assert_allclose(lnp, np.asarray(s_j.ln_post), rtol=2e-3)
    # the chain driver with the same draws as its one-iteration chunk
    rnd1 = {k: v[None] for k, v in rand.items()}
    ps_c, s_c = tmega.run_chain_mega(tm, td, ps_pad, bins, 1, tables.tlog,
                                     tables.q, randomness=rnd1)
    assert torch.equal(ps_c, ps_t) and torch.equal(s_c.ln_post[0],
                                                   torch.from_numpy(lnp))
    chi_j = np.asarray(s_j.chisq)
    assert np.abs(s_c.chisq[0].numpy() - chi_j).max() < 5e-2


def case_gamma_long_night():
    """Gamma(1099) from the GAMMA words (275 Philox calls a bin, taken in
    chunks): mean alpha and variance alpha within 5 sigma."""
    a = 1099
    sids = torch.arange(8, dtype=torch.int32)
    gam = torch.cat([philox.gamma_draws(11, sids, g, 64, a).flatten()
                     for g in range(4)]).double()
    n = gam.numel()
    m, var = float(gam.mean()), float(gam.var())
    assert abs(m - a) < 5 * math.sqrt(a / n), m
    assert abs(var - a) < 5 * math.sqrt((2 * a * a + 6 * a) / n), var
    # the chunked sum equals one pass over all counters
    one = philox.gamma_draws(11, sids[:4], 0, 8, a)
    old, philox.GAMMA_CHUNK = philox.GAMMA_CHUNK, 1 << 20
    try:
        whole = philox.gamma_draws(11, sids[:4], 0, 8, a)
    finally:
        philox.GAMMA_CHUNK = old
    torch.testing.assert_close(one, whole, rtol=1e-5, atol=0.0)


def case_prior_uniforms_extend():
    """More than 8 bounded bins extend the UNIFORM counters; the first 8
    lanes are the megachain engine's words."""
    sids = torch.arange(3, dtype=torch.int32)
    u8 = philox.prior_uniforms(4, sids, 6)
    u21 = philox.prior_uniforms(4, sids, 6, 21)
    assert u8.shape == (3, 8) and u21.shape == (3, 24)
    assert torch.equal(u21[:, :8], u8)
    assert len(set(u21.flatten().tolist())) == u21.numel()


CASES = {f.__name__[5:]: f for f in (
    case_megastep_matches_jax, case_step_matches_jax, case_gamma_long_night,
    case_prior_uniforms_extend)}


@pytest.mark.parametrize("case", list(CASES))
def test_mega_engine(case):
    CASES[case]()


def test_plain_impl_is_the_cpu_route():
    """On CPU tensors the kernel table and the plain table agree exactly:
    the wrappers take the plain versions."""
    _, _, tm, td, ps = _problem()
    ps_pad = tmega.pad_ps(ps, td, CPU)
    rng = np.random.default_rng(8)
    oa = torch.from_numpy((_crandn(rng, B, td.n, td.t) * 4).astype(
        np.complex64))
    ob = torch.from_numpy(_crandn(rng, B, td.n, td.t).astype(np.complex64))
    kw = dict(nfreqs=td.nfreqs, ntimes=td.ntimes,
              all_unflagged=td.all_unflagged)
    a = gcr_megastep(tm, ps_pad, oa, ob, **kw)
    b = gcr_megastep(tm, ps_pad, oa, ob, impl=timpl.PLAIN, **kw)
    assert torch.equal(a.sig, b.sig) and torch.equal(a.beta, b.beta)
