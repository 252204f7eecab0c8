"""The port's posterior oracle gate (``hydra_pspec_torch/validation/``):
its copy of ``utils/mcstats.py`` against the JAX package's on the cases of
``tests/test_mcstats.py``, its oracle sampler against
``scripts/make_oracle_posterior.py`` bit for bit, the committed synthetic
oracle artifact, the gate function of ``validate.py`` and the synthetic
data generator that ``chip_smoke.py`` imports.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.signal import lfilter

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from hydra_pspec_tpu.utils import mcstats as jmc  # noqa: E402
from hydra_pspec_torch.utils import mcstats as tmc  # noqa: E402
from hydra_pspec_torch.validation import oracle, synth, validate  # noqa: E402

ART = json.loads(oracle.OUT.read_text())


def _lognormal_case(rng, bias_log=0.0, nd=1500):
    """Oracle statistics and draws of log-normal posteriors with per-bin
    scales (``tests/test_mcstats.py::_synthetic``)."""
    nbins, nchains = 120, 4
    mu = rng.uniform(8.0, 12.0, size=nbins)
    sd = rng.uniform(0.06, 0.12, size=nbins)
    orc = {"mean_log_ps": mu.tolist(), "sd_log_ps": sd.tolist(),
           "ess_log_ps": [40000.0] * nbins,
           "q5_ps": np.exp(mu - 1.645 * sd).tolist(),
           "q95_ps": np.exp(mu + 1.645 * sd).tolist()}
    draws = np.exp(mu + bias_log
                   + sd * rng.standard_normal((nchains, nd, nbins)))
    return orc, draws


def _ar1(rng):
    rho = 0.9
    e = rng.standard_normal((4, 40000)) * np.sqrt(1 - rho**2)
    return lfilter([1.0], [1.0, -rho], e, axis=1)


def _antithetic(rng):
    half = rng.standard_normal((4, 1000))
    x = np.empty((4, 2000))
    x[:, ::2], x[:, 1::2] = half, -half
    return x


# the six cases of tests/test_mcstats.py: (ESS input) or (compare input)
MCSTATS_CASES = {
    "ess_iid": lambda rng: ("ess", rng.standard_normal((4, 2000))),
    "ess_ar1": lambda rng: ("ess", _ar1(rng)),
    "ess_antithetic": lambda rng: ("ess", _antithetic(rng)),
    "correct_sampler": lambda rng: ("cmp", _lognormal_case(rng)),
    "fifteen_percent_bias": lambda rng: (
        "cmp", _lognormal_case(rng, np.log(1.15))),
    "negligible_offset": lambda rng: (
        "cmp", _lognormal_case(rng, 0.01, nd=4000)),
}


@pytest.mark.parametrize("case", list(MCSTATS_CASES))
def test_mcstats_matches_jax(case):
    """The port's ESS, oracle comparison and acceptance equal the JAX
    package's exactly (the same numpy code; tolerance 0)."""
    kind, x = MCSTATS_CASES[case](np.random.default_rng(len(case)))
    if kind == "ess":
        assert tmc.ess_geyer(x) == jmc.ess_geyer(x)
        return
    orc, draws = x
    got, want = tmc.compare_to_oracle(draws, orc), jmc.compare_to_oracle(
        draws, orc)
    assert got == want
    assert tmc.oracle_acceptance(got) == jmc.oracle_acceptance(want)
    assert tmc.oracle_acceptance(got) == (case != "fifteen_percent_bias")


def test_oracle_chain_matches_script():
    """``validation/oracle.py``'s chain equals
    ``scripts/make_oracle_posterior.run_oracle_chain`` bit for bit on a
    12 x 16 problem with flags, a diagonal Ninv and 4 bounded bins, 20
    iterations: both are numpy on the same ``default_rng``."""
    import make_oracle_posterior as mop

    rng = np.random.default_rng(0)
    nt, n, m = 12, 16, 3
    d = rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))
    w = synth.parse_flags("3,7-8", n)
    ninv = rng.uniform(0.5, 2.0, n)
    fg = rng.standard_normal((n, m))
    f = oracle.fourier_operator(n)
    eor = f.conj().T @ (np.linspace(1.0, 3.0, n)[:, None] / n**2 * f)
    prior = np.zeros((2, n))
    prior[0, 6:10], prior[1, 6:10] = 5.0, 0.1
    want = mop.run_oracle_chain(5, 20, d, w, ninv, fg, eor, prior)
    got = oracle.run_oracle_chain(5, 20, d, w, ninv, fg, eor, prior)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert synth.FLAG_CHANNELS == mop.FLAG_CHANNELS
    np.testing.assert_array_equal(synth.parse_flags(synth.FLAG_CHANNELS, 120),
                                  mop.parse_flags(mop.FLAG_CHANNELS, 120))


def test_committed_oracle_artifact():
    """``oracle_posterior_synth.json``: the keys of
    ``tests/oracle_posterior.json`` in both cases, converged (split-R-hat
    max <= 1.1, chi^2 within 2 % of 1), 4 x 25000 with burn 2500, and a
    provenance that rebuilds its synthetic problem (the data's digest)."""
    ref = json.loads((REPO / "tests" / "oracle_posterior.json").read_text())
    prov = ART["provenance"]
    assert set(ref["provenance"]) <= set(prov)
    assert prov["generator"] == "hydra_pspec_torch/validation/oracle.py"
    assert (prov["nchains"], prov["niter"], prov["nburn"]) == (4, 25000,
                                                                2500)
    for case in ("unflagged", "flagged"):
        assert set(ART[case]) == set(ref[case]), case
        assert ART[case]["split_rhat_max"] <= 1.1, case
        assert abs(ART[case]["chisq_postburn_mean"] - 1.0) < 0.02, case
        assert len(ART[case]["mean_log_ps"]) == synth.NF
    assert ART["flagged"]["flag_channels"] == synth.FLAG_CHANNELS
    prob = synth.synthetic_problem(prov["synth_seed"])
    assert synth.data_digest(prob.d) == prov["data_sha256"]
    # the posterior holds the truth where the data decide it
    z = ((np.log(prob.ps_truth) - np.asarray(ART["unflagged"]["mean_log_ps"]))
         / np.asarray(ART["unflagged"]["sd_log_ps"]))
    assert np.median(np.abs(z)) < 1.5, np.median(np.abs(z))


def test_gate_function():
    """``validate.gates``: 16 chains of draws from the oracle's own normal
    in log space pass every gate; the same draws x 1.15 fail the oracle
    gate; a flag pattern or synthetic seed the artifact was not built
    for is an error."""
    orc = ART["unflagged"]
    rng = np.random.default_rng(11)
    mu, sd = np.asarray(orc["mean_log_ps"]), np.asarray(orc["sd_log_ps"])
    post = np.exp(mu + sd * rng.standard_normal((16, 2000, mu.size)))
    good = validate.gates(post, 1.003, orc)
    assert good["pass"] and all(good["gates"].values()), good
    bad = validate.gates(post * 1.15, 1.003, orc)
    assert not bad["pass"] and bad["gates"]["oracle"] is False, bad
    assert bad["gates"]["rhat"] and bad["oracle_compare"]["max_z"] > 10
    assert not validate.gates(post, 1.03, orc)["pass"]
    assert validate.gates(post, 1.0, None)["gates"]["oracle_waived"]
    assert validate.oracle_case(ART, None, synth.SEED) == "unflagged"
    assert validate.oracle_case(ART, synth.FLAG_CHANNELS,
                                synth.SEED) == "flagged"
    with pytest.raises(validate.OracleMismatch):
        validate.oracle_case(ART, "1,2", synth.SEED)
    with pytest.raises(validate.OracleMismatch):
        validate.oracle_case(ART, None, synth.SEED + 1)


# the calls of chip_smoke.py's phases, and the digests (synth.data_digest)
# of the first and last of 3 baselines' visibilities as its generator drew
# them before it moved to validation/synth.py
DRAWN = {
    "plain": (dict(), [
        "c26311a4e6b626ac844b6565aa10299552ba515147c6d3679768b29ea52c5dff",
        "0339899172694873c641654a9c016a327058361f1586f0cf787addd438e000f1"]),
    "dense": (dict(dense=True, seed=synth.SEED + 3), [
        "618351bdd0449cd8ff47d05cb514879815242c73e5e20e571c19a0395210fd7f",
        "1637c41575417e392be5e5006ffc2e08482c7c1547aa04c1a41db51b05c52ce0"]),
    "long": (dict(ntimes=50, seed=synth.SEED + 5), [
        "65379347faa1605572314097d353a76e0b4b707b77a2f5a2a4865036db534d31",
        "d22e2704cf1d08605faeb18fb30a03498e074d92d1fb66bd2217bd85c99d7b21"]),
    "wide": (dict(nf=180, seed=synth.SEED + 20), [
        "77f044001e733f2d728157f3db864ccd1d5625a015e864721375d685470b106e",
        "8e5f4569276a0dd835199f2bce15a4ab87045bc73e1991721070390007526181"]),
}


@pytest.mark.parametrize("case", list(DRAWN))
def test_generator_draws_as_before(case):
    """``synth.make_jobs`` draws the data ``chip_smoke.py``'s phases drew
    before it moved here, bit for bit (the digests of its first and last
    of 3 baselines), and ``synthetic_problem`` is baseline 0."""
    kw, want = DRAWN[case]
    jobs = synth.make_jobs(3, **kw)
    got = [synth.data_digest(jobs[0].d), synth.data_digest(jobs[-1].d)]
    assert got == want, got
    if case == "plain":
        np.testing.assert_array_equal(synth.synthetic_problem().d,
                                      jobs[0].d)
