"""The plain reference against the port's plain CPU path at a tiny size,
and the control (the reference in TF32) against both."""
import numpy as np
import pytest

import bench_util  # noqa: F401  (puts portbench on the path)
import check
import control
import harness
from reference import philox, sampler

NITER = 20


def _program(workload, seed):
    from hydra_pspec_torch import runner
    _, _, config, traffic, _ = bench_util.tiny_cell(workload)
    inp = harness.Inputs(config, traffic, 1, seed, runner.BaselineJob)
    res, _ = runner.run_baselines(
        inp.jobs, inp.prior, NITER, device="cpu", seed=seed,
        nchains=inp.nchains, checkpoint=False, **config["sampler"])
    pairs = check.pick(seed, inp.rows, NITER, config["sampler"]
                       ["write_niter"])
    samples = {(r, it): {
        "prev": None if it == 0 else np.array(res[r].signal_ps[it - 1]),
        "ps": np.array(res[r].signal_ps[it]),
        "chisq": float(res[r].chisq[it]),
        "ln_post": float(res[r].ln_post[it])} for r, it in pairs}
    return inp, samples


@pytest.mark.parametrize("workload", ["h1c_main", "h1c_rfi"])
def test_reference_follows_the_port(workload):
    seed = 2 ** 31 + 77
    inp, samples = _program(workload, seed)
    assert any(it == 0 for _, it in samples)       # the start is checked
    low = control.readings(inp, samples, seed, "fp64")
    assert low["ps_gap"] < 1e-4 and low["chisq_gap"] < 1e-4
    assert low["lnpost_gap"] < 1e-4 and low["prior_gap"] < 1e-3
    up = control.readings(inp, control.control_samples(inp, samples, seed),
                          seed, "fp64")
    assert all(up[k] > 30 * low[k] for k in check.NUMBERS
               if k != "prior_gap")
    limits = harness.load_cell(workload)[4]
    assert all(low[k] <= limits[k] for k in check.NUMBERS)
    assert any(up[k] > limits[k] for k in check.NUMBERS)


@pytest.mark.parametrize("workload", bench_util.CELLS)
def test_control_is_refused_by_the_cells_limits(workload):
    """The control in the program's place, at the cell's own widths (one
    baseline's chains, iterations 0 and 1), through the decision a run
    makes against ``limits/<cell>.json``: not correct; the float64
    reference in the same place is."""
    from hydra_pspec_torch import runner
    seed = 2 ** 31 + 4099
    _, _, config, traffic, limits = harness.load_cell(workload)
    config = dict(config, baselines_per_card=1)
    inp = harness.Inputs(config, traffic, 1, seed, runner.BaselineJob)
    bounded = sampler.bounded_bins(inp.prior)[0]
    table = sampler.invgamma_table(float(inp.nt))
    samples = {}
    for row in range(inp.rows):
        prev = None
        for it in range(2):
            rnd = sampler.randomness(inp.baselines[0], seed, row, it,
                                     len(bounded))
            want = sampler.step(inp.baselines[0],
                                inp.ps0 if prev is None else prev, rnd,
                                inp.prior, table, "fp64")
            samples[(row, it)] = dict(prev=prev, ps=want["ps"],
                                      chisq=want["chisq"],
                                      ln_post=want["ln_post"])
            prev = want["ps"]
    own = control.readings(inp, samples, seed, "fp64")
    assert check.verdict(own, limits)[0] is True
    ctl = control.readings(inp, control.control_samples(inp, samples, seed),
                           seed, "fp64")
    assert check.verdict(ctl, limits)[0] is False


def test_philox_matches_the_ports_twin():
    import torch
    from hydra_pspec_torch.ops import philox as port
    sids = torch.tensor([3, 2 ** 30 + 5], dtype=torch.int32)
    oa, ob = port.omega_fields(2 ** 31 + 9, sids, 17, 6, 8, 8, 6)
    for b, sid in enumerate(sids.tolist()):
        ra, rb = philox.omegas(2 ** 31 + 9, sid, 17, 6, 8, 6)
        assert np.allclose(oa[b].numpy(), ra, atol=1e-5)
        assert np.allclose(ob[b].numpy(), rb, atol=1e-5)
    g = port.gamma_draws(5, sids, 3, 4, 202).numpy()
    u = port.prior_uniforms(5, sids, 3, 7).numpy()
    for b, sid in enumerate(sids.tolist()):
        assert np.allclose(g[b], philox.gamma(5, sid, 3, 4, 202), rtol=1e-5)
        assert np.allclose(u[b, :7], philox.prior_uniforms(5, sid, 3, 7))


def test_tf32_rounding():
    x = np.array([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0],
                 np.float32)
    r = sampler.tf32(x)
    assert r[0] == np.float32(1.0 + 2 ** -10)      # ties away from zero
    assert r[1] == np.float32(1.0 + 2 ** -10)
    assert r[2] == -3.0


def test_initial_state_and_groups():
    assert np.allclose(sampler.initial_bandpowers(np.eye(8)), 8.0)
    flags = np.zeros((6, 4), bool)
    flags[2:4, 1] = True
    groups = sampler.flag_groups(flags, 6, 4)
    assert [g.idx.tolist() for g in groups] == [[0, 1, 4, 5], [2, 3]]
    assert groups[1].w.tolist() == [1.0, 0.0, 1.0, 1.0]
