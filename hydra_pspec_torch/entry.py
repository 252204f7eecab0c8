"""Entry points of the port for a quick check: one step and a multi-device
dry run (the counterpart of ``__graft_entry__.py``).

``entry()`` returns one Gibbs step of the real engine (GCR solve,
bandpower draw, diagnostics) on the reference's shape, 203 times x 120
channels, on the card. ``dryrun_multichip(n)`` runs the production
runner, ``runner.run_baselines`` on the megachain engine, with its
(baseline x chain) rows split over ``n`` devices (``mesh_devices``), one
iteration on tiny shapes: no collective runs while sampling (the sampler
is embarrassingly parallel, SURVEY.md §2.6-2.7).
"""
import numpy as np
import torch

from .models import rgibbs
from .ops.kernels import rng_bandpower as rb
from .runner import BaselineJob, run_baselines


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _synthetic_problem(device, ntimes=203, nfreqs=120, nmodes=12, nbatch=1):
    """The JAX entry's problem (``__graft_entry__.py:16-36``) on
    ``device``: operators, float32 bandpowers and the (unbounded) prior."""
    rng = np.random.default_rng(0)
    ops_list = []
    for _ in range(nbatch):
        d = _crandn(rng, ntimes, nfreqs) * 2.0
        w = np.ones(nfreqs)
        w[nfreqs // 3] = 0.0
        fg = np.linalg.qr(_crandn(rng, nfreqs, nmodes))[0]
        ops_list.append(rgibbs.build_chain_operators(
            d, w, fg, np.full(nfreqs, 25.0)))
    ops = rgibbs.to_device(rgibbs.stack_chain_operators(ops_list), device)
    ps0 = (np.abs(rng.standard_normal((nbatch, nfreqs))).astype(np.float32)
           * 5 + 1.0)
    prior = rb.prior_bins(rb.bounded_bins(np.zeros((2, nfreqs))), device)
    return ops, torch.from_numpy(ps0).to(device), prior


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(rand, ps, ops, prior)`` is one batched
    Gibbs alternation of the real engine, returning ``(ps_new, ln_post,
    ps sample)``; ``rand`` holds the Philox stream arguments (seed, int32
    chain ids, global iteration)."""
    ops, ps0, prior = _synthetic_problem(torch.device(device))

    def fn(rand, ps, ops, prior):
        ps_new, sample = rgibbs.gibbs_step(ops, ps, prior, rand)
        return ps_new, sample.ln_post, sample.ps

    rand = dict(seed=0, sids=torch.zeros(ps0.shape[0], dtype=torch.int32,
                                         device=ps0.device), g=0)
    return fn, (rand, ps0, ops, prior)


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The production multi-device path on ``n_devices`` devices
    (``cuda:{i % device_count}``, or the CPU when ``device`` is the CPU)
    with the JAX dry run's shapes (``__graft_entry__.py:56-104``): 8 times
    x 16 channels, 3 modes, ``n // 2`` baselines x 2 chains, one
    iteration, through ``run_baselines(engine="megachain",
    mesh_devices=...)``. Checks the engine, the result count and shapes
    and that every sample is finite; prints one line."""
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [torch.device(device)] * n_devices
    rng = np.random.default_rng(0)
    ntimes, nfreqs, nmodes = 8, 16, 3
    nbl, nchains = max(1, n_devices // 2), 2   # batch = n_devices chains
    jobs = []
    for ib in range(nbl):
        d = _crandn(rng, ntimes, nfreqs) * 2.0
        fg = np.linalg.qr(_crandn(rng, nfreqs, nmodes))[0]
        jobs.append(BaselineJob(
            antpair=(0, ib + 1), d=d, w=np.ones(nfreqs), fgmodes=fg,
            S_initial=np.eye(nfreqs), Ninv=np.full(nfreqs, 25.0)))
    prior = np.zeros((2, nfreqs))
    prior[0, nfreqs // 2 - 1: nfreqs // 2 + 2] = 300.0
    prior[1, nfreqs // 2 - 1: nfreqs // 2 + 2] = 0.5

    results, timings = run_baselines(
        jobs, prior, 1, device=devices[0], seed=0, nchains=nchains,
        write_niter=1, engine="megachain", mesh_devices=devices,
        checkpoint=False)
    _check(timings["engine"] == "megachain", timings["engine"])
    _check(len(results) == nbl * nchains, f"{len(results)} results")
    for r in results:
        _check(r.signal_ps.shape == (1, nfreqs), r.signal_ps.shape)
        _check(np.isfinite(r.signal_ps).all()
               and np.isfinite(r.ln_post).all(), "non-finite samples")
    print(f"dryrun_multichip OK: engine=megachain via runner.run_baselines, "
          f"batch {nbl}x{nchains} (baseline x chain) split over "
          f"{n_devices} devices ({timings['device']}), one Gibbs iteration "
          f"(GCR solve + bandpower draw + diagnostics) per chain", flush=True)
