"""The posterior oracle gate on the card: the port's twin of
``scripts/validate_posterior.py`` on the synthetic problem.

    python -m hydra_pspec_torch.validation.validate --engine megachain \
        [--flag_channels 12,30-33,77-79,100] [--niter 12000] [--nburn 2000]
        [--nchains 16] [--device cuda]

Runs ``nchains`` chains (chain stream ids 0 .. nchains-1 of one baseline)
of one of the port's engines on ``validation/synth.py``'s problem, all
started from ``ps_truth`` as the oracle is, and accepts them with the JAX
script's gates, unchanged:

  * post-burn chi^2 within 2 % of 1 (on the unflagged channels when
    flagged);
  * split-R-hat max <= 1.1;
  * ``utils.mcstats.oracle_acceptance`` against the committed oracle
    (``validation/oracle_posterior_synth.json``, written by
    ``validation/oracle.py``): per-bin max z < 4.5, at most 5 bins with
    z > 3, the posterior median inside the oracle's 90 % interval in at
    least 95 % of bins.

The engines: ``megachain`` at the production warm start (``warm_ns=3``,
``drift_max=0.6``), its chunks as CUDA graphs, lean (``store_cr=False``,
the flagged case's chi^2 through ``chi_mask``); ``mega``; ``real`` with
the ``pallas`` solver (the factor-solve kernel); ``complex``, the
complex float64 engine. A flag pattern that matches no oracle case, or an
oracle built from another synthetic seed, is an error unless
``--no_oracle`` waives the gate explicitly. The entry, labelled
``<device>_<engine>[_flagged]``, is merged into
``validation/validate_posterior_torch.json``; the exit code is 1 when a
gate fails.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.mcstats import compare_to_oracle, oracle_acceptance
from . import synth
from .oracle import OUT as ORACLE, edge_bins, gelman_rubin

HERE = Path(__file__).resolve().parent
OUT = HERE / "validate_posterior_torch.json"
SEED = 7123689              # the Philox run seed
ENGINES = ("megachain", "mega", "real", "complex")
CHI2_GATE, RHAT_GATE = 0.02, 1.1
# real and complex chunks: a complex chunk is a CUDA graph, whose capture
# and instantiation grow with its length (about 2 s at 100 iterations)
CHUNK = 100


class OracleMismatch(ValueError):
    """The run's problem has no case in the oracle artifact."""


def oracle_case(art: dict, flag_channels, synth_seed: int):
    """The oracle case of a run (``validate_posterior.py:195-212``):
    ``unflagged``, or ``flagged`` when the pattern is the artifact's;
    raises :class:`OracleMismatch` for any other pattern or another
    synthetic seed."""
    prov = art.get("provenance", {})
    if prov.get("synth_seed", synth_seed) != synth_seed:
        raise OracleMismatch(
            f"the oracle was built from synth seed {prov.get('synth_seed')}"
            f", the run uses {synth_seed}")
    if not flag_channels:
        return "unflagged"
    want = art.get("flagged", {}).get("flag_channels")
    if flag_channels == want:
        return "flagged"
    raise OracleMismatch(
        f"--flag_channels={flag_channels!r} matches no committed oracle case"
        f" (flagged oracle is {want!r}); rebuild the oracle for this pattern"
        " (python -m hydra_pspec_torch.validation.oracle) or pass"
        " --no_oracle to waive the gate EXPLICITLY")


def gates(post: np.ndarray, chi_mean: float, oracle: dict = None) -> dict:
    """The three gates on post-burn draws ``post`` (nchains, ndraws, nbins)
    and the post-burn chi^2 mean: ``{"gates": {...}, "pass": bool,
    "oracle_compare": ..., "split_rhat_max": ...}``. ``oracle`` None: the
    oracle gate waived (``gates["oracle"]`` None)."""
    rhat = gelman_rubin(post)
    cmp = None if oracle is None else compare_to_oracle(post, oracle)
    g = {"chisq": abs(chi_mean - 1.0) < CHI2_GATE,
         "rhat": float(np.nanmax(rhat)) <= RHAT_GATE,
         "oracle": None if cmp is None else oracle_acceptance(cmp)}
    if cmp is None:
        g["oracle_waived"] = True
    return {"gates": g, "pass": all(v for v in g.values() if v is not None),
            "oracle_compare": cmp,
            "split_rhat_max": round(float(np.nanmax(rhat)), 4),
            "split_rhat_median": round(float(np.nanmedian(rhat)), 4)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(sample, w, store_cr):
    """``(ps, chi^2 mean, ln_post)`` of a chunk as float64 numpy, (K,
    nchains[, nbins]); with ``store_cr`` the chi^2 mean over the channels
    with ``w`` > 0."""
    chi = sample.chisq
    if store_cr:
        m = torch.as_tensor(w > 0, device=chi.device)
        chi = chi[..., m].mean(dim=(-2, -1))
    return tuple(x.double().cpu().numpy()
                 for x in (sample.ps, chi, sample.ln_post))


def run_engine(engine: str, prob, nchains: int, niter: int, device, *,
               seed=SEED, warm_ns=3, drift_max=0.6, solver="pallas"):
    """``nchains`` chains of ``engine`` on ``prob`` (a
    :class:`synth.Problem`), streams 0 .. nchains-1 of ``seed``, from
    ``ps_truth``. Returns ``(ps (niter, nchains, nbins), chi^2 mean
    (niter, nchains), ln_post (niter, nchains), wall seconds)``."""
    from ..models import gcr, gibbs, mega, megachain, rgibbs
    from ..ops.kernels import rng_bandpower as rb

    dev = torch.device(device)
    flagged = bool(np.any(prob.w == 0))
    ps0 = np.tile(prob.ps_truth, (nchains, 1))
    sids = torch.arange(nchains, dtype=torch.int32, device=dev)
    pieces = []
    t0 = time.perf_counter()
    if engine in ("megachain", "mega"):
        ops1 = rgibbs.build_chain_operators(prob.d, prob.w, prob.fgmodes,
                                            prob.ninv)
        mops, dims = mega.from_chain_operators(
            rgibbs.stack_chain_operators([ops1] * nchains), dev)
        ps = mega.pad_ps(ps0, dims, dev)
        chi_mask = prob.w.astype(np.float32) if flagged else None
        chunk = megachain.auto_chunk(niter, nchains, dims, False)
        if engine == "megachain":
            _, s = megachain.run_chain_megachain(
                mops, dims, ps, prob.prior, niter, seed=seed, sids=sids,
                store_cr=False, chi_mask=chi_mask, chunk=chunk,
                warm_ns=warm_ns, drift_max=drift_max)
            pieces.append(_host(s, prob.w, False))
        else:
            tables = megachain.make_chain_tables(mops, dev)
            bins = rb.prior_bins(rb.bounded_bins(prob.prior), dev)
            graphs = {}
            for it in range(0, niter, chunk):
                k = min(chunk, niter - it)
                ps, s = mega.run_chain_mega(
                    mops, dims, ps, bins, k, tables.tlog, tables.q,
                    seed=seed, sids=sids, iter0=it, store_cr=False,
                    chi_mask=chi_mask, graphs=graphs)
                pieces.append(_host(s, prob.w, False))
    elif engine == "real":
        ops1 = rgibbs.build_chain_operators(prob.d, prob.w, prob.fgmodes,
                                            prob.ninv)
        rops = rgibbs.to_device(
            rgibbs.stack_chain_operators([ops1] * nchains), dev)
        bins = rb.prior_bins(rb.bounded_bins(prob.prior), dev)
        ps = torch.as_tensor(ps0, dtype=torch.float32, device=dev)
        for it in range(0, niter, CHUNK):
            k = min(CHUNK, niter - it)
            ps, s = rgibbs.run_chain(
                rops, ps, bins, k, seed=seed, sids=sids, iter0=it,
                store_cr=flagged, solver=solver, all_unflagged=not flagged)
            pieces.append(_host(s, prob.w, flagged))
    elif engine == "complex":
        cops = gcr.build_chain_operators(prob.d, prob.w, prob.fgmodes,
                                         prob.ninv, device=dev)
        ps = torch.as_tensor(ps0, dtype=torch.float64, device=dev)
        graphs = {}
        for it in range(0, niter, CHUNK):
            k = min(CHUNK, niter - it)
            ps, s = gibbs.run_chain(cops, ps, prob.prior, k, seed=seed,
                                    sids=sids, iter0=it, store_cr=flagged,
                                    graphs=graphs)
            pieces.append(_host(s, prob.w, flagged))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    _sync(dev)
    wall = time.perf_counter() - t0
    ps, chi, lnp = (np.concatenate([p[i] for p in pieces]) for i in range(3))
    return ps, chi, lnp, wall


def validate(engine: str, *, flag_channels=None, nchains=16, niter=12000,
             nburn=2000, device="cuda", seed=SEED, synth_seed=synth.SEED,
             oracle_path=ORACLE, no_oracle=False, **engine_kw) -> dict:
    """One validation run (module docstring): the verdict dict, with the
    wall seconds of the chains, the gates and ``pass``."""
    art = json.loads(Path(oracle_path).read_text())
    case = None
    try:
        case = oracle_case(art, flag_channels, synth_seed)
    except OracleMismatch:
        if not no_oracle:
            raise
    prob = synth.synthetic_problem(synth_seed, flag_channels)
    ps, chi, lnp, wall = run_engine(engine, prob, nchains, niter, device,
                                    seed=seed, **engine_kw)
    nf = ps.shape[2]
    post = ps[nburn:]                               # (npost, nchains, nf)
    pwm = np.average(post.reshape(-1, nf), weights=lnp[nburn:].reshape(-1),
                     axis=0)
    edge = edge_bins(nf)
    ratio = pwm[edge] / prob.dps_true()[edge]
    chi_mean = float(chi[nburn:].mean())
    res = gates(np.swapaxes(post, 0, 1), chi_mean,
                None if case is None else art[case])
    if res["oracle_compare"] is not None:
        res["oracle_compare"]["oracle_case"] = case
    return {
        "device": str(torch.device(device)),
        "engine": engine,
        **({"flag_channels": flag_channels} if flag_channels else {}),
        "niter": niter, "nburn": nburn, "nchains": nchains, "seed": seed,
        "synth_seed": synth_seed,
        "wall_s": round(wall, 2),
        "chisq_postburn_mean": round(chi_mean, 5),
        "ratio_median": round(float(np.median(ratio)), 4),
        "ratio_p5": round(float(np.percentile(ratio, 5)), 4),
        "ratio_p95": round(float(np.percentile(ratio, 95)), 4),
        "split_rhat_median": res["split_rhat_median"],
        "split_rhat_max": res["split_rhat_max"],
        **({"oracle_compare": res["oracle_compare"]}
           if res["oracle_compare"] is not None else {}),
        "gates": res["gates"],
        "pass": res["pass"],
    }


def label_of(verdict: dict) -> str:
    return "_".join([torch.device(verdict["device"]).type, verdict["engine"]]
                    + (["flagged"] if verdict.get("flag_channels") else []))


def merge(label: str, verdict: dict, out=OUT):
    """Merge ``verdict`` under ``label`` into the JSON file ``out``."""
    out = Path(out)
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged[label] = verdict
    out.write_text(json.dumps(merged, indent=1) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--engine", default="megachain", choices=ENGINES)
    p.add_argument("--flag_channels", default=None,
                   help="comma list / a-b ranges of channels to flag; the "
                        "flagged oracle case is "
                        f"{synth.FLAG_CHANNELS!r}")
    p.add_argument("--niter", type=int, default=12000)
    p.add_argument("--nburn", type=int, default=2000)
    p.add_argument("--nchains", type=int, default=16)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--synth_seed", type=int, default=synth.SEED)
    p.add_argument("--device", default="cuda")
    p.add_argument("--warm_ns", type=int, default=3)
    p.add_argument("--drift_max", type=float, default=0.6)
    p.add_argument("--solver", default="pallas")
    p.add_argument("--oracle", default=str(ORACLE))
    p.add_argument("--no_oracle", action="store_true",
                   help="waive the oracle gate explicitly")
    p.add_argument("--label", default=None)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    kw = (dict(warm_ns=args.warm_ns, drift_max=args.drift_max)
          if args.engine == "megachain" else
          dict(solver=args.solver) if args.engine == "real" else {})
    try:
        verdict = validate(args.engine, flag_channels=args.flag_channels,
                           nchains=args.nchains, niter=args.niter,
                           nburn=args.nburn, device=args.device,
                           seed=args.seed, synth_seed=args.synth_seed,
                           oracle_path=args.oracle,
                           no_oracle=args.no_oracle, **kw)
    except OracleMismatch as e:
        sys.exit(str(e))
    label = args.label or label_of(verdict)
    merge(label, verdict, args.out)
    print(json.dumps({label: verdict}))
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
