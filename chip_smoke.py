"""Smoke run of the PyTorch/CUDA port (hydra_pspec_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises; exit code non-zero):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build the hand-written kernels from hydra_pspec_torch/csrc with nvcc;
  3. each kernel against its plain torch version on the card, at the main
     path's shapes (B=8, n=128, t=256, m=16), with the tolerance stated;
     Philox bits against the twin; normal and Gamma moments;
  4. chain phase: run_chunk_megachain with numpy-made randomness, K=3,
     B=8, kernels against the plain path, at the CPU pin's tolerances;
  5. main path: runner.run_baselines, 100 baselines x 1 chain at
     203 times x 120 channels, 12 Legendre foreground modes, 7-bin prior,
     200 iterations, on data drawn from the model (chi^2 should be 1);
  6. invariance: the first 10 baselines alone give bit-identical samples;
  7. times: one chain iteration and each kernel at B=100, kernels against
     the plain versions (CUDA events).
The line before the last is a JSON object with every kernel's launches,
error and times; the last line is the device JSON object.
"""
import collections
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 20261016
NT, NF, NM = 203, 120, 12     # reference shape (SURVEY.md:69, bench.py:54-61)
N_BASELINES, NITER, WRITE_NITER = 100, 200, 100
PRIOR_HALF = 3                # 7 prior bins around delay 0
CHI2_GATE = 0.02              # README.md:43-48

# kernel name -> (source, the TPU code it replaces)
KERNELS = {
    "cgemm": ("hydra_pspec_torch/csrc/cgemm.cu",
              "hydra_pspec_tpu/ops/pallas/megastep.py:41"),
    "herm_inv": ("hydra_pspec_torch/csrc/herm_inv.cu",
                 "hydra_pspec_tpu/ops/pallas/spd_inv.py:57"),
    "draw_rhs": ("hydra_pspec_torch/csrc/draw_fused.cu",
                 "hydra_pspec_tpu/ops/pallas/megastep.py:139"),
    "draw_system": ("hydra_pspec_torch/csrc/draw_fused.cu",
                    "hydra_pspec_tpu/ops/pallas/megastep.py:153"),
    "row_scale_sumsq": ("hydra_pspec_torch/csrc/draw_fused.cu",
                        "hydra_pspec_tpu/ops/pallas/megastep.py:199"),
    "draw_resid": ("hydra_pspec_torch/csrc/draw_fused.cu",
                   "hydra_pspec_tpu/ops/pallas/megastep.py:221"),
    "rng_fields": ("hydra_pspec_torch/csrc/rng_bandpower.cu",
                   "hydra_pspec_tpu/ops/pallas/megachain.py:238"),
    "bandpower": ("hydra_pspec_torch/csrc/rng_bandpower.cu",
                  "hydra_pspec_tpu/ops/pallas/megachain.py:102"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# --- 1. environment ----------------------------------------------------------

def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}; "
        f"{smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# --- synthetic data from the model -------------------------------------------

def ps_truth():
    delay = np.arange(NF) - NF // 2
    return 1000.0 / (1.0 + (delay / 8.0) ** 2)


def make_jobs(nbl, job_cls, legendre_fgmodes, out_root=None):
    """d = s + Fg a + n with s ~ CN(0, F^H diag(ps/n^2) F), foreground
    amplitudes ~1e3 x the noise, n ~ CN(0, 1/Ninv), Ninv = 1."""
    rng = np.random.default_rng(SEED)
    i = np.arange(NF) - NF // 2
    f = np.exp(-2j * np.pi * np.outer(i, i) / NF)
    amp = np.sqrt(ps_truth() / NF**2)
    fg = legendre_fgmodes(NF, NM)
    cn = lambda *s: (rng.standard_normal(s)
                     + 1j * rng.standard_normal(s)) / np.sqrt(2)
    jobs = []
    for b in range(nbl):
        s = (cn(NT, NF) * amp) @ f.conj()          # rows: F^H (amp z)
        a = cn(NT, NM) * 1e3 / (1.0 + np.arange(NM))
        d = s + a @ fg.T + cn(NT, NF)
        jobs.append(job_cls(
            antpair=(b, b + 1), d=d, w=np.ones(NF), fgmodes=fg,
            S_initial=np.eye(NF), Ninv=np.ones(NF),
            out_dir=None if out_root is None else out_root / f"{b}-{b + 1}"))
    return jobs


def make_prior():
    prior = np.zeros((2, NF))
    sl = slice(NF // 2 - PRIOR_HALF, NF // 2 + PRIOR_HALF + 1)
    prior[0, sl] = ps_truth()[sl] * 10.0
    prior[1, sl] = ps_truth()[sl] / 10.0
    return prior


def build_ops(jobs, device):
    from hydra_pspec_torch.models import mega, rgibbs

    ops = rgibbs.stack_chain_operators(
        [rgibbs.build_chain_operators(j.d, j.w, j.fgmodes, j.Ninv)
         for j in jobs])
    return mega.from_chain_operators(ops, device)


# --- 3. kernels against their plain versions --------------------------------

def phase_kernels(dev, jobs8, errs):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops import philox
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    K, P = I.KERNELS, I.PLAIN
    mops, dims = build_ops(jobs8, dev)
    B, n, t = mops.nid.shape
    nf, nt = dims.nfreqs, dims.ntimes
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)

    def cmp(name, got, want, tol, what="", scale=None):
        """max|got - want| <= tol * scale, scale defaulting to max|want|
        (a product passes the magnitude its sums run over instead: a
        cancellation's result is no measure of its rounding)."""
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = float(torch.abs(g - w).max())
            ref = float(torch.abs(w).max()) if scale is None else scale
            errs[name] = max(errs.get(name, 0.0), err)
            say("kernels", f"{name:16s} {what:22s} max_abs_err {err:.3e} "
                f"<= {tol:.0e} x {ref:.3e}")
            require(err <= tol * ref, f"{name} {what}: {err} > "
                    f"{tol} x {ref}")

    def mm(a, b, op="N", x=None, alpha=1.0, beta=1.0, what=""):
        """cgemm against plain_cgemm; the scale is max(|alpha| |op(A)| |B|
        + |beta| |X|), the magnitude the FP32 sums run over."""
        got = K.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta)
        want = P.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta)
        aop = a if op == "N" else a.transpose(-2, -1)
        mag = abs(alpha) * torch.matmul(torch.abs(aop), torch.abs(b))
        if x is not None:
            mag = mag + abs(beta) * torch.abs(x)
        cmp("cgemm", got, want, 1e-5, what, float(mag.max()))
        return want

    # Philox words: bit-identical to the twin
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ctr = torch.randint(-2**31, 2**31 - 1, (1 << 20, 4), generator=gen,
                        dtype=torch.int32)
    key = torch.randint(-2**31, 2**31 - 1, (1 << 20, 2), generator=gen,
                        dtype=torch.int32)
    words = rb.philox_raw(ctr.to(dev), key.to(dev)).cpu()
    require(torch.equal(words, rb.philox_raw(ctr, key)),
            "Philox kernel bits differ from the twin")
    say("kernels", f"philox_raw       2^20 counters: bit-identical to twin")

    oa, ob = K.rng_fields(SEED, sids, 7, n, t, nt, nf)
    cmp("rng_fields", (oa, ob), P.rng_fields(SEED, sids, 7, n, t, nt, nf),
        1e-5, "omegas vs twin")
    sa = math.sqrt(0.5) * math.sqrt(nf)
    for name, v, s in (("oa", oa, sa), ("ob", ob, math.sqrt(0.5))):
        x = torch.cat([v[:, :, :nt].real.flatten(),
                       v[:, :, :nt].imag.flatten()]).double() / s
        N = x.numel()
        m, var = float(x.mean()), float(x.var())
        say("kernels", f"rng_fields       {name} normals N={N} mean {m:+.2e} "
            f"var-1 {var - 1:+.2e} (5 sigma {5 / math.sqrt(N):.1e}, "
            f"{5 * math.sqrt(2 / N):.1e})")
        require(abs(m) < 5 / math.sqrt(N) and abs(var - 1) <
                5 * math.sqrt(2 / N), f"{name} normal moments")
        require(torch.all(v[:, :, nt:] == 0), f"{name} pad lanes not zero")

    rc = K.draw_rhs(mops.nid, mops.nih, ob, nt)
    cmp("draw_rhs", rc, P.draw_rhs(mops.nid, mops.nih, ob, nt), 1e-5)
    ba = mm(mops.fg, rc, op="H", what="Fg^H rc")
    rc2 = mm(mops.g, ba, x=rc, alpha=-1.0, beta=1.0, what="rc - G ba")
    frc = mm(mops.f, rc2, what="F rc (shared F)")
    sys_k = K.draw_system(mops.pt, ps, frc, oa, nt, nf)
    sys_p = P.draw_system(mops.pt, ps, frc, oa, nt, nf)
    cmp("draw_system", sys_k, sys_p, 1e-5)
    s = sys_p[0]
    inv_k, inv_p = K.herm_inv(s), P.herm_inv(s)
    cmp("herm_inv", inv_k, inv_p, 1e-3, "vs Cholesky inverse")
    eye = torch.eye(n, dtype=s.dtype, device=dev)
    res = float(torch.abs(torch.matmul(s, inv_k) - eye).max())
    res_p = float(torch.abs(torch.matmul(s, inv_p) - eye).max())
    say("kernels", f"herm_inv         max|A A^-1 - I| {res:.3e} (plain "
        f"{res_p:.3e}) <= 1e-3")
    require(res <= 1e-3, "herm_inv residual")
    ex = mm(s, inv_k, what="S X")
    mm(inv_k, ex, x=inv_k, alpha=-1.0, beta=2.0, what="NS X(2I - S X)")
    x = mm(inv_k, sys_p[1], what="S^-1 xs")
    mm(s, x, x=sys_p[1], alpha=-1.0, beta=1.0, what="refine xs - S x")
    dd, dinv = sys_p[2], sys_p[3]
    cmp("row_scale_sumsq", K.row_scale_sumsq(x, dinv, dd),
        P.row_scale_sumsq(x, dinv, dd), 1e-5, "sk, beta")
    sk = P.row_scale_sumsq(x, dinv, dd)[0]
    sig = mm(mops.f, sk, op="H", alpha=1.0 / nf, what="F^H sk / n")
    da = P.cgemm(mops.g, sig, op="H", x=P.cgemm(mops.mi, ba), alpha=-1.0)
    fa = P.cgemm(mops.fg, da)
    w = mops.w.clone()
    w[:, 5] = 0.0                                   # flagged variant
    for lean in (False, True):
        kw = dict(want_chi=not lean, want_chit=lean, want_amp=not lean,
                  want_ws=True)
        args = (mops.dw, sig, fa, mops.ninv_full, w, da, mops.a0, nt)
        cmp("draw_resid", K.draw_resid(*args, **kw),
            P.draw_resid(*args, **kw), 1e-5, "lean" if lean else "full")

    tables = megachain.make_chain_tables(mops, dev)
    prior = rb.prior_bins(megachain.prior_static_from(make_prior(), dims),
                          dev)
    beta = P.row_scale_sumsq(x, dinv, dd)[1]
    gams = []
    for g in range(16):
        kp, kg = K.bandpower(beta, prior, tables.tlog, tables.q, seed=SEED,
                             sids=sids, g=g, alpha=nt - 1, gam_out=True)
        pp, pg = P.bandpower(beta, prior, tables.tlog, tables.q, seed=SEED,
                             sids=sids, g=g, alpha=nt - 1, gam_out=True)
        if g == 0:
            cmp("bandpower", (kg, kp), (pg, pp), 1e-5, "gamma, ps")
        require(float(torch.abs(kp - pp).max() / torch.abs(pp).max())
                < 1e-5, f"bandpower ps g={g}")
        gams.append(kg.double().flatten())
    gam = torch.cat(gams)
    a = nt - 1
    N = gam.numel()
    m, var = float(gam.mean()), float(gam.var())
    tol_m, tol_v = 5 * math.sqrt(a / N), 5 * math.sqrt((2 * a * a + 6 * a) / N)
    say("kernels", f"bandpower        Gamma({a}) N={N} mean-a {m - a:+.3f} "
        f"(5 sigma {tol_m:.3f}) var-a {var - a:+.2f} (5 sigma {tol_v:.2f})")
    require(abs(m - a) < tol_m and abs(var - a) < tol_v, "Gamma moments")
    u = torch.rand((B, 128), generator=torch.Generator(device=dev)
                   .manual_seed(3), device=dev)
    gext = gams[0].float().reshape(B, n).to(dev)
    cmp("bandpower",
        K.bandpower(beta, prior, tables.tlog, tables.q, gam=gext, u_pb=u),
        P.bandpower(beta, prior, tables.tlog, tables.q, gam=gext, u_pb=u),
        1e-5, "external randomness")
    require(torch.all(kp[:, nf:] == 0), "pad bins of ps not zero")
    _build.reset_launches()


# --- 4. chain phase ----------------------------------------------------------

def phase_chain(dev, jobs8):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import impl as I

    mops, dims = build_ops(jobs8, dev)
    B, n, t = mops.nid.shape
    Kit = 3
    rng = np.random.default_rng(SEED + 1)
    sa = np.float32(np.sqrt(0.5) * np.sqrt(dims.nfreqs))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    rnd = {"oa_re": f32(rng.standard_normal((Kit, B, n, t))) * sa,
           "oa_im": f32(rng.standard_normal((Kit, B, n, t))) * sa,
           "ob_re": f32(rng.standard_normal((Kit, B, n, t))) * hf,
           "ob_im": f32(rng.standard_normal((Kit, B, n, t))) * hf,
           "gam": f32(rng.gamma(dims.ntimes - 1, size=(Kit, B, n))),
           "u_pb": f32(rng.uniform(size=(Kit, B, 128)))}
    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(), dims)
    ps0 = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    for warm in ({}, {"warm_ns": 3, "drift_max": 10.0}):
        out = {}
        for name, impl in (("kernels", I.KERNELS), ("plain", I.PLAIN)):
            out[name] = megachain.run_chunk_megachain(
                mops, tables, dims, ps0, Kit, static, randomness=rnd,
                impl=impl, **warm)
        (kps, ks), (pps, ps_) = out["kernels"], out["plain"]
        torch.cuda.synchronize()
        sig_err = max(
            float(torch.abs(f(ks.signal_cr) - f(ps_.signal_cr)).max()
                  / torch.abs(f(ps_.signal_cr)).mean())
            for f in (torch.real, torch.imag))
        ps_ok = torch.allclose(ks.ps, ps_.ps, rtol=2e-3, atol=1e-6) and \
            torch.allclose(kps, pps, rtol=2e-3, atol=1e-6)
        chi_err = float(torch.abs(ks.chisq - ps_.chisq).max())
        say("chain", f"K={Kit} B={B} {warm or 'exact'}: sig {sig_err:.2e} "
            f"< 2e-4 (rel. mean), ps within rtol 2e-3/atol 1e-6: {ps_ok}, "
            f"chi {chi_err:.2e} < 5e-3")
        require(sig_err < 2e-4 and ps_ok and chi_err < 5e-3,
                "chain phase: kernels disagree with the plain path")


# --- 5. main path -----------------------------------------------------------

class _DeviceAudit(TorchDispatchMode):
    """Counts the ops that produce tensors on each device; host transfers
    (the flush of samples) are the only ops allowed to produce CPU
    tensors."""

    HOST_OK = {"_to_copy", "copy_", "lift_fresh", "lift_fresh_copy",
               "_local_scalar_dense", "detach", "alias", "view"}

    def __init__(self):
        super().__init__()
        self.cuda_ops = 0
        self.cpu_ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                if o.device.type == "cuda":
                    self.cuda_ops += 1
                else:
                    name = func.__name__.split(".")[0]
                    if name not in self.HOST_OK:
                        self.cpu_ops[name] += 1
        return out


def phase_main(dev, out_root):
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.cli.run import legendre_fgmodes
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.utils import io as hio

    jobs = make_jobs(N_BASELINES, runner.BaselineJob, legendre_fgmodes,
                     out_root)
    audit = _DeviceAudit()
    _build.reset_launches()
    t0 = time.perf_counter()
    with audit:
        results, tim = runner.run_baselines(
            jobs, make_prior(), NITER, device=dev, seed=SEED,
            write_niter=WRITE_NITER, store_cr=True, warm_ns=3,
            drift_max=0.6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    say("main", f"{N_BASELINES} baselines x {NITER} iterations: wall "
        f"{wall:.2f} s, process {tim['process']:.2f} s (write "
        f"{tim['write']:.2f} s), build+transfer {tim['scatter']:.2f} s")
    sampling = tim["process"] - tim["write"]
    say("main", f"iterations/s {NITER / sampling:.2f} sampling only "
        f"({NITER / tim['process']:.2f} with flushes); baseline-iterations/s "
        f"{N_BASELINES * NITER / sampling:.1f}")
    require(tim["device"].startswith("cuda"), "runner did not run on cuda")
    say("main", f"device audit: {audit.cuda_ops} cuda tensor ops, CPU "
        f"compute ops {dict(audit.cpu_ops) or 'none'}")
    require(not audit.cpu_ops and audit.cuda_ops > 0,
            "tensors of the path left the device")
    shapes = {"signal_cr": (NITER, NT, NF), "signal_S": (NF, NF),
              "signal_ps": (NITER, NF), "fg_amps": (NITER, NT, NM),
              "chisq": (NITER, NT, NF), "ln_post": (NITER,)}
    for job in jobs:
        got = hio.load_samples(job.out_dir)
        for k, shape in shapes.items():
            require(k in got and got[k].shape == shape,
                    f"{job.out_dir}: {k} missing or wrong shape")
            require(np.isfinite(got[k]).all(), f"{job.out_dir}: {k} "
                    f"not finite")
    say("main", f"six reference files per baseline with the JAX runner's "
        f"shapes, all finite")
    chi2 = float(np.mean([r.chisq[50:NITER].mean() for r in results]))
    say("main", f"mean chi^2 over iterations 51-{NITER}: {chi2:.5f} "
        f"(gate |chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "chi^2 gate")
    truth = ps_truth()
    delay = np.abs(np.arange(NF) - NF // 2)
    eor = (delay >= 4) & (delay <= 16)
    ratio = np.median([r.signal_ps[50:].mean(axis=0)[eor] / truth[eor]
                       for r in results])
    say("main", f"posterior-mean / truth on EoR bins 4 <= |delay| <= 16: "
        f"median {ratio:.4f} (information only)")
    missing = [k for k in KERNELS if launches[k] == 0]
    say("main", f"launches {launches}")
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    return jobs, results, launches, N_BASELINES * NITER / sampling


# --- 6. invariance -----------------------------------------------------------

def phase_invariance(dev, jobs, results):
    from hydra_pspec_torch import runner

    sub = [runner.BaselineJob(j.antpair, j.d, j.w, j.fgmodes, j.S_initial,
                              j.Ninv) for j in jobs[:10]]
    res10, _ = runner.run_baselines(
        sub, make_prior(), NITER, device=dev, seed=SEED,
        write_niter=WRITE_NITER, store_cr=True, warm_ns=3, drift_max=0.6,
        global_baseline_ids=list(range(10)))
    for j, r in zip(jobs[:10], res10):
        dps = np.load(Path(j.out_dir) / "dps-eor.npy")
        require(np.array_equal(dps, r.signal_ps),
                f"baseline {j.antpair}: dps-eor differs in the subset run")
    say("invariance", "first 10 baselines alone: dps-eor bit-identical to "
        "the 100-baseline run")


# --- 7. times ----------------------------------------------------------------

def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_times(dev, jobs):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    K, P = I.KERNELS, I.PLAIN
    mops, dims = build_ops(jobs, dev)
    B, n, t = mops.nid.shape
    nf, nt = dims.nfreqs, dims.ntimes
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(), dims)
    prior = rb.prior_bins(static, dev)

    kit = 5
    chain = {}
    for name, impl in (("kernels", K), ("plain", P), ("kernels", K),
                       ("plain", P)):
        ms = _time(lambda: megachain.run_chunk_megachain(
            mops, tables, dims, ps, kit, static, seed=SEED, sids=sids,
            warm_ns=3, drift_max=0.6, impl=impl), 2) / kit
        chain.setdefault(name, []).append(ms)
    say("times", f"one chain iteration at B={B}: kernel path "
        f"{chain['kernels']} ms, plain path {chain['plain']} ms")

    oa, ob = P.rng_fields(SEED, sids, 0, n, t, nt, nf)
    rc = P.draw_rhs(mops.nid, mops.nih, ob, nt)
    frc = P.cgemm(mops.f, rc)
    s, xs, dd, dinv = P.draw_system(mops.pt, ps, frc, oa, nt, nf)
    inv = P.herm_inv(s)
    x = P.cgemm(inv, xs)
    beta = P.row_scale_sumsq(x, dinv, dd)[1]
    da = torch.zeros_like(mops.a0)
    cases = {
        "cgemm": lambda M: M.cgemm(mops.f, rc),
        "herm_inv": lambda M: M.herm_inv(s),
        "draw_rhs": lambda M: M.draw_rhs(mops.nid, mops.nih, ob, nt),
        "draw_system": lambda M: M.draw_system(mops.pt, ps, frc, oa, nt, nf),
        "row_scale_sumsq": lambda M: M.row_scale_sumsq(x, dinv, dd),
        "draw_resid": lambda M: M.draw_resid(
            mops.dw, x, rc, mops.ninv_full, mops.w, da, mops.a0, nt,
            want_chi=True, want_chit=False, want_amp=True, want_ws=False),
        "rng_fields": lambda M: M.rng_fields(SEED, sids, 0, n, t, nt, nf),
        "bandpower": lambda M: M.bandpower(
            beta, prior, tables.tlog, tables.q, seed=SEED, sids=sids, g=0,
            alpha=nt - 1),
    }
    times = {}
    for name, fn in cases.items():
        pk = [_time(lambda: fn(P), 10), _time(lambda: fn(K), 10),
              _time(lambda: fn(K), 10), _time(lambda: fn(P), 10)]
        times[name] = ((pk[1] + pk[2]) / 2, (pk[0] + pk[3]) / 2)
        say("times", f"{name:16s} B={B}: kernel {times[name][0]:.4f} ms, "
            f"plain {times[name][1]:.4f} ms (plain, kernel, kernel, plain "
            f"= {', '.join(f'{v:.4f}' for v in pk)})")
    _build.reset_launches()
    return chain, times


def main():
    smi = phase_env()
    dev = torch.device("cuda", 0)
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.cli.run import legendre_fgmodes
    from hydra_pspec_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    secs, log = _build.build_info()
    say("build", f"nvcc sm_90a: {secs if secs is not None else 0:.1f} s "
        f"(call {time.perf_counter() - t0:.1f} s)")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("build", line.strip())

    jobs8 = make_jobs(8, runner.BaselineJob, legendre_fgmodes)
    errs = {}
    phase_kernels(dev, jobs8, errs)
    phase_chain(dev, jobs8)
    out_root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        jobs, results, launches, rate = phase_main(dev, out_root)
        phase_invariance(dev, jobs, results)
        del results
        chain, times = phase_times(dev, jobs)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in KERNELS.items()],
        "chain_iteration_ms": {"kernels": chain["kernels"],
                               "plain": chain["plain"], "batch": N_BASELINES},
        "main_baseline_iters_per_s": rate}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
