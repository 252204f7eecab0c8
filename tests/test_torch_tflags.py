"""The port's grouped time-flags path (hydra_pspec_torch) against the JAX
package: the host setup exactly, one grouped chunk on external randomness
(the JAX kernel in Pallas interpret mode, the port on the plain versions of
its kernels), the grouped Philox streams, and the runner with ``flags_tf``.

The problems are those of tests/test_megachain_tflags.py:38-56, rebuilt here
from this file's own seed. Three distinct JAX kernel configurations run
(one chunk, the runner's two signatures), each once, in one subprocess
(see ``_JAX_SIDE``): every case reads its outputs."""
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
from hydra_pspec_tpu.models import tflags as jtf
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.invgamma import make_invgamma_table
from hydra_pspec_torch.ops.kernels import impl as timpl
from hydra_pspec_torch.ops.kernels.megastep import draw_body
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.utils import io as tio

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
NT, NF, NM = 12, 16, 2
K, NCHAINS = 3, 2
NITER, WRITE, SEED, NBL = 6, 3, 7, 4


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _flags(three_groups, ntimes=NT):
    """Channel 3 flagged from time 7 on; with ``three_groups`` also channel
    8 from time 10 on (tests/test_megachain_tflags.py:44-47)."""
    f = np.zeros((ntimes, NF), dtype=bool)
    f[7:, 3] = True
    if three_groups:
        f[10:, 8] = True
    return f


def _baseline(rng):
    d = _crandn(rng, NT, NF) * 2.0
    fg = _crandn(rng, NF, NM)
    ninv = np.abs(rng.standard_normal(NF)) + 1.0
    return d, fg, ninv


def _prior():
    """Three bounded bins, so the pooled-alpha table is exercised."""
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 1: NF // 2 + 2] = 300.0
    prior[1, NF // 2 - 1: NF // 2 + 2] = 0.5
    return prior


def _jax_arrays(mops) -> dict:
    out = {f: np.asarray(getattr(mops, f)) for f in mops._fields
           if f != "igt"}
    out.update(igt_log_y=np.asarray(mops.igt.log_y),
               igt_q=np.asarray(mops.igt.q),
               igt_alpha=np.asarray(mops.igt.alpha))
    return out


def _c(z):
    """A JAX C pair or array -> complex/real numpy."""
    if hasattr(z, "re"):
        return np.asarray(z.re) + 1j * np.asarray(z.im)
    return np.asarray(z)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                        b.shape)
    assert np.array_equal(a, b), what


@functools.lru_cache(maxsize=None)
def problem(three_groups):
    """One baseline's grouped operators from both packages, stacked over
    NCHAINS chains, and the JAX grouped setup."""
    d, fg, ninv = _baseline(np.random.default_rng(77 if three_groups
                                                  else 78))
    flags = _flags(three_groups)
    jg = jtf.build_grouped_operators_real(d, flags, fg, ninv)
    tg = ttf.build_grouped_operators_real(d, flags, fg, ninv)
    stack = lambda mod, gs, cls: [
        cls(ops=mod.stack_chain_operators([g.ops] * NCHAINS), idx=g.idx)
        for g in gs]
    from hydra_pspec_tpu.models import rgibbs as jrg
    jgroups = stack(jrg, jg, jtf.TimeGroupReal)
    tgroups = stack(trg, tg, ttf.TimeGroupReal)
    return flags, jg, tg, jgroups, tgroups, jmc.build_tflags_mega_setup(
        jgroups)


# --- 1. host setup, exact ----------------------------------------------------

@pytest.mark.parametrize("three_groups", [False, True])
def test_setup_matches_jax(three_groups):
    flags, jg, tg, _, tgroups, jset = problem(three_groups)
    jpat = jtf.group_flag_patterns(flags)
    tpat = ttf.group_flag_patterns(flags)
    assert len(tpat) == len(jpat) == (3 if three_groups else 2)
    for (tw, ti), (jw, ji) in zip(tpat, jpat):
        _equal(tw, jw, "w_g")
        _equal(ti, ji, "idx")
    for t, j in zip(tg, jg):
        _equal(t.idx, j.idx, "group idx")
        for f in ("d_w", "w", "f", "ni_diag", "nih_diag", "ninv_full_diag",
                  "fg", "ni_d", "a0", "p_tilde", "g_mat", "maa_inv"):
            _equal(getattr(t.ops, f), _c(getattr(j.ops, f)), f)

    tset = tmc.build_tflags_mega_setup(tgroups, CPU, layout="jax")
    assert tuple(tset.dims) == tuple(jset.dims)
    assert tset.dims.ntimes == NT and not tset.dims.all_unflagged
    assert tset.group_times == tuple(jset.group_times)
    assert len(tset.group_times) == (4 if three_groups else 2)
    for a, b in zip(tset.group_idx, jset.group_idx):
        _equal(a, b, "group_idx")
    got = tset.mops.to_numpy()
    for f in jset.mops._fields:
        if f != "igt":
            _equal(got[f], np.asarray(getattr(jset.mops, f)), f)
    # the pooled conditional's table is the one at the TOTAL time count
    want = make_invgamma_table(NT)
    for f in ("log_y", "q", "alpha"):
        _equal(getattr(tset.mops.igt, f), np.asarray(getattr(jset.mops.igt,
                                                             f)), f)
        _equal(getattr(tset.mops.igt, f), getattr(want, f), f)
    back = tmc.tflags_setup_from_jax_arrays(
        _jax_arrays(jset.mops), tmega.MegaDims(*jset.dims),
        jset.group_times, jset.group_idx, CPU)
    for f, v in back.mops.to_numpy().items():
        _equal(v, got[f], f)


# --- the JAX kernel runs, in a subprocess ----------------------------------

# Pallas interpret mode runs the kernel through Python callbacks, which can
# deadlock against JAX's asynchronous CPU dispatch when eager ops follow the
# kernel (seen in the JAX runner's reassembly scatters). The switch is read
# only when JAX's CPU backend starts, so the interpret-mode runs go to a
# fresh process with synchronous dispatch and a time limit. It imports
# numpy, jax and the JAX package only, and reads its inputs from an npz.
_JAX_SIDE = r"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_cpu_enable_async_dispatch", False)
jax.config.update("jax_enable_x64", True)
from jax.experimental.pallas import tpu as pltpu

from hydra_pspec_tpu import runner as jrunner
from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_tpu.models import tflags as jtf

root = Path(sys.argv[1])
z = dict(np.load(root / "inputs.npz"))
i = lambda k: int(z[k])
out = {}
with pltpu.force_tpu_interpret_mode():
    groups = [jtf.TimeGroupReal(
                  ops=jrg.stack_chain_operators([g.ops] * i("nchains")),
                  idx=g.idx)
              for g in jtf.build_grouped_operators_real(
                  z["c_d"], z["c_flags"], z["c_fg"], z["c_ninv"])]
    s = jmc.build_tflags_mega_setup(groups)
    ps_rows = jnp.repeat(jmega.pad_ps(jnp.asarray(z["c_ps0"], jnp.float32),
                                      s.dims), len(s.group_times), axis=0)
    rnd = {k: jnp.asarray(z["c_" + k]) for k in
           ("oa_re", "oa_im", "ob_re", "ob_im", "gam", "u_pb")}
    ps, smp = jmc.run_chunk_megachain(
        s.mops, jmc.make_chain_tables(s.mops), s.dims, ps_rows, i("k"),
        jmc.prior_static_from(z["prior"], s.dims), randomness=rnd, refine=1,
        batch_tile=4, store_cr=True, group_times=s.group_times,
        group_idx=s.group_idx)
    out.update(ps_final=ps, ps=smp.ps, ln_post=smp.ln_post,
               sig_re=smp.signal_cr.re, sig_im=smp.signal_cr.im,
               amp_re=smp.fg_amps.re, amp_im=smp.fg_amps.im,
               chisq=smp.chisq)
    jobs = [jrunner.BaselineJob(
                antpair=(0, b + 1), d=z["r_d"][b], w=np.ones(z["r_d"].shape[2]),
                fgmodes=z["r_fg"][b], S_initial=z["r_ps0"][b],
                Ninv=z["r_ninv"][b], out_dir=root / "run" / f"0-{b + 1}",
                flags_tf=z["r_flags"][b])
            for b in range(z["r_d"].shape[0])]
    res, tim = jrunner.run_baselines(
        jobs, z["prior"], i("niter"), seed=i("seed"), nchains=i("nchains"),
        write_niter=i("write"), engine="megachain", use_mesh=False)
    assert tim["engine"] == "megachain", tim
    out.update(run_signal_ps=np.stack([r.signal_ps for r in res]),
               run_ln_post=np.stack([r.ln_post for r in res]))
np.savez(root / "outputs.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@functools.lru_cache(maxsize=None)
def chunk_inputs():
    """3 real groups (G = 4, one dummy), NCHAINS chains, K iterations of
    numpy randomness: per-row omegas, per-chain Gamma and uniforms."""
    *_, jset = problem(True)
    dims = jset.dims
    G = len(jset.group_times)
    B = NCHAINS * G
    rng = np.random.default_rng(5)
    sa = np.float32(np.sqrt(0.5) * np.sqrt(dims.nfreqs))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    rows = {"oa_re": f32(rng.standard_normal((K, B, dims.n, dims.t))) * sa,
            "oa_im": f32(rng.standard_normal((K, B, dims.n, dims.t))) * sa,
            "ob_re": f32(rng.standard_normal((K, B, dims.n, dims.t))) * hf,
            "ob_im": f32(rng.standard_normal((K, B, dims.n, dims.t))) * hf}
    rnd = tmc.grouped_randomness(
        rows, f32(rng.gamma(dims.ntimes - 1, size=(K, NCHAINS, dims.n))),
        f32(rng.uniform(size=(K, NCHAINS, 128))), G)
    ps0 = np.abs(rng.standard_normal((NCHAINS, NF))) * 10.0 + 0.5
    return jset, rnd, ps0


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    """The JAX grouped chunk and the JAX runner, run once: (run root,
    output arrays)."""
    root = tmp_path_factory.mktemp("jax_tflags")
    _, rnd, ps0 = chunk_inputs()
    d, fg, ninv = _baseline(np.random.default_rng(77))
    jobs = _jobs(trunner.BaselineJob, None)
    np.savez(root / "inputs.npz", nchains=NCHAINS, k=K, prior=_prior(),
             niter=NITER, seed=SEED, write=WRITE, c_d=d, c_fg=fg, c_ninv=ninv,
             c_flags=_flags(True), c_ps0=ps0,
             **{"c_" + k: v for k, v in rnd.items()},
             r_d=np.stack([j.d for j in jobs]),
             r_fg=np.stack([j.fgmodes for j in jobs]),
             r_ninv=np.stack([j.Ninv for j in jobs]),
             r_ps0=np.stack([j.S_initial for j in jobs]),
             r_flags=np.stack([j.flags_tf for j in jobs]))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(root)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, dict(np.load(root / "outputs.npz"))


# --- 2. one grouped chunk against the JAX kernel -----------------------------

def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-30)


@pytest.mark.parametrize("case", ["full", "lean", "warm_ns"])
def test_grouped_chunk_matches_jax(case, jax_out):
    jset, rnd, ps0 = chunk_inputs()
    prior = _prior()
    o = jax_out[1]
    ref = dict(ps_final=o["ps_final"], ps=o["ps"], ln_post=o["ln_post"],
               sig=o["sig_re"] + 1j * o["sig_im"],
               amp=o["amp_re"] + 1j * o["amp_im"], chisq=o["chisq"])
    kw = {"full": {}, "lean": {"store_cr": False},
          "warm_ns": {"warm_ns": 3, "drift_max": 10.0}}[case]
    tdims = tmega.MegaDims(*jset.dims)
    tset = tmc.tflags_setup_from_jax_arrays(
        _jax_arrays(jset.mops), tdims, jset.group_times, jset.group_idx, CPU)
    G = len(tset.group_times)
    static = tmc.prior_static_from(prior, tdims)
    assert len(static) == 3
    t_ps, t_s = tmc.run_chunk_megachain(
        tset.mops, tmc.make_chain_tables(tset.mops, CPU), tdims,
        tmega.pad_ps(ps0, tdims, CPU).repeat_interleave(G, dim=0), K,
        static, randomness=rnd, group_times=tset.group_times,
        group_idx=tset.group_idx, **kw)

    warm = case == "warm_ns"
    ps_tol = (dict(rtol=5e-4, atol=1e-7) if warm
              else dict(rtol=2e-4, atol=1e-6))
    np.testing.assert_allclose(t_s.ps.numpy(), ref["ps"], **ps_tol)
    for c in range(NCHAINS):            # every row carries its chain's ps
        for g in range(G):
            np.testing.assert_allclose(t_ps.numpy()[c * G + g],
                                       ref["ps_final"][c * G], **ps_tol)
    np.testing.assert_allclose(t_s.ln_post.numpy(), ref["ln_post"],
                               rtol=1e-3 if warm else 2e-3)
    if case == "lean":
        # pooled chi_t against the JAX full chi summed over the true times
        assert t_s.signal_cr is None and t_s.chisq.shape == (K, NCHAINS)
        want = ref["chisq"].sum(axis=(2, 3)) / (NF * NT)
        np.testing.assert_allclose(t_s.chisq.numpy(), want, rtol=5e-3,
                                   atol=1e-5)
        return
    sig = t_s.signal_cr.numpy()
    assert sig.shape == (K, NCHAINS, NT, NF)
    assert t_s.fg_amps.shape == (K, NCHAINS, NT, NM)
    for part in (np.real, np.imag):
        assert _rel(part(sig), part(ref["sig"])) < (1e-3 if warm else 5e-4)
        assert _rel(part(t_s.fg_amps.numpy()), part(ref["amp"])) < (
            1e-3 if warm else 5e-4)
    np.testing.assert_allclose(t_s.chisq.numpy(), ref["chisq"], rtol=5e-3,
                               atol=1e-5)


# --- 3. the grouped streams of the Philox twin -------------------------------

def _streams_row_omegas():
    """Row omegas are the row stream's plain draws, exactly 0 beyond the
    row's time count."""
    sids, sidc = philox.grouped_stream_ids(np.array([3, 8]), 4)
    assert sids.tolist() == [12, 13, 14, 15, 32, 33, 34, 35]
    assert sidc.tolist() == [3, 3, 3, 3, 8, 8, 8, 8]
    counts = torch.tensor([5, 4, 3, 0] * 2, dtype=torch.int32)
    st = torch.from_numpy(sids)
    oa, ob = philox.omega_fields(7, st, 11, 8, 16, 12, NF, counts)
    pa, pb = philox.omega_fields(7, st, 11, 8, 16, 16, NF)
    for r, c in enumerate(counts.tolist()):
        for got, plain in ((oa, pa), (ob, pb)):
            assert torch.all(got[r, :, c:] == 0)
            assert torch.equal(got[r, :, :c], plain[r, :, :c])
    with pytest.raises(ValueError, match="2\\^30"):
        philox.grouped_stream_ids(np.array([2 ** 28]), 4)


def _streams_chain_draws():
    """The G rows of a chain share gam and u_pb, drawn on the chain key
    sid + 2^30 from the pooled beta."""
    G, n = 4, 16
    sidc = torch.tensor([3] * G + [8] * G, dtype=torch.int32)
    beta = torch.rand((2 * G, n), generator=torch.Generator().manual_seed(2))
    beta[3::G] = 0.0                              # dummy rows add nothing
    tt = make_invgamma_table(NT)
    prior = trb.prior_bins(((6, 0.5, 300.0), (7, 1.0, 50.0)), CPU)
    tl, tq = torch.from_numpy(tt.log_y), torch.from_numpy(tt.q)
    ps, gam = trb.plain_bandpower(beta, prior, tl, tq, seed=9, sids=sidc,
                                  g=4, alpha=NT - 1, gam_out=True, group=G)
    for c in range(2):
        blk = slice(c * G, (c + 1) * G)
        assert torch.all(ps[blk] == ps[c * G]) and torch.all(
            gam[blk] == gam[c * G])
    keys = torch.tensor([3, 8], dtype=torch.int64) + philox.CHAIN_STREAM_OFFSET
    pooled = beta.view(2, G, n).sum(dim=1)
    want = trb.plain_bandpower(
        pooled, prior, tl, tq, gam=philox.gamma_draws(9, keys, 4, n, NT - 1),
        u_pb=philox.prior_uniforms(9, keys, 4))
    assert torch.allclose(ps[::G], want, rtol=1e-6)
    # external randomness is read from row c*G
    gx = gam.clone()
    gx[1::G] = float("nan")
    u = torch.rand((2 * G, 8), generator=torch.Generator().manual_seed(3))
    assert torch.equal(
        trb.plain_bandpower(beta, prior, tl, tq, gam=gx, u_pb=u, group=G),
        trb.plain_bandpower(beta, prior, tl, tq, gam=gam, u_pb=u, group=G))


def _streams_g1_is_plain():
    """G = 1 is plain mode bit for bit: row key = chain key = sid, and a
    one-group chunk equals the plain chunk."""
    sids, sidc = philox.grouped_stream_ids(np.array([4, 9]), 1)
    assert sids.tolist() == sidc.tolist() == [4, 9]
    beta = torch.rand((2, 16), generator=torch.Generator().manual_seed(4))
    tt = make_invgamma_table(NT)
    args = (trb.prior_bins(((6, 0.5, 300.0),), CPU),
            torch.from_numpy(tt.log_y), torch.from_numpy(tt.q))
    st = torch.from_numpy(sids)
    assert torch.equal(
        trb.plain_bandpower(beta, *args, seed=1, sids=st, g=2, alpha=NT - 1,
                            group=1),
        trb.plain_bandpower(beta, *args, seed=1, sids=st, g=2, alpha=NT - 1))
    rng = np.random.default_rng(6)
    d, fg, ninv = _baseline(rng)
    ops = trg.stack_chain_operators(
        [trg.build_chain_operators(d, np.ones(NF), fg, ninv)] * 2)
    mops, dims = tmega.from_chain_operators(ops, CPU)
    tables = tmc.make_chain_tables(mops, CPU)
    ps0 = tmega.pad_ps(np.abs(rng.standard_normal((2, NF))) + 1.0, dims, CPU)
    common = (mops, tables, dims, ps0, 2, ())
    a = tmc.run_chunk_megachain(*common, seed=5, sids=st, warm_ns=2)
    b = tmc.run_chunk_megachain(*common, seed=5, sids=st, warm_ns=2,
                                group_times=(NT,), sidc=sidc,
                                group_idx=(np.arange(NT),))
    assert torch.equal(a[0], b[0])
    for f in tmc.ChainSample._fields:
        assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f


def _streams_dummy_rows():
    """A zero-operator row has S = I, dinv = 1, and adds exactly 0 to beta,
    noise_nu and bmask."""
    P = timpl.PLAIN
    assert torch.equal(P.herm_inv(torch.eye(8, dtype=torch.complex64)[None]),
                       torch.eye(8, dtype=torch.complex64)[None])
    rng = np.random.default_rng(7)
    d, fg, ninv = _baseline(rng)
    mops, dims = tmega.from_chain_operators(
        trg.build_chain_operators(d, np.ones(NF), fg, ninv), CPU)
    zero = tmega.MegaOperators(**tmc._interleave([mops], 2), f=mops.f,
                               igt=mops.igt)
    n, t = dims.n, dims.t
    g = torch.Generator().manual_seed(8)
    om = lambda: torch.randn((2, n, t), generator=g, dtype=torch.complex64)
    ps = torch.full((2, n), 5.0)
    rt = torch.tensor([NT, 0], dtype=torch.int32)
    s, xs, dd, dinv = P.draw_system(zero.pt, ps, om(), om(), NT, NF, rt)
    assert torch.all(dinv[1] == 1.0) and torch.equal(
        s[1], torch.eye(n, dtype=torch.complex64))
    dr = draw_body(zero, ps, om(), om(), nfreqs=NF, ntimes=NT,
                   all_unflagged=False, row_times=rt, impl=P)
    for v in (dr.beta, dr.noise_nu, dr.bmask):
        assert torch.all(v[1] == 0.0) and torch.all(torch.isfinite(v))
    assert float(dr.beta[0].sum()) > 0.0


STREAMS = {f.__name__[9:]: f for f in (_streams_row_omegas,
                                       _streams_chain_draws,
                                       _streams_g1_is_plain,
                                       _streams_dummy_rows)}


@pytest.mark.parametrize("case", list(STREAMS))
def test_grouped_streams(case):
    STREAMS[case]()


# --- 4. the runner against the JAX runner ------------------------------------

def _jobs(job_cls, out_root, flags=True, nbl=NBL):
    """Baselines 0 and 2 share signature A (3 patterns, G = 4), 1 and 3
    signature B (2 patterns, G = 2)."""
    rng = np.random.default_rng(23)
    jobs = []
    for b in range(nbl):
        d, fg, ninv = _baseline(rng)
        ps0 = np.abs(rng.standard_normal(NF)) * 10.0 + 0.5
        jobs.append(job_cls(
            antpair=(0, b + 1), d=d, w=np.ones(NF), fgmodes=fg,
            S_initial=ps0, Ninv=ninv,
            out_dir=None if out_root is None else out_root / f"0-{b + 1}",
            flags_tf=(_flags(b % 2 == 0) if flags is True else flags)))
    return jobs


def jax_randomness():
    """The JAX runner's key schedule (runner.py:1014,
    models/megachain.py:551, :159-197), replayed in this process (plain
    XLA, no Pallas)."""
    import jax

    base = jax.random.key(SEED)
    dims = jmega.MegaDims(NF, NT, NM, 128, 128, 8, False)

    def randomness(done, k_total, *, sids, sidc, group):
        ck = jax.random.fold_in(
            jax.random.fold_in(base, 1_000_000 + done), 0)
        rnd = jmc.draw_chunk_randomness_tflags(ck, sids, sidc, group, dims,
                                               k_total, dims.ntimes - 1)
        return {k: np.asarray(v) for k, v in rnd.items()}

    return randomness


def _run(root, name, jobs=None, **kw):
    jobs = jobs or _jobs(trunner.BaselineJob, root / name)
    niter = kw.pop("niter", NITER)
    return jobs, trunner.run_baselines(
        jobs, _prior(), niter, device="cpu", seed=SEED, nchains=NCHAINS,
        write_niter=WRITE, **kw)


def case_matches_jax(tmp_path, jax_out):
    root, o = jax_out
    jobs, (res, tim) = _run(tmp_path, "port", randomness=jax_randomness())
    assert tim["engine"] == "megachain" and tim["batch"] == NBL * NCHAINS
    assert len(res) == o["run_signal_ps"].shape[0] == NBL * NCHAINS
    for r, ps, lnp in zip(res, o["run_signal_ps"], o["run_ln_post"]):
        np.testing.assert_allclose(r.signal_ps, ps, rtol=2e-3)
        np.testing.assert_allclose(r.ln_post, lnp, rtol=2e-3)
    for job in jobs:
        for c in range(NCHAINS):
            got = tio.load_samples(Path(job.out_dir) / f"chain-{c}")
            want = tio.load_samples(
                root / "run" / job.out_dir.name / f"chain-{c}")
            assert set(got) == set(want) == set(tio.SAMPLE_FILENAMES)
            for k in got:
                assert got[k].shape == want[k].shape, k
                assert np.isfinite(got[k]).all(), k


def case_resume(tmp_path, jax_out):
    full, _ = _run(tmp_path, "full")
    part, _ = _run(tmp_path, "part", niter=WRITE)
    run_dir = part[0].out_dir.parent
    for si in range(2):
        assert tio.load_checkpoint(run_dir, tag=f"-tf{si}")["iteration"] \
            == WRITE
    _, (res, tim) = _run(tmp_path, "part", jobs=part, resume=True)
    assert tim["start_iter"] == WRITE
    for jf, jp in zip(full, part):
        for c in range(NCHAINS):
            a = tio.load_samples(Path(jf.out_dir) / f"chain-{c}")
            b = tio.load_samples(Path(jp.out_dir) / f"chain-{c}")
            for k in tio.SAMPLE_FILENAMES:
                assert np.array_equal(a[k], b[k]), k


def case_subset(tmp_path, jax_out):
    _, (res_all, _) = _run(tmp_path, "all")
    one = _jobs(trunner.BaselineJob, None)[2:3]
    res_one, _ = trunner.run_baselines(
        one, _prior(), NITER, device="cpu", seed=SEED, nchains=NCHAINS,
        write_niter=WRITE, global_baseline_ids=[2])
    for c in range(NCHAINS):
        a, b = res_all[2 * NCHAINS + c], res_one[c]
        assert (a.antpair, a.chain) == (b.antpair, b.chain)
        for f in ("signal_ps", "signal_cr", "fg_amps", "chisq", "ln_post"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def case_all_false(tmp_path, jax_out):
    """All-False flags: one group, the plain streams and layout. Every
    sample is bit-identical; ln_post differs only in rounding, because the
    grouped setup marks itself flagged (as the JAX package does) and so
    takes bmask from F (w sig) instead of beta."""
    none = np.zeros((NT, NF), dtype=bool)
    _, (res_tf, _) = _run(tmp_path, "tf", jobs=_jobs(
        trunner.BaselineJob, None, flags=none))
    _, (res_pl, _) = _run(tmp_path, "plain", jobs=_jobs(
        trunner.BaselineJob, None, flags=None))
    for a, b in zip(res_tf, res_pl):
        for f in ("signal_ps", "signal_cr", "fg_amps", "chisq"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        np.testing.assert_allclose(a.ln_post, b.ln_post, rtol=1e-5)


def case_nine_patterns(tmp_path, jax_out):
    f = np.zeros((NT, NF), dtype=bool)
    for r in range(1, 9):
        f[r:, r] = True                               # 9 distinct rows
    assert len(ttf.group_flag_patterns(f)) == 9
    jobs = _jobs(trunner.BaselineJob, None, flags=f, nbl=1)
    # more than 8 patterns: the real engine's grouped path, as in JAX
    res, tim = trunner.run_baselines(jobs, _prior(), 2, device="cpu")
    assert tim["engine"] == "real"
    assert res[0].signal_cr.shape == (2, NT, NF)
    assert np.isfinite(res[0].signal_cr).all()


CASES = {f.__name__[5:]: f for f in (case_matches_jax, case_resume,
                                      case_subset, case_all_false,
                                      case_nine_patterns)}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_tflags(case, tmp_path, request):
    # only the JAX comparison needs the (module-wide, once) JAX runs
    jax_out = (request.getfixturevalue("jax_out")
               if case == "matches_jax" else None)
    CASES[case](tmp_path, jax_out)
