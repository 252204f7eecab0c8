"""The two row passes (``row_scale_sumsq``, ``draw_resid``) on the short
rows of the time-flags paths, against the JAX package:

* one grouped megachain chunk whose flag patterns give a group of one time
  and a group of five beside the unflagged six (G = 3 rows of t = 6 at the
  port's layout, time counts 6, 1 and 5), on external randomness, against
  the JAX grouped chunk in Pallas interpret mode (one subprocess, as
  tests/test_torch_tflags.py runs it), full and lean;
* the grouped real step (``hydra_pspec_tpu/models/tflags.py::
  gibbs_step_tflags_real``, ``solver="chol"``, no Pallas kernel) with the
  same one-time group, against the port's ``models/tflags.py`` on the JAX
  step's own draws;
* on the card (marked ``cuda``, skipped here): both kernels against their
  plain versions at ``chip_smoke.py``'s phase-3 widths, every variant.

On the CPU the wrappers take their plain versions, so the first two hold
the composition at the short rows' shapes (per-row time counts, a row of
one time) to the JAX package; the kernels' bits are held on the card
(``python3 chip_smoke.py``, and ``--rows`` against a parent checkout).
JAX is imported inside the CPU cases only, so the file collects on a
machine without it."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops.invgamma import make_invgamma_table
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
NT, NF, NM, NCH, K = 12, 16, 2, 2, 2
SEED = 20261018


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _flags():
    """Channel 3 flagged at time 5 alone (a group of one time), channel 8
    over times 7-11 (five): three patterns, the unflagged one six times
    (0-4 and 6)."""
    f = np.zeros((NT, NF), dtype=bool)
    f[5, 3] = True
    f[7:, 8] = True
    return f


def _baseline(b):
    rng = np.random.default_rng(SEED + b)
    return (_crandn(rng, NT, NF) * 2.0, _crandn(rng, NF, NM),
            np.abs(rng.standard_normal(NF)) + 1.0)


def _prior():
    """Three bounded bins."""
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 1: NF // 2 + 2] = 300.0
    prior[1, NF // 2 - 1: NF // 2 + 2] = 0.5
    return prior


def _groups(tfm=ttf, rgm=trg):
    """The grouped operators of NCH baselines under ``_flags``, stacked
    per group, by ``tfm``/``rgm`` (the port's modules or the JAX
    package's)."""
    per = []
    for b in range(NCH):
        d, fg, ninv = _baseline(b)
        per.append(tfm.build_grouped_operators_real(d, _flags(), fg, ninv))
    return [tfm.TimeGroupReal(
                ops=rgm.stack_chain_operators([p[g].ops for p in per]),
                idx=per[0][g].idx)
            for g in range(len(per[0]))]


# --- 1. a grouped megachain chunk against the JAX kernel ---------------------

# The JAX grouped chunk in interpret mode, in a fresh process with
# synchronous CPU dispatch (see tests/test_torch_tflags.py: interpret
# mode's callbacks can deadlock against asynchronous dispatch). It imports
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

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_tpu.models import tflags as jtf

root = Path(sys.argv[1])
z = dict(np.load(root / "inputs.npz"))
nch = int(z["nch"])
with pltpu.force_tpu_interpret_mode():
    per = [jtf.build_grouped_operators_real(z["d"][b], z["flags"],
                                            z["fg"][b], z["ninv"][b])
           for b in range(nch)]
    groups = [jtf.TimeGroupReal(
                  ops=jrg.stack_chain_operators([p[g].ops for p in per]),
                  idx=per[0][g].idx)
              for g in range(len(per[0]))]
    s = jmc.build_tflags_mega_setup(groups)
    ps_rows = jnp.repeat(jmega.pad_ps(jnp.asarray(z["ps0"], jnp.float32),
                                      s.dims), len(s.group_times), axis=0)
    rnd = {k: jnp.asarray(z[k]) for k in
           ("oa_re", "oa_im", "ob_re", "ob_im", "gam", "u_pb")}
    ps, smp = jmc.run_chunk_megachain(
        s.mops, jmc.make_chain_tables(s.mops), s.dims, ps_rows, int(z["k"]),
        jmc.prior_static_from(z["prior"], s.dims), randomness=rnd, refine=1,
        batch_tile=4, store_cr=True, group_times=s.group_times,
        group_idx=s.group_idx)
np.savez(root / "outputs.npz", ps_final=np.asarray(ps),
         ps=np.asarray(smp.ps), ln_post=np.asarray(smp.ln_post),
         sig_re=np.asarray(smp.signal_cr.re),
         sig_im=np.asarray(smp.signal_cr.im),
         amp_re=np.asarray(smp.fg_amps.re), amp_im=np.asarray(smp.fg_amps.im),
         chisq=np.asarray(smp.chisq), group_times=np.asarray(s.group_times))
"""

GJ = 4   # the JAX package's rows a chain: 3 patterns and a dummy row


@functools.lru_cache(maxsize=None)
def chunk_randomness():
    """K iterations of numpy randomness in the JAX layout (NCH chains x
    GJ rows of 128 x 128 lanes: per-row omegas, per-chain Gamma and
    uniforms), and the chains' starting bandpowers."""
    rng = np.random.default_rng(SEED + 7)
    B, n, t = NCH * GJ, 128, 128
    sa = np.float32(np.sqrt(0.5) * np.sqrt(NF))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    rows = {"oa_re": f32(rng.standard_normal((K, B, n, t))) * sa,
            "oa_im": f32(rng.standard_normal((K, B, n, t))) * sa,
            "ob_re": f32(rng.standard_normal((K, B, n, t))) * hf,
            "ob_im": f32(rng.standard_normal((K, B, n, t))) * hf}
    rnd = tmc.grouped_randomness(
        rows, f32(rng.gamma(NT - 1, size=(K, NCH, n))),
        f32(rng.uniform(size=(K, NCH, 128))), GJ)
    ps0 = np.abs(rng.standard_normal((NCH, NF))) * 10.0 + 0.5
    return rnd, ps0


@pytest.fixture(scope="module", autouse=True)
def jax_chunk_proc(tmp_path_factory):
    """The JAX grouped chunk, started once before the module's first case
    (so the grouped real step runs while it compiles): (process, its
    directory). Killed at the module's end if still running."""
    root = tmp_path_factory.mktemp("jax_row_passes")
    rnd, ps0 = chunk_randomness()
    ins = [_baseline(b) for b in range(NCH)]
    np.savez(root / "inputs.npz", nch=NCH, k=K, prior=_prior(),
             flags=_flags(), ps0=ps0, d=np.stack([x[0] for x in ins]),
             fg=np.stack([x[1] for x in ins]),
             ninv=np.stack([x[2] for x in ins]), **rnd)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(root)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, root
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_chunk(jax_chunk_proc):
    """The JAX grouped chunk's output arrays."""
    proc, root = jax_chunk_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(root / "outputs.npz"))


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-30)


# --- the grouped real step against the JAX step (runs while it compiles) ---

def _jax_step_draws(key, groups, npb):
    """The JAX grouped real step's draws (``tflags.py:216-276``) in the
    port's layout: per chain ``row_key = fold_in(key, sid)``; group g's
    omegas from ``split(fold_in(row_key, g))`` placed at the group's times;
    the pooled draw (``invgamma.py:223-257``, alpha <= 512) from
    ``fold_in(row_key, 999_983)`` at the total alpha."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops import cplx

    f32 = jnp.float32
    out = {k: [] for k in ("oa", "ob", "gam", "u_pb")}
    for sid in range(NCH):
        rk = jax.random.fold_in(key, sid)
        oa = np.zeros((NT, NF), np.complex64)
        ob = np.zeros((NT, NF), np.complex64)
        for g, grp in enumerate(groups):
            idx = np.asarray(grp.idx)
            ka, kb = jax.random.split(jax.random.fold_in(rk, g))
            za = cplx.standard_normal(ka, (idx.size, NF), dtype=f32)
            s = np.sqrt(NF).astype(np.float32)
            oa[idx] = np.asarray(za.re * s) + 1j * np.asarray(za.im * s)
            zb = cplx.standard_normal(kb, (idx.size, NF), dtype=f32)
            ob[idx] = np.asarray(zb.re) + 1j * np.asarray(zb.im)
        k_gamma, k_u = jax.random.split(jax.random.fold_in(rk, 999_983))
        u = jax.random.uniform(k_gamma, (NT - 1, NF), dtype=f32)
        out["gam"].append(np.asarray(-jnp.sum(
            jnp.log(jnp.maximum(u, jnp.finfo(f32).tiny)), axis=0)))
        out["u_pb"].append(np.asarray(jax.random.uniform(k_u, (npb,),
                                                         dtype=f32)))
        out["oa"].append(oa)
        out["ob"].append(ob)
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def test_grouped_real_step_one_time_group_matches_jax():
    """One step of the grouped real engine, whose row passes run on rows
    of 6, 1 and 5 times. Tolerances as tests/test_torch_rgibbs.py holds
    the real step: both sides are float32 Cholesky solvers with their own
    product orders, 3e-3 of the mean magnitude."""
    import jax
    import jax.numpy as jnp
    from hydra_pspec_tpu.models import rgibbs as jrg
    from hydra_pspec_tpu.models import tflags as jtf
    from hydra_pspec_tpu.ops.invgamma import make_invgamma_table as jtable

    tgroups = _groups()
    assert sorted(int(np.asarray(g.idx).size) for g in tgroups) == [1, 5, 6]
    jgroups = _groups(jtf, jrg)
    prior = _prior()
    prior_idx = np.nonzero(np.any(prior > 0, axis=0))[0]
    ps = np.abs(np.random.default_rng(SEED + 9).standard_normal(
        (NCH, NF))).astype(np.float32) * 10.0 + 0.5
    key = jax.random.fold_in(jax.random.key(SEED), 3)
    step = jax.jit(lambda k, p: jtf.gibbs_step_tflags_real(
        k, p, jgroups, jnp.asarray(prior, jnp.float32),
        prior_idx=jnp.asarray(prior_idx), solver="chol",
        igt_total=jtable(NT)))
    ps_j, s_j = step(key, jnp.asarray(ps))

    table = make_invgamma_table(NT)
    ps_t, s_t = ttf.gibbs_step_tflags_real(
        ttf.to_device(tgroups, CPU), torch.from_numpy(ps),
        trb.prior_bins(trb.bounded_bins(prior), CPU),
        torch.from_numpy(np.asarray(table.log_y)),
        torch.from_numpy(np.asarray(table.q)),
        _jax_step_draws(key, tgroups, prior_idx.size), solver="chol")
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), rtol=2e-3,
                               atol=1e-6)
    sig_j = np.asarray(s_j.signal_cr.re) + 1j * np.asarray(s_j.signal_cr.im)
    assert _rel(s_t.signal_cr.numpy(), sig_j) < 3e-3
    chi_j = np.asarray(s_j.chisq)
    assert np.abs(s_t.chisq.numpy() - chi_j).max() < 3e-2 * chi_j.mean()
    np.testing.assert_allclose(s_t.ln_post.numpy(), np.asarray(s_j.ln_post),
                               rtol=2e-3)


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_grouped_chunk_short_rows_match_jax(lean, jax_chunk):
    """The port's layout (rows of t = 6 with counts 6, 1, 5) against the
    JAX chunk (rows of 128 lanes, G = 4 with a dummy row). Tolerances as
    tests/test_torch_tflags.py holds the grouped chunk: both sides are
    float32 with their own product orders (XLA against torch.matmul),
    carried through K = 2 iterations and the bandpower draw."""
    o = jax_chunk
    s = tmc.build_tflags_mega_setup(_groups(), CPU)
    G = len(s.group_times)
    assert (G, s.dims.n, s.dims.t) == (3, NF, 6)
    assert sorted(s.group_times) == [1, 5, 6]
    assert s.group_times == tuple(o["group_times"][:G].tolist())
    rnd, ps0 = chunk_randomness()
    keep = [c * GJ + g for c in range(NCH) for g in range(G)]
    rows = {k: v[:, keep] for k, v in rnd.items()}
    t_ps, t_s = tmc.run_chunk_megachain(
        s.mops, tmc.make_chain_tables(s.mops, CPU), s.dims,
        tmega.pad_ps(ps0, s.dims, CPU).repeat_interleave(G, dim=0), K,
        tmc.prior_static_from(_prior(), s.dims), randomness=rows,
        group_times=s.group_times, group_idx=s.group_idx,
        store_cr=not lean)

    ps_tol = dict(rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(t_s.ps.numpy(), o["ps"], **ps_tol)
    for c in range(NCH):          # every row carries its chain's ps
        for g in range(G):
            np.testing.assert_allclose(t_ps.numpy()[c * G + g, :NF],
                                       o["ps_final"][c * GJ, :NF], **ps_tol)
    np.testing.assert_allclose(t_s.ln_post.numpy(), o["ln_post"], rtol=2e-3)
    if lean:   # chi_t pooled over each row's own times
        assert t_s.signal_cr is None and t_s.chisq.shape == (K, NCH)
        want = o["chisq"].sum(axis=(2, 3)) / (NF * NT)
        np.testing.assert_allclose(t_s.chisq.numpy(), want, rtol=5e-3,
                                   atol=1e-5)
        return
    sig = t_s.signal_cr.numpy()
    assert sig.shape == (K, NCH, NT, NF)
    for part in (np.real, np.imag):
        assert _rel(part(sig), part(o["sig_re"] + 1j * o["sig_im"])) < 5e-4
        assert _rel(part(t_s.fg_amps.numpy()),
                    part(o["amp_re"] + 1j * o["amp_im"])) < 5e-4
    np.testing.assert_allclose(t_s.chisq.numpy(), o["chisq"], rtol=5e-3,
                               atol=1e-5)


# --- 3. on the card: the kernels against their plain versions ----------------

@pytest.mark.cuda
def test_row_kernels_on_card():
    """Both row kernels against their plain versions on the card at every
    width of phase 3 (t in ``chip_smoke.ROW_TS``, n in ``ROW_NS``), every
    variant of ``chip_smoke.row_pass_variants`` (scales and ``y`` present
    and absent; each optional output of ``draw_resid``; ragged
    ``row_times``), within 1e-5 of the largest plain output, as
    ``chip_smoke.py`` holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from hydra_pspec_torch.ops.kernels import impl

    dev = torch.device("cuda", 0)
    for n in chip_smoke.ROW_NS:
        for t in chip_smoke.ROW_TS:
            for what, kernel, fn in chip_smoke.row_pass_variants(dev, n, t):
                for g, w in zip(fn(impl.KERNELS), fn(impl.PLAIN)):
                    assert (g is None) == (w is None), (kernel, n, t, what)
                    if w is not None:
                        err = float((g - w).abs().max())
                        assert err <= 1e-5 * float(w.abs().max()), (
                            kernel, n, t, what, err)
