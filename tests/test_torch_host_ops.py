"""The port's host-side build (numpy, float64 inside) against the JAX
package's: the same float64 numpy, so the arrays must be exactly equal."""
import re
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hydra_pspec_tpu import runner as jrunner
from hydra_pspec_tpu.cli import run as jcli
from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_tpu.ops import invgamma as jig
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.cli import run as tcli
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.ops import invgamma as tig

CPU = torch.device("cpu")
PORT = Path(__file__).resolve().parents[1] / "hydra_pspec_torch"


def _inputs(seed, ntimes=12, nfreqs=20, nmodes=3, flag=True):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((ntimes, nfreqs))
         + 1j * rng.standard_normal((ntimes, nfreqs))) * 3.0
    w = np.ones(nfreqs)
    if flag:
        w[[2, 7, 8]] = 0.0
    fg = tcli.legendre_fgmodes(nfreqs, nmodes) * (1.0 + 0.1j)
    ninv = np.abs(rng.standard_normal(nfreqs)) + 0.5
    return d, w, fg, ninv


def _c(z):
    """A JAX C pair or array -> complex/real numpy."""
    if hasattr(z, "re"):
        re = np.asarray(z.re)
        out = np.empty(re.shape, np.result_type(re.dtype, np.complex64))
        out.real, out.imag = re, np.asarray(z.im)
        return out
    return np.asarray(z)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def case_chain_operators():
    d, w, fg, ninv = _inputs(1)
    j = jrg.build_chain_operators(d, w, fg, ninv)
    t = trg.build_chain_operators(d, w, fg, ninv)
    for f in ("d_w", "w", "f", "ni_diag", "nih_diag", "ninv_full_diag",
              "fg", "ni_d", "a0", "p_tilde", "g_mat", "maa_inv"):
        _equal(getattr(t, f), _c(getattr(j, f)), f)
    for f in ("log_y", "q", "alpha"):
        _equal(getattr(t.igt, f), np.asarray(getattr(j.igt, f)), f)
    assert t.ni_dense is None and t.nih_dense is None
    # a dense Ninv builds (the real engine's path, pinned field for field
    # in tests/test_torch_rgibbs.py); the mega layout refuses it, as the
    # JAX package's does
    dense = trg.build_chain_operators(d, w, fg, np.diag(ninv) + 0.01)
    assert dense.ni_dense is not None
    with pytest.raises(NotImplementedError, match="real engine"):
        tmega.from_chain_operators(dense, CPU)


def case_mega_operators():
    jl, tl = [], []
    for s in (2, 3):
        d, w, fg, ninv = _inputs(s, flag=(s == 3))
        jl.append(jrg.build_chain_operators(d, w, fg, ninv))
        tl.append(trg.build_chain_operators(d, w, fg, ninv))
    jm, jd = jmega.from_chain_operators(jrg.stack_chain_operators(jl))
    tm, td = tmega.from_chain_operators(trg.stack_chain_operators(tl), CPU,
                                        layout="jax")
    assert tuple(td) == tuple(jd)
    got = tm.to_numpy()
    for f in jm._fields:
        if f != "igt":
            _equal(got[f], np.asarray(getattr(jm, f)), f)
    # the round trip through the JAX layout is exact too
    back = tmega.from_jax_arrays(got, td, CPU).to_numpy()
    for f, v in got.items():
        _equal(back[f], v, f)
    ps = np.abs(np.random.default_rng(4).standard_normal((2, td.nfreqs)))
    _equal(tmega.pad_ps(ps, td, CPU).numpy(),
           np.asarray(jmega.pad_ps(ps.astype(np.float32), jd)), "pad_ps")


def case_tables_and_prior():
    for alpha in (12, 203):
        jt, tt = jig.make_invgamma_table(alpha), tig.make_invgamma_table(alpha)
        for f in ("log_y", "q", "alpha"):
            _equal(getattr(tt, f), np.asarray(getattr(jt, f)), f)
    d, w, fg, ninv = _inputs(5)
    jm, jd = jmega.from_chain_operators(
        jrg.build_chain_operators(d, w, fg, ninv))
    tm, td = tmega.from_chain_operators(
        trg.build_chain_operators(d, w, fg, ninv), CPU)
    jtab, ttab = jmc.make_chain_tables(jm), tmc.make_chain_tables(tm, CPU)
    for row in range(8):
        _equal(ttab.tlog.numpy(), np.asarray(jtab.tlog8)[row], "tlog")
        _equal(ttab.q.numpy(), np.asarray(jtab.q8)[row], "q")
    cfg = SimpleNamespace(ps_prior_lo=0.3, ps_prior_hi=4e3,
                          n_ps_prior_bins=3)
    prior = tcli.build_prior(cfg, 20)
    _equal(prior, jcli.build_prior(cfg, 20), "build_prior")
    assert tmc.prior_static_from(prior, td) == jmc.prior_static_from(
        prior, jd)
    assert tmc.prior_static_from(prior, td)[0] == (7, 0.3, 4e3)
    _equal(tcli.legendre_fgmodes(20, 4), jcli.legendre_fgmodes(20, 4),
           "legendre")
    S = np.eye(20) * 2.0 + 0.1
    _equal(trunner._initial_ps_host(S, 20), jrunner._initial_ps_host(S, 20),
           "initial_ps matrix")
    v = np.linspace(-1.0, 3.0, 20)
    _equal(trunner._initial_ps_host(v, 20), jrunner._initial_ps_host(v, 20),
           "initial_ps vector")


def case_imports_without_jax():
    """The port imports, and runs its CPU path, with jax and the JAX
    package blocked, and with h5py and yaml blocked too, as on the card's
    machine: its CLI module imports and ``RunConfig.from_dict`` runs. No
    module of it, and not chip_smoke.py, names jax or the JAX package, and
    none imports h5py or yaml at module level (the git-ignored kernel
    build directory is not part of the package)."""
    imp = re.compile(r"^\s*(import|from)\s+(jax|hydra_pspec_tpu)\b", re.M)
    top = re.compile(r"^(import|from)\s+(h5py|yaml)\b", re.M)
    sources = [p for p in PORT.rglob("*.py")
               if "_build" not in p.relative_to(PORT).parts[:-1]]
    for p in sources + [PORT.parent / "chip_smoke.py"]:
        assert not imp.search(p.read_text()), p
        assert not top.search(p.read_text()), p
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "hydra_pspec_tpu", "h5py", "yaml"):
            sys.modules[name] = None
        import numpy as np, torch
        from hydra_pspec_torch.cli import run as cli
        from hydra_pspec_torch.utils.config import RunConfig
        cfg = RunConfig.from_dict({"Niter": 3, "engine": "megachain"})
        assert cfg.Niter == 3 and cli.build_prior(cfg, 12).shape == (2, 12)
        from hydra_pspec_torch.runner import BaselineJob, run_baselines
        rng = np.random.default_rng(0)
        d = rng.standard_normal((6, 12)) + 1j * rng.standard_normal((6, 12))
        job = BaselineJob((0, 1), d, np.ones(12),
                          np.ones((12, 1), complex), np.ones(12), np.ones(12))
        res, tim = run_baselines([job], np.zeros((2, 12)), 2, device="cpu",
                                 seed=1, write_niter=1)
        assert np.isfinite(res[0].signal_ps).all(), res[0].signal_ps
        for name in ("jax", "h5py", "yaml"):
            assert sys.modules[name] is None, name
        print("ok", tim["engine"])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok megachain"


def case_gelman_rubin_and_io():
    """gelman_rubin equals the JAX runner's; files and checkpoints written by
    the port read back through the JAX package's io, and the reverse."""
    from hydra_pspec_tpu.utils import io as jio
    from hydra_pspec_torch.utils import io as tio

    chains = np.random.default_rng(5).gamma(3.0, size=(3, 41, 6))
    _equal(trunner.gelman_rubin(chains), jrunner.gelman_rubin(chains),
           "gelman_rubin")
    assert tio.SAMPLE_FILENAMES == jio.SAMPLE_FILENAMES
    rng = np.random.default_rng(6)
    arrs = [rng.standard_normal(s) for s in
            ((4, 5, 6), (6, 6), (4, 6), (4, 5, 2), (4, 5, 6), (4,))]
    with tempfile.TemporaryDirectory() as tmp:
        for w_io, r_io, sub in ((tio, jio, "port"), (jio, tio, "jax")):
            d = Path(tmp) / sub
            w_io.write_numpy_files(d, *arrs)
            got = r_io.load_samples(d)
            for key, want in zip(("signal_cr", "signal_S", "signal_ps",
                                  "fg_amps", "chisq", "ln_post"), arrs):
                np.testing.assert_array_equal(got[key], want)
            w_io.save_checkpoint(d, iteration=7, ps=arrs[2],
                                 key_data=np.arange(2), extra={"a": 1})
            ck = r_io.load_checkpoint(d)
            assert ck["iteration"] == 7 and ck["extra"] == {"a": 1}
            np.testing.assert_array_equal(ck["ps"], arrs[2])
        f = Path(tmp) / "port" / "dps-eor.npy"
        tio.add_mtime_to_filepath(f)
        assert not f.exists()
        assert len(list(f.parent.glob("dps-eor-*.npy"))) == 1


CASES = {f.__name__[5:]: f for f in (case_chain_operators,
                                      case_mega_operators,
                                      case_tables_and_prior,
                                      case_gelman_rubin_and_io,
                                      case_imports_without_jax)}


@pytest.mark.parametrize("case", list(CASES))
def test_host_build_matches_jax(case):
    CASES[case]()
