"""The chain layout at the data's own widths (``models/mega.py``
``layout_dims``): the port's layout against the JAX package's.

* ``from_chain_operators`` at the port's layout equals the JAX package's
  build cut to its widths, and that build's pads beyond are zero; the
  grouped setup keeps G = the flag-pattern count, each row the JAX
  layout's row of its group, with the row streams ``sid*G_key + g``.
* A megachain chunk (plain; grouped with 3 flag patterns of unequal
  length), a mega step and a chunk whose JAX-layout n goes past one
  ``split_at`` block, each on the Philox streams, match the same run at
  the JAX package's layout (``layout="jax"``, which the other pins hold
  against the JAX package) on every real lane. On the CPU every kernel takes its
  plain version, and ``plain_cgemm`` is ``torch.matmul``, whose blocking
  and so whose last bits depend on the size: the tolerance is relative,
  1e-4 on the sample fields after 4 iterations (on the card the two
  layouts give equal bits: ``chip_smoke.py``'s layout phase).
* A checkpoint written by a run at the JAX layout resumes at the port's
  layout: the checkpoint holds the state at the true widths only.

Small shapes: 20 channels x 37 times, 3 modes, K = 4, and 130 channels
for the blocked case."""
import functools

import numpy as np
import pytest
import torch

from hydra_pspec_tpu.models import mega as jmega
from hydra_pspec_tpu.models import megachain as jmc
from hydra_pspec_tpu.models import rgibbs as jrg
from hydra_pspec_tpu.models import tflags as jtf
from hydra_pspec_torch import runner as trunner
from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.utils import io as tio

CPU = torch.device("cpu")
NT, NF, NM, K, NCH = 37, 20, 3, 4, 2
SEED = 20261018
RTOL = 1e-4


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def _baseline(rng, nf=NF, nt=NT):
    return (_crandn(rng, nt, nf) * 2.0, _crandn(rng, nf, NM),
            np.abs(rng.standard_normal(nf)) + 1.0)


def _prior(nf=NF):
    prior = np.zeros((2, nf))
    prior[0, nf // 2 - 1: nf // 2 + 2] = 400.0
    prior[1, nf // 2 - 1: nf // 2 + 2] = 0.2
    return prior


def _flags():
    """3 flag patterns of unequal length: 15, 12 and 10 times."""
    f = np.zeros((NT, NF), dtype=bool)
    f[15:27, 4] = True
    f[27:, 11:13] = True
    return f


@functools.lru_cache(maxsize=None)
def ops_list(nf=NF, flag=True):
    rng = np.random.default_rng(11 + nf)
    out = []
    for b in range(NCH):
        d, fg, ninv = _baseline(rng, nf)
        w = np.ones(nf)
        if flag and b == 1:
            w[[3, 7]] = 0.0
        out.append((d, w, fg, ninv))
    return out


def _cut(x, shape):
    return x[tuple(slice(0, k) for k in shape)]


def _c(z):
    """A JAX (re, im) pair field as complex numpy."""
    return np.asarray(z)


def test_operators_are_the_jax_build_cut():
    ins = ops_list()
    jm, jd = jmega.from_chain_operators(jrg.stack_chain_operators(
        [jrg.build_chain_operators(*x) for x in ins]))
    tm, td = tmega.from_chain_operators(trg.stack_chain_operators(
        [trg.build_chain_operators(*x) for x in ins]), CPU)
    assert (td.n, td.t, td.m) == (NF, NT + 1, NM)
    assert (jd.n, jd.t, jd.m) == (128, 128, 8)
    assert tuple(td)[:3] == tuple(jd)[:3]
    assert td.all_unflagged == jd.all_unflagged
    got, want = tm.to_numpy(), {f: np.asarray(getattr(jm, f))
                                for f in jm._fields if f != "igt"}
    for f, v in got.items():
        if f.startswith("igt"):
            continue
        w = want[f]
        np.testing.assert_array_equal(v, _cut(w, v.shape), err_msg=f)
        pad = w.copy()
        pad[tuple(slice(0, k) for k in v.shape)] = 0
        assert not pad.any(), f"{f}: the JAX build's pads are not zero"
    # the port's one pad lane (t even) is zero too
    assert not tm.nid[:, :, NT:].any() and not tm.dw[:, :, NT:].any()
    assert not tm.a0[:, :, NT:].any()


def test_grouped_setup_rows_and_streams():
    d, fg, ninv = _baseline(np.random.default_rng(3))
    flags = _flags()
    groups = lambda mod, tfm: [
        tfm.TimeGroupReal(ops=mod.stack_chain_operators([g.ops] * NCH),
                          idx=g.idx)
        for g in tfm.build_grouped_operators_real(d, flags, fg, ninv)]
    jset = jmc.build_tflags_mega_setup(groups(jrg, jtf))
    tset = tmc.build_tflags_mega_setup(groups(trg, ttf), CPU)
    times = tuple(int(np.asarray(i).size) for i in tset.group_idx)
    assert sorted(times) == [10, 12, 15]
    assert tset.group_times == times and len(jset.group_times) == 4
    G, GJ = 3, 4
    assert (tset.dims.n, tset.dims.t, tset.dims.m) == (NF, 16, NM)
    got = tset.mops.to_numpy()
    for f, v in got.items():
        if f.startswith("igt") or f.startswith("f_"):
            continue
        w = np.asarray(getattr(jset.mops, f))
        w = w.reshape((NCH, GJ) + w.shape[1:])
        v = v.reshape((NCH, G) + v.shape[1:])
        np.testing.assert_array_equal(v, _cut(w, v.shape), err_msg=f)
        assert not w[:, G:].any(), f"{f}: JAX dummy rows not zero"
    # the row streams: sid * G_key + g, the JAX layout's ids of real rows
    rows, chains = philox.grouped_stream_ids([5, 9], G)
    rows_j, chains_j = philox.grouped_stream_ids([5, 9], GJ)
    np.testing.assert_array_equal(rows, rows_j.reshape(2, GJ)[:, :G].ravel())
    np.testing.assert_array_equal(chains, [5, 5, 5, 9, 9, 9])
    assert philox.key_group(3) == 4 and philox.key_group(8) == 8


def _fields(ps_final, sample, nf, every=1):
    out = {"ps_final": ps_final[::every, :nf]}
    out.update({k: v for k, v in sample._asdict().items() if v is not None})
    return out


def _close(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        assert x.shape == y.shape, k
        scale = float(torch.abs(y).max()) or 1.0
        err = float(torch.abs(x - y).max()) / scale
        assert err <= RTOL, (k, err)


def _chain(nf, layout, lean=False):
    ins = ops_list(nf, flag=nf == NF)
    mops, dims = tmega.from_chain_operators(trg.stack_chain_operators(
        [trg.build_chain_operators(*x) for x in ins]), CPU, layout=layout)
    ps = tmega.pad_ps(np.abs(np.random.default_rng(2).standard_normal(
        (NCH, nf))) * 10 + 0.5, dims, CPU)
    ps_f, smp = tmc.run_chunk_megachain(
        mops, tmc.make_chain_tables(mops, CPU), dims, ps, K,
        tmc.prior_static_from(_prior(nf), dims), seed=SEED,
        sids=[3, 4], iter0=7, warm_ns=3, drift_max=0.6, store_cr=not lean)
    return _fields(ps_f, smp, nf), dims


def _grouped(layout):
    d, fg, ninv = _baseline(np.random.default_rng(3))
    groups = [ttf.TimeGroupReal(ops=trg.stack_chain_operators([g.ops] * NCH),
                                idx=g.idx)
              for g in ttf.build_grouped_operators_real(d, _flags(), fg,
                                                        ninv)]
    s = tmc.build_tflags_mega_setup(groups, CPU, layout=layout)
    G = len(s.group_times)
    rows, chains = philox.grouped_stream_ids([3, 4], G)
    ps = tmega.pad_ps(np.abs(np.random.default_rng(2).standard_normal(
        (NCH, NF))) * 10 + 0.5, s.dims, CPU).repeat_interleave(G, dim=0)
    ps_f, smp = tmc.run_chunk_megachain(
        s.mops, tmc.make_chain_tables(s.mops, CPU), s.dims, ps, K,
        tmc.prior_static_from(_prior(), s.dims), seed=SEED, sids=rows,
        sidc=chains, iter0=7, warm_ns=3, drift_max=0.6,
        group_times=s.group_times, group_idx=s.group_idx)
    return _fields(ps_f, smp, NF, every=G), s.dims


def _mega(layout):
    ins = ops_list()
    mops, dims = tmega.from_chain_operators(trg.stack_chain_operators(
        [trg.build_chain_operators(*x) for x in ins]), CPU, layout=layout)
    tables = tmc.make_chain_tables(mops, CPU)
    ps = tmega.pad_ps(np.abs(np.random.default_rng(2).standard_normal(
        (NCH, NF))) * 10 + 0.5, dims, CPU)
    ps_f, smp = tmega.run_chain_mega(
        mops, dims, ps, trb.prior_bins(trb.bounded_bins(_prior()), CPU), 2,
        tables.tlog, tables.q, seed=SEED,
        sids=torch.tensor([3, 4], dtype=torch.int32), iter0=7)
    return _fields(ps_f, smp, NF), dims


RUNS = {
    "plain": functools.partial(_chain, NF),
    "plain lean": functools.partial(_chain, NF, lean=True),
    "grouped G=3": _grouped,
    "mega": _mega,
    # 130 channels, n = 130 against the JAX layout's 256 (on the card one
    # herm_inv launch against the blocked route, split at 192)
    "blocked n=130": functools.partial(_chain, 130),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_real_lanes_match_the_jax_layout(case):
    (port, dp), (jax_, dj) = RUNS[case]("port"), RUNS[case]("jax")
    assert dp.n == dp.nfreqs and dp.m == dp.nmodes and dp.t % 2 == 0
    assert dj.n % 128 == 0 and dj.t % 128 == 0 and dj.n > dp.n
    _close(port, jax_)


def _jobs(root, name):
    rng = np.random.default_rng(29)
    jobs = []
    for b in range(NCH):
        d, fg, ninv = _baseline(rng)
        jobs.append(trunner.BaselineJob(
            antpair=(0, b + 1), d=d, w=np.ones(NF), fgmodes=fg,
            S_initial=np.abs(rng.standard_normal(NF)) * 10 + 0.5, Ninv=ninv,
            out_dir=root / name / f"0-{b + 1}"))
    return jobs


def _run(jobs, niter, **kw):
    return trunner.run_baselines(jobs, _prior(), niter, device="cpu",
                                 seed=SEED, write_niter=3, engine="megachain",
                                 **kw)


def test_checkpoint_from_the_jax_layout_resumes(tmp_path, monkeypatch):
    """A run at the JAX layout stopped at 3 iterations, resumed at the
    port's for 3 more, continues as the port's own 6-iteration run: the
    checkpoint holds (baselines, nfreqs) bandpowers, no layout."""
    full = _jobs(tmp_path, "full")
    _run(full, 6)
    part = _jobs(tmp_path, "part")
    build = tmega.from_chain_operators
    with monkeypatch.context() as m:
        m.setattr(trunner.mega, "from_chain_operators",
                  functools.partial(build, layout="jax"))
        _run(part, 3)
    ck = tio.load_checkpoint(part[0].out_dir.parent)
    assert ck["iteration"] == 3 and ck["ps"].shape == (NCH, NF)
    _, tim = _run(part, 6, resume=True)
    assert tim["start_iter"] == 3
    for jf, jp in zip(full, part):
        a, b = tio.load_samples(jf.out_dir), tio.load_samples(jp.out_dir)
        for k in tio.SAMPLE_FILENAMES:
            x, y = np.asarray(b[k]), np.asarray(a[k])
            assert x.shape == y.shape, k
            assert np.abs(x - y).max() <= RTOL * np.abs(y).max(), k
