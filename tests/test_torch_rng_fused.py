"""The keyed omegas of ``draw_rhs`` and ``draw_system``: a draw, a
megachain chunk and a mega step keyed on (seed, stream ids, iteration)
equal, bit for bit, the same draw fed the fields of
``philox.omega_fields`` (and, for the chunk and the step, the Gamma and
prior-uniform words of the same streams) as external randomness. On the
CPU every kernel wrapper takes its plain version; the card-side test holds
the keyed kernels against their stored mode and the ``bandpower`` kernel
against its plain version. The stored mode itself is pinned against the
JAX package in tests/test_torch_megachain.py and tests/test_torch_mega.py.

The problem is small: 12 times x 16 channels, 2 foreground modes, at the
engines' layout (the data's own widths, n = 16, t = 12)."""
import functools

import numpy as np
import pytest
import torch

from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.kernels import draw_fused as tdf
from hydra_pspec_torch.ops.kernels import impl as timpl
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.ops.kernels.megachain import gcr_megachain
from hydra_pspec_torch.ops.kernels.megastep import draw_body

CPU = torch.device("cpu")
NT, NF, NM = 12, 16, 2
SEED = 20261017


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


@functools.lru_cache(maxsize=None)
def problem(batch: int):
    """``batch`` chains' mega operators (chain 1 with two flagged
    channels), their padded bandpowers and the 3-bin prior."""
    rng = np.random.default_rng(5)
    ins = []
    for b in range(batch):
        w = np.ones(NF)
        if b == 1:
            w[[2, 9]] = 0.0
        ins.append((_crandn(rng, NT, NF) * 2.0, w, _crandn(rng, NF, NM),
                    np.abs(rng.standard_normal(NF)) + 1.0))
    mops, dims = tmega.from_chain_operators(trg.stack_chain_operators(
        [trg.build_chain_operators(*x) for x in ins]), CPU)
    ps = tmega.pad_ps(np.abs(rng.standard_normal((batch, NF))) * 10 + 0.1,
                      dims, CPU)
    prior = np.zeros((2, NF))
    prior[0, NF // 2 - 1: NF // 2 + 2] = 400.0
    prior[1, NF // 2 - 1: NF // 2 + 2] = 0.2
    return mops, dims, ps, tmc.prior_static_from(prior, dims)


def _equal(a, b):
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)


def _draw_keyed_vs_fields(row_times):
    mops, dims, ps, _ = problem(4)
    B, n, t = mops.nid.shape
    sids = torch.tensor([3, 0, 7, 12], dtype=torch.int32)
    rt = None if row_times is None else torch.tensor(row_times,
                                                     dtype=torch.int32)
    key = tdf.OmegaKey(SEED, sids, 5)
    oa, ob = philox.omega_fields(SEED, sids, 5, n, t, dims.ntimes,
                                 dims.nfreqs, rt)
    kw = dict(nfreqs=dims.nfreqs, ntimes=dims.ntimes,
              all_unflagged=dims.all_unflagged, row_times=rt,
              impl=timpl.PLAIN)
    for lean in (False, True):
        want = draw_body(mops, ps, oa, ob, lean=lean, **kw)
        got = draw_body(mops, ps, None, None, key=key, lean=lean, **kw)
        _equal(got, want)
    # the kernel wrappers' CPU route: the same plain versions
    got = draw_body(mops, ps, None, None, key=key, **dict(
        kw, impl=timpl.KERNELS))
    _equal(got, draw_body(mops, ps, oa, ob, **kw))
    rc = tdf.draw_rhs(mops.nid, mops.nih, None, dims.ntimes, rt, key)
    assert torch.equal(rc, tdf.plain_draw_rhs(mops.nid, mops.nih, ob,
                                              dims.ntimes, rt))
    if rt is not None:   # lanes past a row's count carry no omega
        for r, c in enumerate(row_times):
            assert torch.all(oa[r, :, c:] == 0)
            assert torch.all(ob[r, :, c:] == 0)


def case_draw_plain():
    _draw_keyed_vs_fields(None)


def case_draw_row_times():
    _draw_keyed_vs_fields([NT, 7, 0, 3])


def case_draw_needs_one_source():
    mops, dims, ps, _ = problem(4)
    with pytest.raises(ValueError):
        draw_body(mops, ps, None, None, nfreqs=dims.nfreqs,
                  ntimes=dims.ntimes, all_unflagged=False)
    key = tdf.OmegaKey(SEED, torch.arange(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        tdf.draw_rhs(mops.nid, mops.nih, mops.nid, dims.ntimes, key=key)


def _stream_randomness(sids, g0, K, dims, nbins, row_times=None,
                       chain_keys=None):
    """External randomness holding the streams' own draws: omegas on the
    row streams ``sids``, Gamma and prior uniforms on ``chain_keys`` (one
    per row; default ``sids``)."""
    n, t = dims.n, dims.t
    ck = sids if chain_keys is None else chain_keys
    per = []
    for k in range(K):
        oa, ob = philox.omega_fields(SEED, sids, g0 + k, n, t, dims.ntimes,
                                     dims.nfreqs, row_times)
        per.append(dict(
            oa=oa, ob=ob,
            gam=philox.gamma_draws(SEED, ck, g0 + k, n, dims.ntimes - 1),
            u_pb=philox.prior_uniforms(SEED, ck, g0 + k, nbins)))
    return {name: torch.stack([p[name] for p in per]) for name in per[0]}


def case_megachain_chunk():
    mops, dims, ps, static = problem(2)
    tables = tmc.make_chain_tables(mops, CPU)
    prior = trb.prior_bins(static, CPU)
    sids = torch.tensor([4, 1], dtype=torch.int32)
    kw = dict(nfreqs_true=dims.nfreqs, ntimes_true=dims.ntimes,
              alpha_int=dims.ntimes - 1, all_unflagged=dims.all_unflagged,
              prior=prior, warm_ns=2, drift_max=10.0, impl=timpl.PLAIN)
    for lean in (False, True):
        keyed = gcr_megachain(mops, tables.tlog, tables.q, ps, 2, seed=SEED,
                              sids=sids, iter0=3, lean=lean, **kw)
        fed = gcr_megachain(mops, tables.tlog, tables.q, ps, 2,
                            randomness=_stream_randomness(sids, 3, 2, dims,
                                                          len(static)),
                            lean=lean, **kw)
        _equal(keyed, fed)


def case_megachain_grouped():
    """Two chains of G = 2 rows: omegas on the row streams at each row's
    time count, the bandpower draw on the chain streams sid + 2^30."""
    mops, dims, ps, static = problem(4)
    tables = tmc.make_chain_tables(mops, CPU)
    prior = trb.prior_bins(static, CPU)
    rows, chains = philox.grouped_stream_ids([6, 2], 2)
    sids, sidc = torch.from_numpy(rows), torch.from_numpy(chains)
    rt = torch.tensor([9, 3, NT, 0], dtype=torch.int32)
    ps = ps[[0, 0, 1, 1]].contiguous()   # a chain's rows share its ps
    kw = dict(nfreqs_true=dims.nfreqs, ntimes_true=dims.ntimes,
              alpha_int=dims.ntimes - 1, all_unflagged=dims.all_unflagged,
              prior=prior, group=2, row_times=rt, impl=timpl.PLAIN)
    keyed = gcr_megachain(mops, tables.tlog, tables.q, ps, 2, seed=SEED,
                          sids=sids, sidc=sidc, iter0=1, **kw)
    fed = gcr_megachain(
        mops, tables.tlog, tables.q, ps, 2, randomness=_stream_randomness(
            sids, 1, 2, dims, len(static), rt,
            sidc.to(torch.int64) + philox.CHAIN_STREAM_OFFSET), **kw)
    _equal(keyed, fed)


def case_mega_step():
    mops, dims, ps, static = problem(2)
    tables = tmc.make_chain_tables(mops, CPU)
    prior = trb.prior_bins(static, CPU)
    sids = torch.tensor([2, 9], dtype=torch.int32)
    fed = {k: v[0] for k, v in _stream_randomness(
        sids, 11, 1, dims, len(static)).items()}
    for store_cr in (True, False):
        args = (mops, dims, ps, prior, tables.tlog, tables.q)
        kw = dict(store_cr=store_cr, impl=timpl.PLAIN)
        ps_k, d_k = tmega.gibbs_step_mega(
            *args, dict(seed=SEED, sids=sids, g=11), **kw)
        ps_f, d_f = tmega.gibbs_step_mega(*args, fed, **kw)
        assert torch.equal(ps_k, ps_f)
        _equal(d_k, d_f)


CASES = {f.__name__[5:]: f for f in (
    case_draw_plain, case_draw_row_times, case_draw_needs_one_source,
    case_megachain_chunk, case_megachain_grouped, case_mega_step)}


@pytest.mark.parametrize("case", list(CASES))
def test_keyed_omegas(case):
    CASES[case]()


@pytest.mark.cuda
def test_keyed_kernels_and_bandpower_on_card():
    """On the card: keyed ``draw_rhs``/``draw_system`` equal their stored
    mode fed ``rng_fields`` (plain and per-row time counts), and
    ``bandpower`` is within 1e-5 of its plain version for G = 1 and
    G = 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    dev = torch.device("cuda", 0)
    K, P = timpl.KERNELS, timpl.PLAIN
    mops, dims, ps, static = problem(4)
    mops = tmega.MegaOperators(
        **{k: getattr(mops, k).to(dev) if torch.is_tensor(getattr(mops, k))
           else getattr(mops, k) for k in tmega.MegaOperators._fields})
    ps = ps.to(dev)
    B, n, t = mops.nid.shape
    sids = torch.tensor([3, 0, 7, 12], dtype=torch.int32, device=dev)
    for rt in (None, torch.tensor([NT, 7, 0, 3], dtype=torch.int32,
                                  device=dev)):
        key = tdf.OmegaKey(SEED, sids, 5)
        oa, ob = K.rng_fields(SEED, sids, 5, n, t, dims.ntimes, dims.nfreqs,
                              rt)
        rc = K.draw_rhs(mops.nid, mops.nih, ob, dims.ntimes, rt)
        assert torch.equal(K.draw_rhs(mops.nid, mops.nih, None, dims.ntimes,
                                      rt, key), rc)
        frc = K.cgemm(mops.f, rc)
        want = K.draw_system(mops.pt, ps, frc, oa, dims.ntimes, dims.nfreqs,
                             rt)
        _equal(K.draw_system(mops.pt, ps, frc, None, dims.ntimes,
                             dims.nfreqs, rt, key), want)
    tables = tmc.make_chain_tables(mops, dev)
    prior = trb.prior_bins(static, dev)
    beta = torch.rand((8, n), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    sidc = torch.repeat_interleave(torch.arange(2, dtype=torch.int32,
                                                device=dev), 4)
    for group, sd in ((1, torch.arange(8, dtype=torch.int32, device=dev)),
                      (4, sidc)):
        kw = dict(seed=SEED, sids=sd, g=3, alpha=dims.ntimes - 1,
                  gam_out=True, group=group)
        for got, want in zip(K.bandpower(beta, prior, tables.tlog, tables.q,
                                         **kw),
                             P.bandpower(beta, prior, tables.tlog, tables.q,
                                         **kw)):
            assert float((got - want).abs().max()) <= \
                1e-5 * float(want.abs().max())
