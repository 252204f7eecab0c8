"""The omega fields at chosen times: ``rng_fields``' time map (``tmap``)
and its segment form (``rng_segments``), which draws the grouped real
engine's time groups each at its own width in one launch.

* The Philox twin with a time map is ``torch.equal`` to its full fields
  gathered at the map's times: random index sets, a one-time group, odd
  and even widths, and per-row time counts (``row_times``).
* The segment form is ``torch.equal``, group by group, to the same
  gathers; the segment table read as ``csrc/rng_bandpower.cu``'s
  ``fields_kernel`` reads it puts every group's lanes where the wrapper's
  views find them.
* ``gibbs_step_tflags_real`` on the streams (the one-launch draw) is
  ``torch.equal`` to the same step fed the twin's full fields, transposed,
  as external omegas: the path ``tests/test_torch_row_passes.py`` holds
  against the JAX package's grouped real step.
* On the card (marked ``cuda``, skipped here): the kernel's time map and
  segments against the twin and against its own full fields gathered.

No JAX: the port's own functions on the CPU, where the wrappers take the
twin."""
import numpy as np
import pytest
import torch

from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.invgamma import make_invgamma_table
from hydra_pspec_torch.ops.kernels import _build
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb

CPU = torch.device("cpu")
SEED = 20261018
B, N, T, NFREQS = 3, 8, 37, 16


def _sids():
    return torch.tensor([5, 0, 1 << 20], dtype=torch.int32)


def _index_sets():
    """Random increasing index sets of T times (odd and even sizes), a
    one-time group, the first and the last time, every time."""
    rng = np.random.default_rng(SEED)
    sets = [np.sort(rng.choice(T, size=k, replace=False))
            for k in (2, 5, 10, 17)]
    return sets + [np.array([19]), np.array([0, T - 1]), np.arange(T)]


def _full():
    return philox.omega_fields(SEED, _sids(), 11, N, T, T, NFREQS)


@pytest.mark.parametrize("k", range(7))
def test_tmap_equals_full_fields_gathered(k):
    ix = torch.from_numpy(_index_sets()[k])
    tg = int(ix.shape[0])
    oa, ob = philox.omega_fields(SEED, _sids(), 11, N, tg, tg, NFREQS,
                                 tmap=ix.to(torch.int32))
    fa, fb = _full()
    assert torch.equal(oa, fa[:, :, ix]) and torch.equal(ob, fb[:, :, ix])
    # through the wrapper's CPU route
    ka, kb = trb.rng_fields(SEED, _sids(), 11, N, tg, tg, NFREQS,
                            tmap=ix.to(torch.int32))
    assert torch.equal(ka, oa) and torch.equal(kb, ob)


def test_tmap_with_row_times():
    """Lanes at or beyond a row's count are zero, the others the full
    fields at the mapped times."""
    ix = torch.from_numpy(_index_sets()[3])
    tg = int(ix.shape[0])
    rt = torch.tensor([tg, 1, 6], dtype=torch.int32)
    oa, ob = philox.omega_fields(SEED, _sids(), 11, N, tg, tg, NFREQS,
                                 row_times=rt, tmap=ix)
    mask = (torch.arange(tg)[None, None, :] < rt[:, None, None])
    fa, fb = _full()
    zero = torch.zeros((), dtype=torch.complex64)
    assert torch.equal(oa, torch.where(mask, fa[:, :, ix], zero))
    assert torch.equal(ob, torch.where(mask, fb[:, :, ix], zero))
    assert not torch.any(oa[1, :, 1:] != 0) and torch.any(oa[1, :, 0] != 0)


def _partition():
    """The T times split into groups of 1, 6 (even), 9, 10 and 11 (odd),
    interleaved as flag patterns make them."""
    rng = np.random.default_rng(SEED + 1)
    lab = np.repeat(np.arange(5), [1, 6, 9, 10, 11])
    rng.shuffle(lab)
    return [np.nonzero(lab == g)[0] for g in range(5)]


def test_segments_equal_gathers():
    idx = [torch.from_numpy(ix) for ix in _partition()]
    segs = trb.time_segments(idx)
    assert segs.widths == (1, 6, 9, 10, 11)
    oa, ob = trb.rng_segments(SEED, _sids(), 11, N, segs, NFREQS)
    fa, fb = _full()
    assert len(oa) == len(ob) == 5
    for ix, a, b in zip(idx, oa, ob):
        assert a.shape == (B, N, ix.shape[0])
        assert torch.equal(a, fa[:, :, ix]) and torch.equal(b, fb[:, :, ix])


def _emulate_fields_kernel(rows, n, table, nseg, chunks, lanes):
    """Where ``fields_kernel`` puts each chunk in segment mode, by its own
    index arithmetic (``chunk_at``: segment by segment, each segment's
    rows one after another): for every chunk in launch order, its first
    element and its lanes' ``(b, i, time counter)``, the lanes below its
    segment's width (every lane of a segment is drawn)."""
    tab = table.tolist()
    coff, toff = tab[:nseg + 1], tab[nseg + 1:2 * (nseg + 1)]
    tidx = tab[2 * (nseg + 1):]
    out = []
    for c in range(chunks):
        s = max(q for q in range(nseg) if rows * coff[q] <= c)
        cpr = coff[s + 1] - coff[s]
        row, k = divmod(c - rows * coff[s], cpr)
        b, i = divmod(row, n)
        w = toff[s + 1] - toff[s]
        j0 = k * lanes
        out.append((rows * toff[s] + row * w + j0,
                    [(b, i, tidx[toff[s] + j])
                     for j in range(j0, min(j0 + lanes, w))]))
    return out


def test_segment_table_addresses(monkeypatch):
    """The card branch of ``rng_segments`` without a card: the launch's
    arguments, and the kernel's reading of the table (emulated above):
    consecutive chunks cover consecutive elements (a warp writes its
    lanes out in order from shared memory), and lane j of group g's row
    (b, i) lands where the wrapper's view of group g holds it, drawn at
    time ``idx_g[j]``."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *xs: False)
    monkeypatch.setattr(_build, "check", lambda *args, **kw: None)
    monkeypatch.setattr(_build, "call", lambda kernel, entry, *args:
                        calls.append((kernel, entry, args)))
    idx = [torch.from_numpy(ix) for ix in _partition()]
    segs = trb.time_segments(idx)
    oa, _ = trb.rng_segments(SEED, _sids(), 11, N, segs, NFREQS)
    (kernel, entry, args), = calls
    assert (kernel, entry) == ("rng_fields", "hk_rng_fields")
    batch, n, t, ntimes, nf, rt, tmap, _, nseg, cpr = args[5:]
    assert (batch, n, t, ntimes, nf, rt, tmap, nseg) == (
        B, N, 0, 0, NFREQS, None, None, 5)
    assert cpr == sum(-(-w // trb.LANES) for w in segs.widths) == 12
    chunks = _emulate_fields_kernel(B * N, N, segs.table, nseg, B * N * cpr,
                                    trb.LANES)
    placed, e = {}, 0
    for start, lanes in chunks:
        assert start == e
        for lane in lanes:
            placed[e] = lane
            e += 1
    assert e == B * N * T
    elem = oa[0].storage_offset()
    for ix, view in zip(idx, oa):
        for b in range(B):
            for i in range(N):
                for j, tj in enumerate(ix.tolist()):
                    o = (view.storage_offset() - elem + b * view.stride(0)
                         + i * view.stride(1) + j)
                    assert placed[o] == (b, i, tj)


NT_G, NF_G, NM_G, NCH = 12, 16, 2, 3


def _grouped():
    """Three baselines' grouped real operators under flags that make
    groups of 6 (0-4 and 6), 1 (time 5) and 5 (7-11) times."""
    flags = np.zeros((NT_G, NF_G), dtype=bool)
    flags[5, 3] = True
    flags[7:, 8] = True
    per = []
    for b in range(NCH):
        rng = np.random.default_rng(SEED + b)
        c = lambda *s: (rng.standard_normal(s)
                        + 1j * rng.standard_normal(s)) / np.sqrt(2)
        d, fg = c(NT_G, NF_G) * 2.0, c(NF_G, NM_G)
        ninv = np.abs(rng.standard_normal(NF_G)) + 1.0
        per.append(ttf.build_grouped_operators_real(d, flags, fg, ninv))
    groups = [ttf.TimeGroupReal(
                  ops=trg.stack_chain_operators([p[g].ops for p in per]),
                  idx=per[0][g].idx)
              for g in range(len(per[0]))]
    return ttf.to_device(groups, CPU)


def test_grouped_real_step_streams_equal_external_fields():
    """The step drawing each group's omegas at its own width equals the
    step fed the full fields (B, Ntimes, Nfreqs), which gathers them: every
    output ``torch.equal``. The bandpower draw is on the streams in
    both."""
    groups = _grouped()
    assert sorted(g.idx.shape[0] for g in groups) == [1, 5, 6]
    prior = np.zeros((2, NF_G))
    prior[0, 7:10], prior[1, 7:10] = 300.0, 0.5
    bins = trb.prior_bins(trb.bounded_bins(prior), CPU)
    table = make_invgamma_table(NT_G)
    tl = torch.from_numpy(np.asarray(table.log_y))
    q = torch.from_numpy(np.asarray(table.q))
    ps = torch.from_numpy(np.abs(np.random.default_rng(SEED + 9)
                                 .standard_normal((NCH, NF_G)))
                          .astype(np.float32) * 10.0 + 0.5)
    sids = torch.tensor([3, 1, 40], dtype=torch.int32)
    streams = dict(seed=SEED, sids=sids, g=6)
    oa, ob = philox.omega_fields(SEED, sids, 6, NF_G, NT_G, NT_G, NF_G)
    external = dict(streams, oa=oa.transpose(1, 2), ob=ob.transpose(1, 2))
    got = ttf.gibbs_step_tflags_real(groups, ps, bins, tl, q, streams,
                                     solver="chol")
    want = ttf.gibbs_step_tflags_real(groups, ps, bins, tl, q, external,
                                      solver="chol")
    segs = ttf.time_segments(groups)
    again = ttf.gibbs_step_tflags_real(groups, ps, bins, tl, q, streams,
                                       solver="chol", segments=segs)
    for a, b, c in zip((got[0],) + tuple(got[1]), (want[0],) + tuple(want[1]),
                       (again[0],) + tuple(again[1])):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the chain over two iterations, on the streams, equals the chain fed
    # the same full fields as its randomness
    _, s1 = ttf.run_chain_tflags_real(groups, ps, bins, 2, tl, q, seed=SEED,
                                      sids=sids, iter0=6, solver="chol")
    fields = [philox.omega_fields(SEED, sids, 6 + k, NF_G, NT_G, NT_G, NF_G)
              for k in range(2)]
    gam, u = [], []
    for k in range(2):
        gam.append(philox.gamma_draws(SEED, sids, 6 + k, NF_G, NT_G - 1))
        u.append(philox.prior_uniforms(SEED, sids, 6 + k, 3))
    rnd = dict(oa=torch.stack([f[0].transpose(1, 2) for f in fields]),
               ob=torch.stack([f[1].transpose(1, 2) for f in fields]),
               gam=torch.stack(gam), u_pb=torch.stack(u))
    _, s2 = ttf.run_chain_tflags_real(groups, ps, bins, 2, tl, q,
                                      randomness=rnd, solver="chol")
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_tmap_and_segments_on_card():
    """On the card: the time map and the segments against the twin (1e-5
    of the largest value) and against the kernel's own full fields
    gathered (``torch.equal``), at the real engine's width."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card only")
    dev = torch.device("cuda")
    sids = _sids().to(dev)
    fa, fb = trb.rng_fields(SEED, sids, 11, 120, T, T, 120)
    idx = [torch.from_numpy(ix).to(dev) for ix in _partition()]
    oa, ob = trb.rng_segments(SEED, sids, 11, 120, trb.time_segments(idx),
                              120)
    pa, pb = trb.plain_rng_fields(SEED, sids, 11, 120, T, T, 120)
    for ix, a, b in zip(idx, oa, ob):
        assert torch.equal(a, fa[:, :, ix]) and torch.equal(b, fb[:, :, ix])
        for got, want in ((a, pa[:, :, ix]), (b, pb[:, :, ix])):
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
        ka, kb = trb.rng_fields(SEED, sids, 11, 120, ix.shape[0],
                                ix.shape[0], 120, tmap=ix.to(torch.int32))
        assert torch.equal(ka, a) and torch.equal(kb, b)
