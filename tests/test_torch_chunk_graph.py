"""A megachain chunk as one CUDA graph: what makes it capturable, held on
the CPU against what it replaces (port only, no JAX).

* The warm start without a host sync (``ops/kernels/megachain.py::
  _WarmStart``: NS products on every chain, then the exact inverse in
  ``herm_inv``'s gate mode) equals the composition it replaced (its
  ``.tolist()``
  decision on the host, kept below as ``_host_warm_start``) bit for bit on
  the plain versions, with every chain rebuilding, none, and a mix; a NaN
  bandpower forces a rebuild.
* The keyed plain twins give the same bits with the iteration as an int
  and as a (1,) int32 tensor plus an offset (a graph replay's counter).
* The chunked mega engine equals its former per-step loop bit for bit.
* On the card (skipped here): a ``ChunkGraph`` replay equals the eager
  kernel path on every output, plain and grouped.

Together with tests/test_torch_megachain.py, which pins the warm start
(``warm_ns``) against the JAX kernel, these hold the graph path against the
reference. The problem is small: 12 times x 16 channels, 2 foreground
modes, padded to n = t = 128 as the engines pad it."""
import functools

import numpy as np
import pytest
import torch

from hydra_pspec_torch.models import mega as tmega
from hydra_pspec_torch.models import megachain as tmc
from hydra_pspec_torch.models import rgibbs as trg
from hydra_pspec_torch.models import tflags as ttf
from hydra_pspec_torch.ops import philox
from hydra_pspec_torch.ops.kernels import _build
from hydra_pspec_torch.ops.kernels import draw_fused as tdf
from hydra_pspec_torch.ops.kernels import herm_inv as thi
from hydra_pspec_torch.ops.kernels import rng_bandpower as trb
from hydra_pspec_torch.ops.kernels.graph import ChunkGraph
from hydra_pspec_torch.ops.kernels.impl import PLAIN
from hydra_pspec_torch.ops.kernels.megachain import _WarmStart

CPU = torch.device("cpu")
NT, NF, NM = 12, 16, 2
SEED = 20261018
B, N, K = 8, 16, 4


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


# --- the warm start --------------------------------------------------------

def _host_warm_start(state, s, ps, k, warm_ns, drift_max):
    """The warm start as it was before the graph: the gate's decision read
    back to the host, NS only when some chain keeps its inverse, the exact
    inverse only when some chain rebuilds, then a select."""
    mm, herm_inv = PLAIN.cgemm, PLAIN.herm_inv
    if k == 0:
        inv = herm_inv(s)
    else:
        psx = state["psx"]
        tiny = torch.finfo(torch.float32).tiny
        rel = torch.abs(ps - psx) / (
            0.5 * (torch.abs(ps) + torch.abs(psx))
            + 1e-6 * torch.amax(psx, dim=1, keepdim=True) + tiny)
        drift = torch.amax(rel, dim=1)
        rebuild = torch.logical_not(drift <= drift_max)
        any_rebuild, any_ns = torch.stack(
            [rebuild.any(), torch.logical_not(rebuild).any()]).tolist()
        inv = state["inv"]
        if any_ns:
            for _ in range(warm_ns):
                ex = mm(s, inv)
                inv = mm(inv, ex, x=inv, alpha=-1.0, beta=2.0)
        if any_rebuild:
            exact = herm_inv(s)
            inv = exact if not any_ns else torch.where(
                rebuild[:, None, None], exact, inv)
    state.update(inv=inv, psx=ps)
    return inv


def _warm_inputs(nan_at=None):
    """K systems S_k = I + X X^H / N (B, N, N) and bandpowers whose chain
    b moves by a factor 1 + 0.04 b an iteration (drifts 0 to ~0.27)."""
    rng = np.random.default_rng(3)
    systems, pss = [], []
    base = np.abs(rng.standard_normal((B, N))) + 0.5
    for k in range(K):
        x = _crandn(rng, B, N, N)
        s = np.eye(N) + x @ np.conj(np.swapaxes(x, 1, 2)) / N
        systems.append(torch.from_numpy(s.astype(np.complex64)))
        ps = base * (1.0 + 0.04 * np.arange(B)[:, None]) ** k
        ps = torch.from_numpy(ps.astype(np.float32))
        if nan_at is not None and k == nan_at[0]:
            ps[nan_at[1], 5] = float("nan")
        pss.append(ps)
    return systems, pss


def _warm_case(drift_max, nan_at=None):
    """Returns the per-iteration rebuild counts the gate chose, after
    holding both warm starts equal at every iteration."""
    systems, pss = _warm_inputs(nan_at)
    ws, state = _WarmStart(2, drift_max, PLAIN), {}
    counts = []
    for k in range(K):
        got = ws(systems[k], pss[k], k)
        want = _host_warm_start(state, systems[k], pss[k], k, 2, drift_max)
        assert torch.equal(got, want), (drift_max, k)
        if k:
            flags = thi.plain_warm_gate(pss[k], pss[k - 1], drift_max)
            exact = PLAIN.herm_inv(systems[k])
            on = flags.bool()
            assert torch.equal(got[on], exact[on])
            counts.append(int(flags.sum()))
    return counts


@pytest.mark.parametrize("mode", ["all_rebuild", "none", "mix", "nan"])
def test_warm_start_without_host_sync(mode):
    if mode == "all_rebuild":
        assert _warm_case(0.0) == [B - 1] * (K - 1)   # chain 0 never moves
        assert _warm_case(-1.0) == [B] * (K - 1)
    elif mode == "none":
        assert _warm_case(10.0) == [0] * (K - 1)
    elif mode == "mix":
        counts = _warm_case(0.15)
        assert all(0 < c < B for c in counts), counts
    else:
        counts = _warm_case(10.0, nan_at=(2, 3))
        assert counts == [0, 1, 1], counts   # the NaN at k = 2 and k = 3


def test_warm_gate_contract():
    """``herm_inv``'s gate mode: its flags are int32 per chain, 1 for a NaN
    anywhere in the chain's row (old or new), 0 for an unmoved chain; with
    every chain moved, none, a mix and a NaN, the gate mode writes the
    flags of ``plain_warm_gate`` and the inverse of the composition it
    replaced (the gate, then the masked inverse) bit for bit."""
    ps = torch.rand((4, 8)) + 0.5
    new = ps.clone()
    new[1, 2] = float("nan")
    old = ps.clone()
    old[2, 7] = float("nan")
    new[3] *= 2.0
    flags = thi.plain_warm_gate(new, old, 0.5)
    assert flags.dtype == torch.int32 and flags.tolist() == [0, 1, 1, 1]
    systems, pss = _warm_inputs()
    s, carried = systems[1], PLAIN.herm_inv(systems[0])
    nan = pss[1].clone()
    nan[3, 5] = float("nan")
    for psn, dmax, want in ((pss[1], -1.0, [1] * B), (pss[1], 10.0, [0] * B),
                            (pss[1], 0.15, None), (nan, 10.0, [0, 0, 0, 1,
                                                             0, 0, 0, 0])):
        rebuild = torch.full((B,), -1, dtype=torch.int32)
        got = thi.herm_inv(s, out=carried.clone(), gate=(psn, pss[0], dmax),
                           rebuild=rebuild)
        active = thi.plain_warm_gate(psn, pss[0], dmax)
        composed = thi.plain_herm_inv(s, out=carried.clone(), active=active)
        assert torch.equal(rebuild, active) and torch.equal(got, composed)
        assert torch.equal(got, PLAIN.herm_inv(s, out=carried.clone(),
                                               gate=(psn, pss[0], dmax)))
        if want is None:
            assert 0 < int(active.sum()) < B, active.tolist()
        else:
            assert active.tolist() == want, (dmax, active.tolist())
    with pytest.raises(ValueError, match="active or gate"):
        thi.herm_inv(s, out=carried.clone(), active=flags,
                     gate=(pss[1], pss[0], 0.5))


# --- the keyed twins with the iteration on the device ----------------------

@functools.lru_cache(maxsize=None)
def problem(batch: int):
    """``batch`` chains' mega operators (chain 1 with two flagged
    channels), their padded bandpowers and a 3-bin prior."""
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


def test_keyed_twins_take_a_device_iteration():
    mops, dims, ps, static = problem(4)
    sids = torch.tensor([3, 0, 7, 12], dtype=torch.int32)
    g_dev = torch.tensor([5], dtype=torch.int32)
    rt = torch.tensor([NT, 7, 0, 3], dtype=torch.int32)
    nt, nf = dims.ntimes, dims.nfreqs
    for row_times in (None, rt):
        k_int = tdf.OmegaKey(SEED, sids, 9)
        k_dev = tdf.OmegaKey(SEED, sids, g_dev, 4)
        for fn in (tdf.plain_draw_rhs, tdf.draw_rhs):
            assert torch.equal(
                fn(mops.nid, mops.nih, None, nt, row_times, k_dev),
                fn(mops.nid, mops.nih, None, nt, row_times, k_int))
        frc = PLAIN.cgemm(mops.f, mops.nid)
        for fn in (tdf.plain_draw_system, tdf.draw_system):
            for a, b in zip(fn(mops.pt, ps, frc, None, nt, nf, row_times,
                               k_dev),
                            fn(mops.pt, ps, frc, None, nt, nf, row_times,
                               k_int)):
                assert torch.equal(a, b)
    tables = tmc.make_chain_tables(mops, CPU)
    prior = trb.prior_bins(static, CPU)
    beta = torch.rand((4, dims.n), generator=torch.Generator().manual_seed(2))
    for group, ids in ((1, sids), (2, torch.tensor([4, 4, 9, 9],
                                                   dtype=torch.int32))):
        kw = dict(seed=SEED, sids=ids, alpha=nt - 1, gam_out=True,
                  group=group)
        for fn in (trb.plain_bandpower, trb.bandpower):
            for a, b in zip(fn(beta, prior, tables.tlog, tables.q, g=g_dev,
                               g_off=4, **kw),
                            fn(beta, prior, tables.tlog, tables.q, g=9,
                               **kw)):
                assert torch.equal(a, b)


def test_iteration_arguments_of_the_c_entries(monkeypatch):
    """An int iteration goes to the kernel by value; a device counter as
    its pointer, with the offset by value."""
    monkeypatch.setattr(_build, "check", lambda *a, **kw: None)
    g = torch.tensor([5], dtype=torch.int32)
    assert _build.iteration_args(7, 2, CPU) == (9, None)
    assert _build.iteration_args(g, 2, CPU) == (2, g.data_ptr())
    assert _build.iteration_args(2 ** 32 + 3, 0, CPU) == (3, None)


# --- the chunked mega engine -------------------------------------------------

def _mega_per_step(mops, dims, ps, prior, niter, tlog, q, sids, iter0,
                   store_cr):
    """The mega engine's former loop: one step at a time, the sample
    fields trimmed and stacked per iteration."""
    nf, nt, nm = dims.nfreqs, dims.ntimes, dims.nmodes
    parts = {name: [] for name in ("ps", "ln_post", "sig", "amp", "chi")}
    for k in range(niter):
        ps, d = tmega.gibbs_step_mega(
            mops, dims, ps, prior, tlog, q,
            dict(seed=SEED, sids=sids, g=iter0 + k), store_cr=store_cr,
            impl=PLAIN)
        parts["ps"].append(ps[:, :nf])
        parts["ln_post"].append(tmega.ln_post(d.noise_nu, d.bmask, ps))
        if store_cr:
            trim = lambda x, w: x[:, :w, :nt].transpose(1, 2).contiguous()
            parts["sig"].append(trim(d.sig, nf))
            parts["amp"].append(trim(d.amp, nm))
            parts["chi"].append(trim(d.chi, nf))
        else:
            parts["chi"].append(d.chit)
    st = lambda name: torch.stack(parts[name]) if parts[name] else None
    chisq = (st("chi") if store_cr
             else tmega.chi_mean(st("chi"), dims, None))
    return ps, trg.ChainSample(signal_cr=st("sig"), ps=st("ps"),
                               fg_amps=st("amp"), chisq=chisq,
                               ln_post=st("ln_post"))


@pytest.mark.parametrize("store_cr", [True, False])
def test_chunked_mega_equals_per_step(store_cr):
    mops, dims, ps, static = problem(2)
    tables = tmc.make_chain_tables(mops, CPU)
    prior = trb.prior_bins(static, CPU)
    sids = torch.tensor([2, 9], dtype=torch.int32)
    args = (mops, dims, ps, prior, 3, tables.tlog, tables.q)
    ps_c, s_c = tmega.run_chain_mega(*args, seed=SEED, sids=sids, iter0=11,
                                     store_cr=store_cr, impl=PLAIN)
    ps_s, s_s = _mega_per_step(*args, sids, 11, store_cr)
    assert torch.equal(ps_c, ps_s)
    for name in trg.ChainSample._fields:
        a, b = getattr(s_c, name), getattr(s_s, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name


# --- the graph itself --------------------------------------------------------

def test_launch_counts_of_a_capture_and_its_replays():
    """A capture's launches are recorded, not counted; each replay adds
    them."""
    before = dict(_build.LAUNCHES)
    with _build.counted() as rec:
        _build.LAUNCHES["cgemm"] += 3
        _build.LAUNCHES["herm_inv"] += 1
    assert rec.launches == {"cgemm": 3, "herm_inv": 1}
    assert _build.LAUNCHES == before
    _build.add_launches(rec.launches)
    _build.add_launches(rec.launches)
    assert _build.LAUNCHES["cgemm"] == before["cgemm"] + 6
    _build.LAUNCHES.update(before)


def test_graph_is_for_the_card_only():
    """On the CPU the chunk runs eagerly whatever ``graph`` says, and a
    graph refuses CPU tensors."""
    mops, dims, ps, static = problem(2)
    tables = tmc.make_chain_tables(mops, CPU)
    kw = dict(seed=SEED, sids=[0, 1], iter0=4, warm_ns=2, drift_max=0.6,
              impl=PLAIN)
    a = tmc.run_chunk_megachain(mops, tables, dims, ps, 2, static,
                                graph=True, **kw)
    b = tmc.run_chunk_megachain(mops, tables, dims, ps, 2, static,
                                graph=False, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].ps, b[1].ps)
    with pytest.raises(ValueError, match="CUDA"):
        ChunkGraph(lambda p, g, k: None, ps, 2)


def _grouped_problem(dev):
    """Two baselines, time flags in two patterns (channel 3 flagged from
    time 7): the grouped layout (G = 2) with its stream ids."""
    rng = np.random.default_rng(9)
    flags = np.zeros((NT, NF), dtype=bool)
    flags[7:, 3] = True
    per = [ttf.build_grouped_operators_real(
               _crandn(rng, NT, NF) * 2.0, flags, _crandn(rng, NF, NM),
               np.abs(rng.standard_normal(NF)) + 1.0) for _ in range(2)]
    groups = [ttf.TimeGroupReal(
                  ops=trg.stack_chain_operators([p[g].ops for p in per]),
                  idx=per[0][g].idx) for g in range(len(per[0]))]
    setup = tmc.build_tflags_mega_setup(groups, dev)
    G = len(setup.group_times)
    rows, chains = philox.grouped_stream_ids([0, 1], G)
    return setup, torch.from_numpy(rows).to(dev), \
        torch.from_numpy(chains).to(dev)


@pytest.mark.cuda
def test_chunk_graph_replay_equals_eager_on_card():
    """On the card: a ChunkGraph replay is torch.equal to the eager kernel
    path on every output, plain (full and lean, warm start on a mix of
    rebuilds) and grouped, from a device iteration counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    from hydra_pspec_torch.ops.kernels.megachain import ChainOut

    dev = torch.device("cuda", 0)
    mops, dims, ps, static = problem(4)
    mops = tmega.MegaOperators(
        **{k: getattr(mops, k).to(dev) if torch.is_tensor(getattr(mops, k))
           else getattr(mops, k) for k in tmega.MegaOperators._fields})
    ps = ps.to(dev)
    tables = tmc.make_chain_tables(mops, dev)
    sids = torch.tensor([3, 0, 7, 12], dtype=torch.int32, device=dev)
    gs, rows, chains = _grouped_problem(dev)
    psg = tmega.pad_ps(np.ones((rows.shape[0], NF)), gs.dims, dev)
    cases = [(tmc.chunk_body(mops, tables, dims, static, seed=SEED,
                             sids=sids, lean=lean, warm_ns=3,
                             drift_max=0.1), ps) for lean in (False, True)]
    cases.append((tmc.chunk_body(
        gs.mops, tmc.make_chain_tables(gs.mops, dev), gs.dims, static,
        seed=SEED, sids=rows, sidc=chains, warm_ns=3, drift_max=0.1,
        group_times=gs.group_times, group_idx=gs.group_idx), psg))
    for body, p in cases:
        eager = body(p, 6, 4)
        got = ChunkGraph(body, p, 4).replay(p, 6)
        for name in ChainOut._fields:
            a, b = getattr(got, name), getattr(eager, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a, b), name
