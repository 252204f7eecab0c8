"""Direct-HDF5 uvh5 reader, writer and visibility preprocessing (the port's
own copy of ``hydra_pspec_tpu/utils/uvh5.py``, which it may not import).

A thin h5py reader for the uvh5 layout (Header/{ant_1_array, ant_2_array,
freq_array, polarization_array, ...}, Data/{visdata, flags, nsamples}) in
place of the reference's pyuvdata (run-hydra-pspec.py:305-322,
utils.py:105-199). Each process can read only its own baselines' rows
(the reference loads everything on rank 0,
scripts/scaling_tests/scaling_tests_README.md:74-80). ``h5py`` is imported
inside :func:`read_uvh5` and :func:`write_uvh5` only: the rest runs
without it.
"""
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# AIPS polarization codes used by uvh5 (pyuvdata convention).
POL_NUM = {"xx": -5, "yy": -6, "xy": -7, "yx": -8, "pI": 1}


@dataclass
class BaselineData:
    """One baseline's visibilities and metadata, shape (Ntimes, Nfreqs)."""

    antpair: tuple
    vis: np.ndarray
    flags: np.ndarray       # boolean, True = flagged (uvh5 convention)
    nsamples: np.ndarray
    freqs: np.ndarray       # Hz
    times: np.ndarray = field(default_factory=lambda: np.zeros(0))
    lsts: np.ndarray = field(default_factory=lambda: np.zeros(0))
    uvw: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))


def _decode(x):
    return x.decode() if isinstance(x, bytes) else x


def read_uvh5(
    path,
    antpairs: Optional[Sequence[tuple]] = None,
    freq_range: Optional[str] = None,
    pseudo_stokes: bool = True,
    convention: float = 1.0,
):
    """Read a uvh5 file into per-baseline arrays.

    Mirrors the reference ingest pipeline: baseline conjugation to
    ``ant1 < ant2`` (run-hydra-pspec.py:318 ``conjugate_bls``), pseudo-
    Stokes I formation ``pI = convention * (XX + YY)``
    (utils.py:105-132), and frequency selection (utils.py:135-199).

    Returns ``(baselines, freqs_hz)`` where ``baselines`` is a list of
    :class:`BaselineData` sorted by (ant1, ant2).
    """
    import h5py

    path = Path(path)
    with h5py.File(path, "r") as f:
        hdr = f["Header"]
        ant1 = hdr["ant_1_array"][:]
        ant2 = hdr["ant_2_array"][:]
        freqs = np.asarray(hdr["freq_array"][:]).reshape(-1)
        pols = list(hdr["polarization_array"][:])
        time_arr = hdr["time_array"][:]
        lst_arr = hdr["lst_array"][:] if "lst_array" in hdr else np.zeros_like(time_arr)
        uvw_arr = hdr["uvw_array"][:]

        freq_sel = np.arange(freqs.size)
        if freq_range:
            keep = filter_freqs(freq_range, freqs / 1e6)
            freq_sel = np.nonzero(np.isin(freqs / 1e6, keep))[0]
        freqs_out = freqs[freq_sel]

        # Conjugate to ant1 < ant2 ordering.
        conj = ant1 > ant2
        a_lo = np.where(conj, ant2, ant1)
        a_hi = np.where(conj, ant1, ant2)
        pairs = sorted({(int(a), int(b)) for a, b in zip(a_lo, a_hi)})
        if antpairs is not None:
            want = {tuple(sorted(p)) for p in antpairs}
            pairs = [p for p in pairs if p in want]

        vis_ds = f["Data/visdata"]
        flag_ds = f["Data/flags"]
        nsamp_ds = f["Data/nsamples"]

        def pol_index(name):
            code = POL_NUM[name]
            return pols.index(code) if code in pols else None

        ixx, iyy = pol_index("xx"), pol_index("yy")
        ipI = pols.index(POL_NUM["pI"]) if POL_NUM["pI"] in pols else None

        baselines = []
        for (a, b) in pairs:
            rows = np.nonzero((a_lo == a) & (a_hi == b))[0]
            order = np.argsort(time_arr[rows], kind="stable")
            rows = rows[order]
            vis = vis_ds[rows][:, freq_sel, :]
            flg = flag_ds[rows][:, freq_sel, :]
            nsm = nsamp_ds[rows][:, freq_sel, :]
            # Conjugate rows stored as (b, a).
            crow = conj[rows]
            vis[crow] = np.conj(vis[crow])
            if pseudo_stokes:
                if ipI is not None:
                    v = vis[..., ipI]
                    fl = flg[..., ipI]
                    ns = nsm[..., ipI]
                elif ixx is not None and iyy is not None:
                    v = convention * (vis[..., ixx] + vis[..., iyy])
                    fl = flg[..., ixx]  # see run-hydra-pspec.py:386-391 FIXME
                    ns = nsm[..., ixx]
                elif ixx is not None:
                    v = vis[..., ixx]
                    fl = flg[..., ixx]
                    ns = nsm[..., ixx]
                else:
                    raise ValueError(f"No xx/yy/pI polarization in {path}")
            else:
                v, fl, ns = vis, flg, nsm
            baselines.append(
                BaselineData(
                    antpair=(a, b),
                    vis=np.ascontiguousarray(v),
                    flags=np.ascontiguousarray(fl),
                    nsamples=np.ascontiguousarray(ns),
                    freqs=freqs_out,
                    times=time_arr[rows],
                    lsts=lst_arr[rows],
                    uvw=uvw_arr[rows],
                )
            )
    return baselines, freqs_out


def parse_ant_str(ant_str: str):
    """Parse the reference's ``--ant_str`` format: 'cross', 'all', or a
    comma list of underscore-joined pairs like '1_11,12_14'
    (run-hydra-pspec.py:40-47)."""
    ant_str = ant_str.strip()
    if ant_str in ("cross", "all", ""):
        return None
    pairs = []
    for tok in ant_str.split(","):
        a, b = tok.split("_")
        pairs.append((int(a), int(b)))
    return pairs


def filter_freqs(freq_str: str, freqs_in_mhz) -> np.ndarray:
    """Frequency subset selection (reference utils.py:135-199): a range
    '100-200.3', a comma list '100,110.4,150' (nearest-channel match), or a
    single value. Input/output in MHz."""
    freqs_in = np.asarray(freqs_in_mhz, dtype=float)
    if "-" in freq_str:
        lo, hi = (float(x) for x in freq_str.split("-"))
        mask = (freqs_in >= lo) & (freqs_in <= hi)
    else:
        vals = [float(x) for x in freq_str.split(",")]
        idx = [int(np.argmin(np.abs(freqs_in - v))) for v in vals]
        mask = np.zeros(freqs_in.size, dtype=bool)
        mask[idx] = True
    return freqs_in[mask]


def trim_flagged_channels(w, x):
    """Remove flagged channels from a 1D vector or square 2D matrix
    (reference utils.py:77-102). Host-side (dynamic output shape)."""
    w = np.asarray(w)
    x = np.asarray(x)
    assert x.shape in ((w.size,), (w.size, w.size)), (
        "Input array must have shape (w.size,) or (w.size, w.size)"
    )
    keep = w == 1.0
    if x.ndim == 1:
        return x[keep]
    return x[np.ix_(keep, keep)]


def collapse_flags_any_time(flags: np.ndarray) -> np.ndarray:
    """Per-channel weights: 0 if *any* time sample is flagged in that
    channel, else 1 (the driver's w_any collapse, run-hydra-pspec.py:529-535;
    input uses the uvh5 convention True = flagged)."""
    return (~np.any(flags, axis=0)).astype(float)


def write_uvh5(
    path,
    vis_by_baseline,
    freqs_hz,
    times=None,
    pols=("xx",),
    flags_by_baseline=None,
    nsamples_by_baseline=None,
    telescope_name="synthetic",
):
    """Write a minimal uvh5 file readable by :func:`read_uvh5` (and by
    pyuvdata for the fields it requires at read time).

    ``vis_by_baseline``: dict {(ant1, ant2): (Ntimes, Nfreqs) complex} —
    per-pol data is replicated across the requested ``pols``.

    The reference has no writer (its scaling fixture replicates .npy files,
    set_up_scaling_data.py); this enables fabricating multi-baseline inputs
    for driver-level tests and scaling runs.
    """
    import h5py

    pairs = sorted(vis_by_baseline)
    first = vis_by_baseline[pairs[0]]
    ntimes, nfreqs = first.shape
    freqs_hz = np.asarray(freqs_hz, dtype=float).reshape(-1)
    assert freqs_hz.size == nfreqs
    if times is None:
        times = 2459000.0 + np.arange(ntimes) / 86400.0
    npols = len(pols)
    nblts = ntimes * len(pairs)

    ant1 = np.repeat([p[0] for p in pairs], ntimes)
    ant2 = np.repeat([p[1] for p in pairs], ntimes)
    time_arr = np.tile(times, len(pairs))
    ants = sorted({a for p in pairs for a in p})

    vis = np.zeros((nblts, nfreqs, npols), dtype=np.complex128)
    flg = np.zeros((nblts, nfreqs, npols), dtype=bool)
    nsm = np.ones((nblts, nfreqs, npols), dtype=np.float32)
    for i, p in enumerate(pairs):
        sl = slice(i * ntimes, (i + 1) * ntimes)
        vis[sl] = vis_by_baseline[p][:, :, None]
        if flags_by_baseline and p in flags_by_baseline:
            flg[sl] = flags_by_baseline[p][:, :, None]
        if nsamples_by_baseline and p in nsamples_by_baseline:
            nsm[sl] = nsamples_by_baseline[p][:, :, None]

    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        hdr["Nants_data"] = len(ants)
        hdr["Nants_telescope"] = len(ants)
        hdr["Nbls"] = len(pairs)
        hdr["Nblts"] = nblts
        hdr["Nfreqs"] = nfreqs
        hdr["Npols"] = npols
        hdr["Nspws"] = 1
        hdr["Ntimes"] = ntimes
        hdr["ant_1_array"] = ant1
        hdr["ant_2_array"] = ant2
        hdr["antenna_names"] = np.array(
            [f"ant{a}".encode() for a in ants]
        )
        hdr["antenna_numbers"] = np.asarray(ants, dtype=np.int32)
        hdr["antenna_positions"] = np.zeros((len(ants), 3))
        hdr["channel_width"] = np.full(
            nfreqs, freqs_hz[1] - freqs_hz[0] if nfreqs > 1 else 1e5
        )
        hdr["freq_array"] = freqs_hz
        hdr["flex_spw_id_array"] = np.zeros(nfreqs, dtype=np.int64)
        hdr["integration_time"] = np.full(nblts, 10.0)
        hdr["lst_array"] = np.tile(
            np.linspace(0, 2 * np.pi * ntimes / 86400, ntimes), len(pairs)
        )
        hdr["polarization_array"] = np.asarray(
            [POL_NUM[p] for p in pols], dtype=np.int64
        )
        hdr["spw_array"] = np.asarray([0], dtype=np.int64)
        hdr["telescope_name"] = np.bytes_(telescope_name)
        hdr["latitude"] = 0.0
        hdr["longitude"] = 0.0
        hdr["altitude"] = 0.0
        hdr["time_array"] = time_arr
        hdr["uvw_array"] = np.zeros((nblts, 3))
        hdr["history"] = np.bytes_("hydra_pspec_torch synthetic uvh5")
        hdr["instrument"] = np.bytes_(telescope_name)
        hdr["object_name"] = np.bytes_("zenith")
        hdr["phase_type"] = np.bytes_("drift")
        hdr["vis_units"] = np.bytes_("Jy")
        data = f.create_group("Data")
        data.create_dataset("visdata", data=vis)
        data.create_dataset("flags", data=flg)
        data.create_dataset("nsamples", data=nsm)
    return path


def form_pseudo_stokes(vis_xx, vis_yy, convention: float = 1.0):
    """Pseudo-Stokes I from XX and YY visibility arrays:
    ``pI = convention * (XX + YY)`` (reference utils.py:105-132 operates on
    a pyuvdata.UVData in place; here arrays in, array out — the reader
    applies the same convention when both polarizations are present)."""
    return convention * (np.asarray(vis_xx) + np.asarray(vis_yy))
