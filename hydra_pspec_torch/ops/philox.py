"""Counter-based Philox4x32-10 streams, in plain torch.

This is the twin of the CUDA generator in ``csrc/rng_bandpower.cu``: both
draw the same 32-bit words from the same (key, counter), so a run on the CPU
and a run on the card with the same seed see the same random numbers (up to
the last bits of ``log``/``cos``/``sin``, which differ between the two
math libraries).

Stream layout. The key is ``(run seed, global chain stream id sid)``; the
first counter word is the GLOBAL Gibbs iteration, so a chain's draws depend
on (seed, sid, iteration) only: not on batch composition, chunk size or a
resume. The second word names the purpose:

* ``OMEGA`` (0): counter ``(g, 0, row i, time j)``; words 0-1 give the
  frequency-basis omega (Box-Muller), words 2-3 the delay-basis omega;
* ``GAMMA`` (1): counter ``(g, 1, bin i, r)``; words are the uniforms
  ``4r .. 4r+3`` of the integer-alpha draw ``Gamma = -sum log u``;
* ``UNIFORM`` (2): counter ``(g, 2, 0, r)``, r = 0 .. ceil(npb/4) - 1;
  the prior-bin uniforms, lane ``4r + q`` for bounded bin ``4r + q`` (the
  first 8 are those of the megachain engine's at most 8 bins).

The single-step engines draw the same words. The mega engine's omegas
are the ``(B, n, t)`` fields of :func:`omega_fields`; the real engine's
``(B, Ntimes, Nfreqs)`` omegas are those fields at ``n = Nfreqs``,
``t = Ntimes`` transposed, so a chain draws the same numbers on all three
engines at a given iteration. Its grouped time-flags path takes group g's
omegas at the group's GLOBAL time indices (drawn there directly, at the
group's own width: :func:`omega_segments`), so a single all-False
pattern draws exactly what the ungrouped real engine draws.

Grouped time-flags mode (G > 1 flag-pattern time groups per chain, rows
chain-major): the omegas of row ``c*G + g`` are keyed on the row stream
``sid*G_key + g``, ``G_key`` the power of two at or above G
(:func:`key_group`; the row layout of the JAX package, which rounds G up
to it), and zero beyond that row's time count; the Gamma and uniform
words of the chain's one bandpower draw are keyed on the chain stream
``sid + 2^30`` (:data:`CHAIN_STREAM_OFFSET`). Row ids stay below 2^30, so
row and chain keys never meet (:func:`grouped_stream_ids`). G = 1 is plain
mode exactly: row key and chain key are both ``sid``.

It replaces the TPU core PRNG of ``ops/pallas/megachain.py:238-302`` and the
Box-Muller of ``ops/pallas/megastep.py:55-73``.

The complex float64 engine (``models/gibbs.py``) draws from the same
streams under its own purposes, in plain torch: each float64 uniform takes
two 32-bit words, the top 27 bits of the first and the top 26 of the
second, ``(w0 >> 5) 2^26 + (w1 >> 6) + 1/2`` over 2^53 (:func:`uniform53`,
open on both ends), so one Philox call gives two uniforms:

* ``OMEGA64`` (3): counter ``(g, 3, time t, 2 f + s)``: one standard complex
  normal by Box-Muller, ``s = 0`` the delay-basis omega ``omega_a`` and
  ``s = 1`` the frequency-basis ``omega_b`` of time t, channel f;
* ``GAMMA64`` (4): counter ``(g, 4, bin i, r)``: the uniforms ``2r, 2r+1``
  of ``Gamma(alpha) = -sum log u``;
* ``UNIFORM64`` (5): counter ``(g, 5, 0, r)``: the uniforms ``2r, 2r+1`` of
  the bounded bins, lane j for bounded bin j.

As for the float32 engines, a chain's draws depend on (seed, sid,
iteration) only, so a subset of baselines or a resumed run draws the same
numbers; a time-flags group takes the omegas of its global time indices.

The 32x32 -> 64-bit product of Philox can exceed signed int64; its low 64
bits, which int64 multiplication keeps, are the product's bit pattern, so
:func:`_mulhilo` takes it whole on every device.
"""
import math

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
OMEGA, GAMMA, UNIFORM = 0, 1, 2
N_PRIOR_UNIFORMS = 8
CHAIN_STREAM_OFFSET = 1 << 30  # grouped mode: chain keys sid + 2^30


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a*b, for a < 2^32 and an
    int64 tensor b in [0, 2^32), without leaving int64. The product is
    taken whole: int64 multiplication keeps its low 64 bits, which are the
    product's bit pattern whatever their signed reading, and the shift
    and mask read the two words from it."""
    p = a * b
    return (p >> 32) & MASK32, p & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 values;
    arguments broadcast. Returns the four output words as int64 tensors."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(x, dtype=torch.int64)
                              for x in (c0, c1, c2, c3, k0, k1))
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_open(bits: torch.Tensor) -> torch.Tensor:
    """(0, 1)-open float32 uniform from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25


def bits_to_normals(bits1, bits2):
    """Box-Muller, as ``megastep.bits_to_normals`` (megastep.py:55-73)."""
    u1 = uniform_open(bits1)
    u2 = (bits2 >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = torch.tensor(2.0 * math.pi, dtype=torch.float32) * u2
    return r * torch.cos(th), r * torch.sin(th)


def iteration(g, g_off: int = 0):
    """The iteration ``g + g_off``: an int for an int ``g``; for ``g`` a
    one-element integer tensor (the device counter of a graph replay), a
    0-dim int64 tensor on its device, read without a host sync."""
    if torch.is_tensor(g):
        return g.reshape(()).to(torch.int64) + int(g_off)
    return int(g) + int(g_off)


def _word(g):
    """The uint32 counter word of iteration ``g`` (see :func:`iteration`)."""
    return iteration(g) & MASK32


def _keys(seed: int, sids: torch.Tensor):
    k0 = int(seed) & MASK32
    k1 = sids.to(torch.int64) & MASK32
    return k0, k1


def key_group(group: int) -> int:
    """``G_key``: the power of two at or above ``group``, the stride of a
    chain's row streams."""
    g = 1
    while g < group:
        g *= 2
    return g


def grouped_stream_ids(sid_chain, group: int):
    """Per-row stream ids of chains ``sid_chain`` (global ids, host ints)
    laid out as ``group`` chain-major rows each: ``(row ids sid*G_key + g,
    chain id of each row)``, int32 numpy, ``G_key`` = :func:`key_group`:
    a row keeps its stream whether or not the layout rounds G up to
    ``G_key`` with dummy rows. Raises when a row id would reach 2^30, where
    row keys would meet the chain keys ``sid + 2^30``."""
    sid = np.asarray(sid_chain, dtype=np.int64)
    rows = (np.repeat(sid, group) * key_group(group)
            + np.tile(np.arange(group), sid.size))
    if group > 1 and rows.size and int(rows.max()) >= CHAIN_STREAM_OFFSET:
        raise ValueError(f"row stream id {int(rows.max())} >= 2^30: row "
                         f"and chain streams would overlap")
    return rows.astype(np.int32), np.repeat(sid, group).astype(np.int32)


def time_mask(t: int, ntimes: int, device, row_times=None) -> torch.Tensor:
    """float32 valid-time mask: ``(t,)`` lanes ``< ntimes``, or with the
    int32 per-row counts ``row_times`` (B,), ``(B, 1, t)`` lanes
    ``< row_times[b]``."""
    j = torch.arange(t, device=device)
    if row_times is None:
        return (j < ntimes).to(torch.float32)
    return (j[None, None, :] < row_times[:, None, None]).to(torch.float32)


def omega_fields(seed: int, sids: torch.Tensor, g, n: int, t: int,
                 ntimes: int, nfreqs: int, row_times=None, tmap=None):
    """The two omega fields of iteration ``g`` (see :func:`iteration`),
    complex64 ``(B, n, t)``:
    ``oa`` (delay basis, scaled sqrt(1/2) sqrt(nfreqs)) and ``ob``
    (frequency basis, scaled sqrt(1/2)). Zero on time lanes >= ntimes, or
    with ``row_times`` (B,) on lanes >= row b's count. ``tmap``: optional
    integer (t,) time counters, lane j drawing time ``tmap[j]`` in place
    of j (the full fields' values at those times)."""
    dev = sids.device
    k0, k1 = _keys(seed, sids)
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
    j = (torch.arange(t, dtype=torch.int64, device=dev) if tmap is None
         else tmap.to(torch.int64))[None, None, :]
    w0, w1, w2, w3 = philox4x32(_word(g), OMEGA, i, j,
                                k0, k1[:, None, None])
    half = torch.tensor(math.sqrt(0.5), dtype=torch.float32)
    sa = half * torch.sqrt(torch.tensor(float(nfreqs), dtype=torch.float32))
    mask = time_mask(t, ntimes, dev, row_times)
    obr, obi = bits_to_normals(w0, w1)
    oar, oai = bits_to_normals(w2, w3)
    ob = torch.complex(obr * half * mask, obi * half * mask)
    oa = torch.complex(oar * sa * mask, oai * sa * mask)
    return oa, ob


def omega_segments(seed: int, sids: torch.Tensor, g, n: int, idx,
                   nfreqs: int):
    """The omega fields of time groups, each at its own width: for each
    integer tensor of time indices in ``idx``, the pair ``(oa, ob)``
    complex64 (B, n, len) of :func:`omega_fields` at those times (the full
    fields gathered there). Returns ``(list of oa, list of ob)``."""
    pairs = [omega_fields(seed, sids, g, n, int(ix.shape[0]),
                          int(ix.shape[0]), nfreqs, tmap=ix) for ix in idx]
    return [p[0] for p in pairs], [p[1] for p in pairs]


GAMMA_CHUNK = 64  # Philox calls per bin held at once by gamma_draws


def gamma_draws(seed: int, sids: torch.Tensor, g: int, n: int,
                alpha: int) -> torch.Tensor:
    """(B, n) float32 Gamma(alpha) = -sum_r log(u_4r u_4r+1 u_4r+2 u_4r+3),
    uniforms at index >= alpha taken as exactly 1. The r axis is taken
    :data:`GAMMA_CHUNK` counters at a time (one chunk up to alpha = 256),
    so a long night (alpha ~ 1100) holds no ``(B, n, alpha)`` tensor."""
    dev = sids.device
    k0, k1 = _keys(seed, sids)
    nr = -(-alpha // 4)
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :, None]
    total = None
    for r0 in range(0, nr, GAMMA_CHUNK):
        r = torch.arange(r0, min(nr, r0 + GAMMA_CHUNK), dtype=torch.int64,
                         device=dev)[None, None, :]
        words = philox4x32(_word(g), GAMMA, i, r, k0,
                           k1[:, None, None])
        prod = None
        for q, wq in enumerate(words):
            u = torch.where(4 * r + q < alpha, uniform_open(wq),
                            torch.ones((), dtype=torch.float32, device=dev))
            prod = u if prod is None else prod * u
        part = torch.sum(torch.log(prod), dim=2)
        total = part if total is None else total + part
    return -total


def prior_uniforms(seed: int, sids: torch.Tensor, g: int,
                   count: int = N_PRIOR_UNIFORMS) -> torch.Tensor:
    """(B, 4 ceil(count/4)) float32 uniforms for the bounded prior bins
    (at least the 8 lanes of the megachain engine)."""
    k0, k1 = _keys(seed, sids)
    nr = max(2, -(-int(count) // 4))
    r = torch.arange(nr, dtype=torch.int64, device=sids.device)[None, :]
    words = philox4x32(_word(g), UNIFORM, 0, r, k0, k1[:, None])
    # (B, nr, 4): lane 4r + q
    return uniform_open(torch.stack(words, dim=2)).reshape(-1, 4 * nr)


# --- float64 draws of the complex engine (module docstring) ----------------

OMEGA64, GAMMA64, UNIFORM64 = 3, 4, 5


def uniform53(w_hi, w_lo) -> torch.Tensor:
    """(0, 1)-open float64 uniform from two words: 27 + 26 bits."""
    k = (w_hi >> 5) * (1 << 26) + (w_lo >> 6)
    return (k.to(torch.float64) + 0.5) * 2.0 ** -53


def complex_normal64(w0, w1, w2, w3):
    """One standard complex normal (E|z|^2 = 1) from the four words of one
    Philox call, by Box-Muller in float64."""
    u1 = uniform53(w0, w1)
    u2 = uniform53(w2, w3)
    r = torch.sqrt(-torch.log(u1))        # sqrt(-2 log u1) sqrt(1/2)
    th = (2.0 * math.pi) * u2
    return torch.complex(r * torch.cos(th), r * torch.sin(th))


_LAYOUTS = {}


def _layout64(ntimes: int, nfreqs: int, alpha: int, count: int, device):
    """The counter words ``(c1, c2, c3)`` (int64, (L,)) of one step's
    draws, in the order omegas ``(t, j)``, Gamma words ``(bin, r)``,
    uniform words ``r``; kept per shape and device, so a step builds none
    (and a graph's capture finds them made by its warm-up)."""
    key = (ntimes, nfreqs, alpha, count, str(device))
    if key not in _LAYOUTS:
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
        nj, nr, nu = 2 * nfreqs, -(-alpha // 2), max(1, -(-count // 2))
        parts = [(OMEGA64, ar(ntimes).repeat_interleave(nj),
                  ar(nj).repeat(ntimes)),
                 (GAMMA64, ar(nfreqs).repeat_interleave(nr),
                  ar(nr).repeat(nfreqs)),
                 (UNIFORM64, torch.zeros(nu, dtype=torch.int64,
                                         device=device), ar(nu))]
        _LAYOUTS[key] = tuple(torch.cat(c) for c in zip(*(
            (torch.full_like(c2, purpose), c2, c3)
            for purpose, c2, c3 in parts)))
    return _LAYOUTS[key]


def draws64(seed: int, sids: torch.Tensor, g, ntimes: int, nfreqs: int,
            alpha: int, count: int):
    """One step's float64 randomness of the chains ``sids`` at iteration
    ``g`` (see :func:`iteration`), from one Philox call over the counters
    of the module docstring: ``(omega_a, omega_b)`` complex128 (B, ntimes,
    nfreqs) standard complex normals, ``gam`` (B, nfreqs) Gamma(alpha) =
    -sum of the logs of ``alpha`` uniforms (integer alpha), and ``u`` (B,
    count) the uniforms of the bounded bins."""
    c1, c2, c3 = _layout64(ntimes, nfreqs, alpha, count, sids.device)
    k0, k1 = _keys(seed, sids)
    w = philox4x32(_word(g), c1, c2, c3, k0, k1[:, None])
    B = sids.shape[0]
    n_om, nr = ntimes * 2 * nfreqs, -(-alpha // 2)
    n_ga = nfreqs * nr
    z = complex_normal64(*(x[:, :n_om] for x in w)).reshape(B, ntimes, -1)
    ga = [x[:, n_om:n_om + n_ga].reshape(B, nfreqs, nr) for x in w]
    r = torch.arange(nr, dtype=torch.int64, device=sids.device)
    lu = torch.log(uniform53(ga[0], ga[1])).sum(dim=2)
    lu2 = torch.log(uniform53(ga[2], ga[3]))
    lu2 = torch.where(2 * r + 1 < alpha, lu2, torch.zeros_like(lu2))
    un = [x[:, n_om + n_ga:] for x in w]
    u = torch.stack((uniform53(un[0], un[1]), uniform53(un[2], un[3])),
                    dim=2).reshape(B, -1)[:, :count]
    return z[:, :, 0::2], z[:, :, 1::2], -(lu + lu2.sum(dim=2)), u
