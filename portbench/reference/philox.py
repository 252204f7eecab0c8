"""Philox4x32-10 streams of the sampler under test, in NumPy.

A frozen copy of the stream layout the program documents (its
``ops/philox.py``): the key is ``(run seed, stream id)``, the counter
``(iteration, purpose, i, j)``, so a chain's random numbers depend on
(seed, stream id, iteration) only. The reference redraws them here, in
float64 from the same 32-bit words, and takes nothing from the program.

Purposes: ``OMEGA`` (0): counter ``(g, 0, channel i, time lane j)``, words
0-1 the frequency-basis omega, words 2-3 the delay-basis omega (Box-Muller,
scaled sqrt(1/2), the delay one also sqrt(nfreqs)); ``GAMMA`` (1): counter
``(g, 1, bin i, r)``, the uniforms ``4r .. 4r+3`` of ``Gamma(alpha) = -sum
log u`` (integer alpha); ``UNIFORM`` (2): counter ``(g, 2, 0, r)``, the
uniform of bounded prior bin ``4r + q`` in word q.

Grouped time flags: row ``g`` of a chain with stream ``sid`` draws its
omegas on ``sid * G_key + g`` (``G_key`` the power of two at or above the
group count), at the row's own time lanes; the chain's Gamma and uniform
words are keyed on ``sid + 2^30``.
"""
import math

import numpy as np

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
OMEGA, GAMMA, UNIFORM = 0, 1, 2
CHAIN_STREAM_OFFSET = 1 << 30
MIN_UNIFORM_WORDS = 2   # the program draws at least 8 prior uniforms


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on uint64 arrays holding uint32 values (broadcast)."""
    u = lambda x: np.asarray(x, dtype=np.uint64)
    c0, c1, c2, c3, k0, k1 = (u(x) for x in (c0, c1, c2, c3, k0, k1))
    m = np.uint64(MASK32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(W0)) & m
            k1 = (k1 + np.uint64(W1)) & m
        p0 = np.uint64(M0) * c0
        p1 = np.uint64(M1) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m)
    return c0, c1, c2, c3


def uniform_open(bits):
    """(0, 1)-open uniform from the top 24 bits of a word."""
    return (bits >> np.uint64(8)).astype(np.float64) * 2.0 ** -24 \
        + 2.0 ** -25


def _normals(b1, b2):
    u1 = uniform_open(b1)
    u2 = (b2 >> np.uint64(8)).astype(np.float64) * 2.0 ** -24
    r = np.sqrt(-2.0 * np.log(u1))
    th = 2.0 * math.pi * u2
    return r * np.cos(th), r * np.sin(th)


def key_group(group: int) -> int:
    g = 1
    while g < group:
        g *= 2
    return g


def omegas(seed: int, sid: int, g: int, n: int, lanes: int, nfreqs: int):
    """``(oa, ob)`` complex128 ``(n, lanes)`` of stream ``sid`` at iteration
    ``g``: ``oa`` in the delay basis (covariance ``nfreqs`` I), ``ob`` in
    the channel basis (standard complex normal)."""
    i = np.arange(n, dtype=np.uint64)[:, None]
    j = np.arange(lanes, dtype=np.uint64)[None, :]
    w0, w1, w2, w3 = philox4x32(g & MASK32, OMEGA, i, j, seed & MASK32,
                                sid & MASK32)
    half = math.sqrt(0.5)
    obr, obi = _normals(w0, w1)
    oar, oai = _normals(w2, w3)
    sa = half * math.sqrt(nfreqs)
    return (oar + 1j * oai) * sa, (obr + 1j * obi) * half


def gamma(seed: int, sid: int, g: int, n: int, alpha: int):
    """(n,) Gamma(alpha) draws, ``-sum log u`` over ``alpha`` uniforms."""
    nr = -(-alpha // 4)
    i = np.arange(n, dtype=np.uint64)[:, None]
    r = np.arange(nr, dtype=np.uint64)[None, :]
    words = philox4x32(g & MASK32, GAMMA, i, r, seed & MASK32, sid & MASK32)
    total = np.zeros(n)
    for q, w in enumerate(words):
        keep = (4 * np.arange(nr) + q) < alpha
        total += np.sum(np.log(uniform_open(w)) * keep[None, :], axis=1)
    return -total


def prior_uniforms(seed: int, sid: int, g: int, count: int):
    """The uniforms of the bounded prior bins, lane l for bounded bin l."""
    nr = max(MIN_UNIFORM_WORDS, -(-count // 4))
    r = np.arange(nr, dtype=np.uint64)
    words = philox4x32(g & MASK32, UNIFORM, 0, r, seed & MASK32,
                       sid & MASK32)
    return uniform_open(np.stack(words, axis=1)).reshape(-1)[:count]
