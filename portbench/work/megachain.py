"""Work of one Gibbs iteration of ``gcr_megachain`` (the chain layer: the
whole iteration), counted from what the sampler's mathematics needs at the
cell's true widths, never from the launches or layout of the program.

Per chain, with ``n`` channels, ``m`` foreground modes and its time groups
of ``T_g`` times (``T`` in all; one group without time flags), in complex
multiply-adds (8 real flops each):

* the foreground Schur reduction ``Fg^H rc`` and ``rc - G b_a``: 2 m n T;
* the delay transform ``F rc``: n^2 T;
* the Hermitian solve of the delay-basis system, the least a dense solve
  needs: a Cholesky factor per group, n^3 / 6, and the two triangular
  sweeps, n^2 T (a carried inverse, a refresh or a refinement is more);
* the back-transform ``F^H sk``: n^2 T; the amplitudes ``Maa^-1 b_a`` and
  ``G^H s``: m^2 T + m n T; the foreground model ``Fg da``: m n T;
* with channel weights (time flags), the masked delay power ``F (w s)``:
  n^2 T.

Other operations, each priced as one FP32 operation: a Philox4x32-10 call
(10 rounds: two 32 x 32 -> 64-bit products as four, four xors, two key
additions) and two Box-Muller pairs (log, square root, cosine, sine, two
conversions, four products each) per drawn (channel, time) lane; the
Gamma draw's ``ceil(alpha / 4)`` Philox calls and ``alpha`` logarithms per
bin and chain; the system's scaling (4 n^2 a group); about 30 operations
of the passes per (channel, time) lane.

Bytes: the least the data needs: each baseline's visibilities once (its
chains share them), the modes, and each chain's bandpowers in and out.
"""
PHILOX_OPS = 10 * 10
BOX_MULLER_OPS = 10
LANE_OPS = 30


def iteration(chains: int, baselines: int, n: int, m: int, group_times,
              alpha: int) -> dict:
    """``{"products", "other", "bytes"}`` of one iteration of ``chains``
    chains (of ``baselines`` baselines) with the time groups
    ``group_times``."""
    T = sum(group_times)
    G = len(group_times)
    flagged = G > 1
    cmacs = (4 * m * n * T + 3 * n * n * T + G * n ** 3 / 6 + m * m * T
             + (n * n * T if flagged else 0))
    lanes = n * T
    other = (lanes * (PHILOX_OPS + 2 * BOX_MULLER_OPS + LANE_OPS)
             + n * (-(-alpha // 4) * PHILOX_OPS + alpha) + 4 * G * n * n)
    nbytes = baselines * 8 * n * T + 8 * n * m + chains * (8 * n + 8)
    return {"products": 8.0 * cmacs * chains, "other": float(other * chains),
            "bytes": float(nbytes)}
