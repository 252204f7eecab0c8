"""Work of the complex products one Gibbs iteration needs outside its
solve (the ``cgemm`` kernel's share of ``work/megachain.py``), at the
cell's true widths: ``Fg^H rc``, ``rc - G b_a``, ``F rc``, ``F^H sk``,
``Maa^-1 b_a``, ``G^H s``, ``Fg da``, and with time flags ``F (w s)``.

The solve's own products (a factor, sweeps, an inverse's application or
refresh) are left out: the least solve is no product of this list, so
what the program spends on them counts against the share. Bytes: the
operators ``F``, ``Fg``, ``G`` and ``Maa^-1`` read once; the fields these
products pass between them can stay on chip in a fused design, so they
are not counted, and the bound is that of the operations.
"""


def iteration(chains: int, n: int, m: int, group_times) -> dict:
    T = sum(group_times)
    flagged = len(group_times) > 1
    cmacs = 4 * m * n * T + 2 * n * n * T + m * m * T + (
        n * n * T if flagged else 0)
    return {"products": 8.0 * cmacs * chains,
            "bytes": float(8 * (n * n + chains * (2 * n * m + m * m)))}
