"""The two implementations of the chain's building blocks.

``KERNELS`` holds the wrappers of the hand-written CUDA kernels (which
take the plain version for CPU tensors). ``PLAIN`` holds the plain torch
versions themselves, which run on any device: ``chip_smoke.py`` uses them
to hold the kernel path against the plain path on the card and to time
both."""
from typing import Callable, NamedTuple

from . import cgemm as _cg
from . import draw_fused as _df
from . import herm_inv as _hi
from . import rng_bandpower as _rb
from . import spd_solve as _ss


class Impl(NamedTuple):
    cgemm: Callable
    herm_inv: Callable
    herm_chol_solve: Callable
    draw_rhs: Callable
    draw_system: Callable
    row_scale_sumsq: Callable
    draw_resid: Callable
    rng_fields: Callable
    bandpower: Callable
    rng_segments: Callable


KERNELS = Impl(_cg.cgemm, _hi.herm_inv, _ss.herm_chol_solve, _df.draw_rhs,
               _df.draw_system, _df.row_scale_sumsq, _df.draw_resid,
               _rb.rng_fields, _rb.bandpower, _rb.rng_segments)
PLAIN = Impl(_cg.plain_cgemm, _hi.plain_herm_inv, _ss.plain_herm_chol_solve,
             _df.plain_draw_rhs, _df.plain_draw_system,
             _df.plain_row_scale_sumsq, _df.plain_draw_resid,
             _rb.plain_rng_fields, _rb.plain_bandpower,
             _rb.plain_rng_segments)
