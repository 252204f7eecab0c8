"""Time-dependent flags: times grouped by flag pattern, one set of chain
operators per group (port of ``hydra_pspec_tpu/models/tflags.py:36-51,
168-184``; numpy only, so the groups equal the JAX package's exactly).

The reference collapses time-dependent flags to "any time flagged" per
channel (``run-hydra-pspec.py:541``, a FIXME), so one short RFI burst
removes a channel for the whole night. Here the times that share a flag
row form a group with its own per-channel weights; within a group the GCR
operator is constant, and the bandpower draw pools the delay statistics of
all groups (``models/megachain.py``, grouped mode).

Not ported yet: the complex-engine step (``gibbs_step_tflags``,
ROADMAP.md Queue 1 item 10) and the real-engine step
(``gibbs_step_tflags_real``, Queue 1 item 9).
"""
from typing import NamedTuple

import numpy as np

from . import rgibbs


class TimeGroupReal(NamedTuple):
    ops: rgibbs.RChainOperators
    idx: np.ndarray  # time indices of this group, increasing


def group_flag_patterns(flags_tf: np.ndarray):
    """Group times by identical flag row. ``flags_tf``: (Ntimes, Nfreqs)
    bool, True = flagged. Returns ``[(w_g, idx_g), ...]`` in order of first
    appearance, ``w_g`` the per-channel weights (1 = keep) and ``idx_g``
    the group's time indices (not necessarily contiguous)."""
    flags_tf = np.asarray(flags_tf, dtype=bool)
    _, first, inverse = np.unique(flags_tf, axis=0, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    groups = []
    for uidx in np.argsort(first):
        idx = np.nonzero(inverse == uidx)[0]
        groups.append(((~flags_tf[idx[0]]).astype(float), idx))
    return groups


def build_grouped_operators_real(vis, flags_tf, fgmodes, ninv,
                                 dtype=np.float32):
    """Per-group batch-of-one chain operators of one baseline."""
    vis = np.asarray(vis)
    return [TimeGroupReal(ops=rgibbs.build_chain_operators(
                vis[idx], w_g, fgmodes, ninv, dtype=dtype), idx=idx)
            for w_g, idx in group_flag_patterns(flags_tf)]
