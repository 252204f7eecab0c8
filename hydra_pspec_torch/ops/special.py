"""Regularized incomplete gamma functions with fixed iteration counts (port
of ``hydra_pspec_tpu/ops/special.py:27-112``), for the complex float64
engine's truncated inverse-gamma draw.

The classic split: the power series for ``x < a + 1`` and the continued
fraction for ``x >= a + 1``, each truncated at a static count (256 terms
and 127 fraction levels by default, :func:`iters_for_shape` for large
shape parameters); both are evaluated for every element and the one that
applies is selected, so no control flow depends on the data.

The values are those of the JAX loops (the same truncated sum, the same
convergent of the fraction), evaluated in a handful of tensor operations
instead of one per term: the series as a cumulative product of the term
ratios, and the fraction's convergent ``Q_N / P_N`` from its three-term
recurrence, written as the product of the 2 x 2 matrices ``[[b_k, a_k],
[1, 0]]`` and multiplied pairwise in a tree (each product rescaled by its
largest entry, which leaves the ratio unchanged). The JAX package's modified
Lentz loop needs a launch per level on a GPU; the tree needs
``log2(count)`` rounds (:func:`_upper_cf`).
"""
import math

import torch

_SERIES_ITERS = 256
_CF_ITERS = 128


def iters_for_shape(a_max: float) -> tuple:
    """Static (series, cf) counts sufficient for shape parameters up to
    ``a_max`` (about 1e-6 relative; ``special.py:27-36``)."""
    s = max(_SERIES_ITERS, int(7.0 * math.sqrt(max(a_max, 1.0))) + 32)
    c = max(_CF_ITERS, int(4.0 * math.sqrt(max(a_max, 1.0))) + 32)
    return s, c


def _log_prefactor(a, x):
    """log(x^a e^-x / Gamma(a)), the prefactor of both branches."""
    safe_x = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    return a * torch.log(safe_x) - safe_x - torch.lgamma(a)


def _lower_series(a, x, iters=_SERIES_ITERS):
    """Regularized lower P(a, x) by its power series (accurate for
    x < a + 1): ``pref * sum_{k < iters} x^k / (a (a+1) ... (a+k))``."""
    k = torch.arange(1, iters, dtype=x.dtype, device=x.device)
    terms = torch.cumprod(x[..., None] / (a[..., None] + k), dim=-1)
    total = (1.0 + terms.sum(dim=-1)) / a
    return torch.exp(_log_prefactor(a, x)) * total


def _upper_cf(a, x, iters=_CF_ITERS):
    """Regularized upper Q(a, x) by the continued fraction (accurate for
    x >= a + 1): ``pref / (b_0 + a_1 / (b_1 + ... a_N / b_N))`` with
    ``a_i = -i (i - a)``, ``b_i = x + 2 i + 1 - a``, N = iters - 1.

    The convergent is ``Q_N / P_N`` of ``[[P_k, Q_k], [P_k-1, Q_k-1]] =
    M_k ... M_0`` with ``M_k = [[b_k, a_k], [1, 0]]`` (``a_0 = 1``). The
    factors are padded on the left to a power of two with ``[[1, 0], [1,
    0]]``, which keeps the first row of any product, and multiplied in
    pairs: the first round in closed form (``M_2j+1 M_2j = [[b' b + a',
    b' a], [b, a]]``), the later ones as general 2 x 2 products, each
    rescaled by its largest entry."""
    i = torch.arange(iters, dtype=x.dtype, device=x.device)
    width = max(2, 1 << (iters - 1).bit_length())
    bk = x[..., None] + (2.0 * i + 1.0) - a[..., None]
    ak = torch.where(i == 0, torch.ones_like(bk), -i * (i - a[..., None]))
    if width != iters:
        bk = torch.nn.functional.pad(bk, (0, width - iters), value=1.0)
        ak = torch.nn.functional.pad(ak, (0, width - iters), value=0.0)
    b0, b1, a0, a1 = bk[..., 0::2], bk[..., 1::2], ak[..., 0::2], ak[..., 1::2]
    m = [b1 * b0 + a1, b1 * a0, b0, a0]
    while m[0].shape[-1] > 1:
        # pair (2j, 2j+1) -> M_{2j+1} M_{2j}, later factors on the left
        l00, l01, l10, l11 = (e[..., 1::2] for e in m)
        r00, r01, r10, r11 = (e[..., 0::2] for e in m)
        m = [l00 * r00 + l01 * r10, l00 * r01 + l01 * r11,
             l10 * r00 + l11 * r10, l10 * r01 + l11 * r11]
        s = torch.maximum(torch.maximum(m[0].abs(), m[1].abs()),
                          torch.maximum(m[2].abs(), m[3].abs()))
        s = torch.where(s > 0, s, torch.ones_like(s))
        m = [e / s for e in m]
    # the fraction is Q_N / P_N, the first row's ratio
    h = m[1][..., 0] / m[0][..., 0]
    return torch.exp(_log_prefactor(a, x)) * h


def on_device(v, device):
    """``v`` as a tensor on ``device``; a Python number is filled there
    (no host-to-device copy, so the call may sit in a CUDA graph)."""
    if torch.is_tensor(v):
        return v.to(device)
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float64, device=device)
    return torch.as_tensor(v, device=device)


def input_device(device, *xs) -> torch.device:
    """Where a public function with a ``device`` argument computes: on
    the device of its tensor inputs when it has any, else on ``device``."""
    return next((x.device for x in xs if torch.is_tensor(x)),
                torch.device(device))


def as_input(v, device, dtype=None):
    """``v`` as an input tensor: a tensor keeps its own device (cast to
    ``dtype`` when given); an array or a number becomes a tensor on
    ``device``."""
    if torch.is_tensor(v):
        return v if dtype is None else v.to(dtype)
    return torch.as_tensor(v, dtype=dtype, device=device)


def gammaincc_fixed(a, x, iters=None):
    """Regularized upper incomplete gamma Q(a, x) with static counts
    ``iters = (series, cf)`` (default (256, 128)); ``a`` and ``x``
    broadcast, computed in at least float32 (float64 when either is)."""
    s_it, c_it = iters if iters is not None else (_SERIES_ITERS, _CF_ITERS)
    x = torch.as_tensor(x)
    a = on_device(a, x.device)
    dt = torch.promote_types(torch.promote_types(a.dtype, x.dtype),
                             torch.float32)
    a, x = torch.broadcast_tensors(a.to(dt), x.to(dt))
    use_series = x < a + 1.0
    # each branch's argument clamped into its region: the value of the
    # other branch is discarded but must stay finite
    xs = torch.minimum(x, a + 1.0)
    xc = torch.maximum(x, a + 1.0)
    q = torch.where(use_series, 1.0 - _lower_series(a, xs, s_it),
                    _upper_cf(a, xc, c_it))
    q = torch.where(x <= 0, torch.ones_like(q), q)
    return torch.clamp(q, 0.0, 1.0)


def gammainc_fixed(a, x, iters=None):
    """Regularized lower incomplete gamma P(a, x)."""
    return 1.0 - gammaincc_fixed(a, x, iters=iters)
