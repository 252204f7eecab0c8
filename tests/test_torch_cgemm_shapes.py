"""The port's cgemm at the port's own product shapes (n = 120 channels,
t = 204 or 203 times, m = 12 modes) against the JAX package's product
``_cmm`` (``hydra_pspec_tpu/ops/pallas/megastep.py:41``), and the
wrapper's launch contract.

On the CPU the wrapper takes its plain version. The kernel's tiles run on
the card only: the CUDA-marked case here, and ``python3 chip_smoke.py
--cgemm OUT PARENT``, which holds every product torch.equal to a parent
checkout's kernel. Serially, about 5 s:
``env JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cgemm_shapes.py``.
"""
import inspect
import re

import numpy as np
import pytest
import torch

from hydra_pspec_torch.ops.kernels import _build
from hydra_pspec_torch.ops.kernels import cgemm as tcg

B = 2
# what -> (M, K, N, op, A shared, X, alpha): X None, "x" (its own tensor)
# or "out" (C aliases X); beta 1
SHAPES = {
    "F rc": (120, 120, 204, "N", True, None, 1.0),
    "F^H sk / n": (120, 120, 204, "H", True, None, 1.0 / 120),
    "x += inv r, out=x": (120, 120, 204, "N", False, "out", 1.0),
    "b_a = Fg^H rc (M=12)": (12, 120, 204, "H", False, None, 1.0),
    "rc - G b_a (K=12)": (120, 12, 204, "N", False, "x", -1.0),
    "real F rc (t=203)": (120, 120, 203, "N", True, None, 1.0),
}


def _operands(shape, batch, seed):
    """complex64 numpy operands (a, b, x) of one product; ``a`` in its
    stored order ((M, K) for op N, (K, M) for op H)."""
    M, K, N, op, shared, xmode, _ = shape
    rng = np.random.default_rng(seed)

    def crandn(*s):
        return ((rng.standard_normal(s) + 1j * rng.standard_normal(s))
                / np.sqrt(2)).astype(np.complex64)

    dims = (M, K) if op == "N" else (K, M)
    a = crandn(*dims) if shared else crandn(batch, *dims)
    x = crandn(batch, M, N) if xmode else None
    return a, crandn(batch, K, N), x


def _op(a, op):
    at = np.swapaxes(a, -2, -1)
    return a if op == "N" else at.conj()


def _jax_cmm(aop, b):
    """The JAX package's Gauss 3-mult product of 3-pass bf16-split
    matmuls, batched, as complex128."""
    import jax.numpy as jnp
    from hydra_pspec_tpu.ops.pallas.megastep import _cmm

    aop = np.broadcast_to(aop, (b.shape[0],) + aop.shape[-2:])
    f = lambda z: jnp.asarray(np.ascontiguousarray(z), jnp.float32)
    r, i = _cmm(f(aop.real), f(aop.imag), f(b.real), f(b.imag))
    return np.asarray(r, np.float64) + 1j * np.asarray(i, np.float64)


@pytest.mark.parametrize("what", list(SHAPES))
def test_against_jax_cmm(what):
    """alpha op(A) B + X from the port's cgemm (its plain version here)
    against the JAX product with the same epilogue in float64: the JAX
    product is f32 grade with its own cancellation, so 1e-4 of the mean
    magnitude, as tests/test_torch_spd_inv.py holds ``_cmm``."""
    shape = SHAPES[what]
    M, K, N, op, shared, xmode, alpha = shape
    a, b, x = _operands(shape, B, seed=len(what))
    want = alpha * _jax_cmm(_op(a, op), b)
    if x is not None:
        want = want + x
    xt = None if x is None else torch.from_numpy(x.copy())
    got = tcg.cgemm(torch.from_numpy(a), torch.from_numpy(b), op=op, x=xt,
                    alpha=alpha, out=xt if xmode == "out" else None)
    if xmode == "out":
        assert got is xt
    assert got.shape == (B, M, N) and got.dtype == torch.complex64
    err = np.abs(got.numpy() - want).max() / np.abs(want).mean()
    assert err < 1e-4, err


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, to reach the wrapper's card
    branch (with ``_build.on_cpu`` and ``_build.call`` replaced)."""

    @property
    def is_cuda(self):
        return True


def _fake(x):
    return torch.Tensor._make_subclass(_FakeCuda, x)


@pytest.fixture
def card_branch(monkeypatch):
    """The wrapper's card branch without a card: each launch is recorded
    instead of made."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *xs: False)
    monkeypatch.setattr(_build, "call",
                        lambda kernel, entry, *args: calls.append(
                            (kernel, entry, args)))
    return calls


def test_c_signature_unchanged():
    """``hk_cgemm`` keeps its C arguments (a parent checkout's library is
    swapped in under the same wrapper for the in-turn comparisons); the
    checks' tile entry takes the same ones and the tile before the
    stream, the plan's query the batch and M, N, K."""
    P, I, F = _build.P, _build.I, _build.F
    sig = [P, P, P, P, I, I, I, I, I, I, F, F, P, P]
    assert _build.SIGNATURES["hk_cgemm"] == sig
    assert _build.SIGNATURES["hk_cgemm_tile"] == sig[:-1] + [I, P]
    assert _build.SIGNATURES["hk_cgemm_plan"] == [I, I, I, I]


def test_contract_plan_and_tile(card_branch):
    """One ``hk_cgemm`` launch with the shape as the C entry takes it: the
    tile plan is the launcher's, and the wrapper has no tile to choose.
    ``TILES`` names the kernel's tiles (BM x BN, K tile), one each."""
    shape = SHAPES["F^H sk / n"]
    a, b, _ = _operands(shape, 3, seed=1)
    at, bt = _fake(torch.from_numpy(a)), _fake(torch.from_numpy(b))
    got = tcg.cgemm(at, bt, op="H", alpha=0.5)
    [(kernel, entry, args)] = card_branch
    assert (kernel, entry) == ("cgemm", "hk_cgemm")
    assert args[2] is None and args[4:] == (3, 120, 204, 120, 2, 0, 0.5,
                                            1.0, None)
    assert got.shape == (3, 120, 204) and got.dtype == torch.complex64
    assert "tile" not in inspect.signature(tcg.cgemm).parameters
    assert len(set(tcg.TILES)) == len(tcg.TILES) == 5
    assert all(re.fullmatch(r"\d+x\d+ k\d+", t) for t in tcg.TILES)


@pytest.mark.parametrize("fault", ["out aliases b", "batch of a"])
def test_contract_rejects(card_branch, fault):
    """On the card branch a product the kernel cannot take raises before
    any launch: ``out`` on an operand's memory, or a per-chain ``a`` of
    another batch than ``b``."""
    shape = SHAPES["x += inv r, out=x"]
    a, b, _ = _operands(shape, 3, seed=2)
    at, bt = _fake(torch.from_numpy(a)), _fake(torch.from_numpy(b))
    with pytest.raises(ValueError, match="alias|shape"):
        if fault == "out aliases b":
            tcg.cgemm(at, bt, out=bt)
        else:
            tcg.cgemm(at[:2], bt)
    assert card_branch == []


def _on_tile(tile, a, b, op, x, alpha):
    """The product on the kernel's tile ``tile`` (an index of
    ``cgemm.TILES``) through the C entry the checks use."""
    B, K, N = b.shape
    M = a.shape[-2] if op == "N" else a.shape[-1]
    out = torch.empty((B, M, N), dtype=torch.complex64, device=b.device)
    _build.call("cgemm", "hk_cgemm_tile", _build.ptr(a), _build.ptr(b),
                _build.ptr(x), _build.ptr(out), B, M, N, K, tcg.OPS[op],
                int(a.dim() == 3), float(alpha), 1.0, None, tile)
    return out


@pytest.mark.cuda
def test_kernel_on_card():
    """On the card at B = 100: each product against its plain version
    (1e-5 of the magnitude its sums run over, as chip_smoke.py), and
    torch.equal on chain slices of 1, 7 and 92 and on every tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "--cgemm OUT PARENT on the card)")
    dev = torch.device("cuda", 0)
    for what, shape in SHAPES.items():
        M, K, N, op, shared, xmode, alpha = shape
        a, b, x = (None if v is None else torch.from_numpy(v).to(dev)
                   for v in _operands(shape, 100, seed=3))
        got = tcg.cgemm(a, b, op=op, x=x, alpha=alpha)
        want = tcg.plain_cgemm(a, b, op=op, x=x, alpha=alpha)
        aop = a if op == "N" else a.transpose(-2, -1)
        mag = abs(alpha) * torch.matmul(aop.abs(), b.abs())
        mag = mag if x is None else mag + x.abs()
        assert float((got - want).abs().max()) <= 1e-5 * float(mag.max())
        parts = [tcg.cgemm(a if shared else a[lo:hi], b[lo:hi], op=op,
                           x=None if x is None else x[lo:hi], alpha=alpha)
                 for lo, hi in ((0, 1), (1, 8), (8, 100))]
        assert torch.equal(torch.cat(parts), got), what
        for tile in range(len(tcg.TILES)):
            assert torch.equal(_on_tile(tile, a, b, op, x, alpha),
                               got), (what, tcg.TILES[tile])
