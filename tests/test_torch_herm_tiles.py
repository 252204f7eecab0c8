"""The Hermitian inverse and factor-solve of the port (``herm_inv`` and
``herm_chol_solve``, whose kernels factor on 32 x 32 tiles): their plain
versions at ragged, padded and full tile widths against float64 numpy,
and the wrappers' contracts (shape, dtype and device errors, the launch
arguments, one launch up to 192 and the blocked route above). The card-side case holds the
kernels against their plain versions at the same widths and checks that
the identity maps to exactly the identity; ``chip_smoke.py`` runs the same
checks on the card. Port only, no JAX: the JAX pins of these functions are
in tests/test_torch_spd_inv.py, test_torch_spd_solve.py and
test_torch_wideband.py."""
import numpy as np
import pytest
import torch

from hydra_pspec_torch.ops.kernels import _build
from hydra_pspec_torch.ops.kernels import herm_inv as thi
from hydra_pspec_torch.ops.kernels import spd_solve as tss

# one ragged tile, one full, ragged second, third and fourth tiles, the
# real engine's 120, one short of full, full 128 (as chip_smoke.HERM_NS)
NS = (1, 17, 32, 52, 96, 120, 127, 128)
KS = (1, 33, 203)
B = 3
# float32 against float64 on equilibrated systems of condition <~ 1e2:
# relative to the largest entry of the float64 result
TOL = 1e-4


def _spd(n, seed, batch=B):
    """``batch`` Jacobi-equilibrated Hermitian PD matrices (float64)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((batch, n, 2 * n)) + 1j * rng.standard_normal(
        (batch, n, 2 * n))
    a = g @ g.conj().transpose(0, 2, 1) / (2 * n) + 0.05 * np.eye(n)
    d = 1 / np.sqrt(np.diagonal(a, axis1=1, axis2=2).real)
    return a * d[:, :, None] * d[:, None, :]


def _rhs(n, k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, k)) + 1j * rng.standard_normal((B, n, k))


def _c64(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.complex64)


def _rel(got, want):
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", NS)
def test_plain_herm_inv_matches_float64(n):
    a = _spd(n, n)
    assert _rel(thi.plain_herm_inv(_c64(a)), np.linalg.inv(a)) < TOL


@pytest.mark.parametrize("n,k", [(n, k) for n in NS for k in KS])
def test_plain_herm_chol_solve_matches_float64(n, k):
    a, b = _spd(n, 100 + n), _rhs(n, k, 200 + n + k)
    got = tss.plain_herm_chol_solve(_c64(a), _c64(b))
    assert _rel(got, np.linalg.solve(a, b)) < TOL


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, to reach the wrappers' card
    branch (with ``_build.on_cpu`` and ``_build.call`` replaced)."""

    @property
    def is_cuda(self):
        return True


def _fake(x):
    return torch.Tensor._make_subclass(_FakeCuda, x)


@pytest.fixture
def card_branch(monkeypatch):
    """The wrappers' card branch without a card: every operand counts as
    a CUDA tensor and each launch is recorded instead of made."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *xs: False)
    monkeypatch.setattr(_build, "call",
                        lambda kernel, entry, *args: calls.append(
                            (kernel, entry, args)))
    return calls


def test_contract_launch_arguments(card_branch):
    """One launch a call for n <= 128 with the shapes the C entries take
    (and no ``active`` mask unless one is given); herm_chol_solve passes no
    L scratch (L stays in shared memory)."""
    s = _fake(_c64(_spd(120, 1)))
    b = _fake(_c64(_rhs(120, 203, 2)))
    inv = thi.herm_inv(s)
    x = tss.herm_chol_solve(s, b)
    assert inv.shape == s.shape and x.shape == b.shape
    (k1, e1, a1), (k2, e2, a2) = card_branch
    assert (k1, e1, a1[2:]) == ("herm_inv", "hk_herm_inv",
                                (B, 120, None, None, None, 0.0, 0, None))
    assert (k2, e2) == ("herm_chol_solve", "hk_herm_chol_solve")
    assert a2[2] is None and a2[4:] == (B, 120, 203)


def test_contract_blocked_route(card_branch, monkeypatch):
    """Above 192 both go blocked: base launches of at most 192 and cgemm
    products (two and four for the inverse at n = 256, two and three for
    the solve at n = 300); ``base_n=128`` keeps the composition that
    served 128 < n <= 192 before (two and three at n = 180). The operand
    checks are skipped here: the blocks the recursions copy out are plain
    CPU tensors."""
    monkeypatch.setattr(_build, "check", lambda *args, **kw: None)
    thi.herm_inv(_c64(_spd(256, 3, batch=1)))
    tss.herm_chol_solve(_c64(_spd(300, 4, batch=1)),
                        _c64(_rhs(300, 5, 5)[:1]))
    tss.herm_chol_solve(_c64(_spd(180, 4, batch=1)),
                        _c64(_rhs(180, 5, 5)[:1]), base_n=128)
    kernels = [k for k, _, _ in card_branch]
    assert kernels[:6].count("herm_inv") == 2
    assert kernels[:6].count("cgemm") == 4
    assert kernels[6:11].count("herm_chol_solve") == 2
    assert kernels[6:11].count("cgemm") == 3
    assert kernels[11:].count("herm_chol_solve") == 2
    assert kernels[11:].count("cgemm") == 3
    base_n = [a[3] if k == "herm_inv" else a[5]
              for k, _, a in card_branch if k != "cgemm"]
    assert base_n == [192, 64, 192, 108, 128, 52]
    with pytest.raises(ValueError, match="base_n"):
        thi.herm_inv(_c64(_spd(8, 3, batch=1)), base_n=256)


def test_contract_gate_mode(card_branch, monkeypatch):
    """The drift gate in the ``herm_inv`` launch: up to 192 (n = 120 and
    180) one launch with the bandpowers, ``drift_max``, their width and
    the flags' buffer, no ``active`` and no products; blocked at n = 256
    the first base launch (192) takes the gate and the second base launch
    (64) and the four products read its flags as ``active``. ``active``
    and ``gate`` together, and bandpowers of the wrong shape, are
    refused."""
    s = _fake(_c64(_spd(120, 11)))
    ps, psx = _fake(torch.rand(B, 120)), _fake(torch.rand(B, 120))
    rebuild = _fake(torch.zeros(B, dtype=torch.int32))
    out = _fake(torch.zeros_like(s))
    assert thi.herm_inv(s, out=out, gate=(ps, psx, 0.6),
                        rebuild=rebuild) is out
    (kernel, entry, args), = card_branch
    assert (kernel, entry) == ("herm_inv", "hk_herm_inv")
    assert args[2:] == (B, 120, None, ps.data_ptr(), psx.data_ptr(),
                        0.6, 120, rebuild.data_ptr())
    with pytest.raises(ValueError, match="active or gate"):
        thi.herm_inv(s, out=out, active=rebuild, gate=(ps, psx, 0.6))
    with pytest.raises(ValueError, match="psx"):
        thi.herm_inv(s, out=out, gate=(ps, _fake(torch.rand(B, 7)), 0.6))
    card_branch.clear()
    s = _fake(_c64(_spd(180, 13)))
    ps, psx = _fake(torch.rand(B, 180)), _fake(torch.rand(B, 180))
    assert thi.herm_inv(s, out=_fake(torch.zeros_like(s)),
                        gate=(ps, psx, 0.6), rebuild=rebuild) is not None
    (kernel, entry, args), = card_branch
    assert (kernel, entry) == ("herm_inv", "hk_herm_inv")
    assert args[2:] == (B, 180, None, ps.data_ptr(), psx.data_ptr(),
                        0.6, 180, rebuild.data_ptr())
    card_branch.clear()
    monkeypatch.setattr(_build, "check", lambda *args, **kw: None)
    ps, psx = torch.rand(1, 256), torch.rand(1, 256)
    flags = torch.zeros(1, dtype=torch.int32)
    thi.herm_inv(_c64(_spd(256, 12, batch=1)), out=torch.zeros(
        1, 256, 256, dtype=torch.complex64), gate=(ps, psx, 0.3),
        rebuild=flags)
    herm = [a for k, _, a in card_branch if k == "herm_inv"]
    assert [k for k, _, _ in card_branch].count("cgemm") == 4
    assert [a[3] for a in herm] == [192, 64]
    assert herm[0][4:] == (None, ps.data_ptr(), psx.data_ptr(), 0.3, 256,
                           flags.data_ptr())
    assert herm[1][4:] == (flags.data_ptr(), None, None, 0.0, 0, None)


# one launch on the lower tiles (one over a tile boundary, a ragged fifth
# tile, the wide band's 180, full 192), then the blocked route (192 + 1,
# 192 + 64, 192 + 108)
ROUTE_NS = (129, 140, 180, 192, 193, 256, 300)


@pytest.mark.parametrize("n", ROUTE_NS)
def test_contract_route(card_branch, monkeypatch, n):
    """Both wrappers up to 192: one launch with the whole n and no
    products; above: base launches of at most 192, one a leaf of the
    split (192 and n - 192), and the products (four for the inverse,
    three for the solve). The operand checks are skipped here: the blocks
    the recursions copy out are plain CPU tensors."""
    monkeypatch.setattr(_build, "check", lambda *args, **kw: None)
    leaves = [n] if n <= 192 else [192, n - 192]
    thi.herm_inv(_fake(_c64(_spd(n, 20 + n, batch=1))))
    got = [(k, a[3] if k == "herm_inv" else None) for k, _, a in card_branch]
    assert [b for k, b in got if k == "herm_inv"] == leaves
    assert [k for k, _ in got].count("cgemm") == 4 * (len(leaves) - 1)
    card_branch.clear()
    tss.herm_chol_solve(_fake(_c64(_spd(n, 30 + n, batch=1))),
                        _fake(_c64(_rhs(n, 3, n)[:1])))
    got = [(k, a[5] if k == "herm_chol_solve" else None)
           for k, _, a in card_branch]
    assert [b for k, b in got if k == "herm_chol_solve"] == leaves
    assert [k for k, _ in got].count("cgemm") == 3 * (len(leaves) - 1)


@pytest.mark.parametrize("what", ["not_square", "rhs_rows", "dtype"])
def test_contract_shape_and_dtype_errors(card_branch, what):
    s = _c64(_spd(32, 6))
    b = _c64(_rhs(32, 4, 7))
    if what == "not_square":
        with pytest.raises(ValueError, match=r"\(B, n, n\)"):
            thi.herm_inv(_fake(s[:, :, :31].contiguous()))
        with pytest.raises(ValueError, match=r"\(B, n, n\)"):
            tss.herm_chol_solve(_fake(s[:, :31].contiguous()), _fake(b))
    elif what == "rhs_rows":
        with pytest.raises(ValueError, match="shape"):
            tss.herm_chol_solve(_fake(s), _fake(b[:, :31].contiguous()))
    else:
        with pytest.raises(ValueError, match="dtype"):
            thi.herm_inv(_fake(s.to(torch.complex128)))
        with pytest.raises(ValueError, match="dtype"):
            tss.herm_chol_solve(_fake(s), _fake(b.to(torch.complex128)))
    assert card_branch == []


def test_contract_device_errors():
    """Operands on the CPU and elsewhere, or on a device that is neither
    the CPU nor CUDA, are refused before any launch."""
    s = _c64(_spd(17, 8))
    b = _c64(_rhs(17, 2, 9))
    for args in ((s.to("meta"),), (s, b.to("meta"))):
        fn = thi.herm_inv if len(args) == 1 else tss.herm_chol_solve
        with pytest.raises(ValueError, match="devices"):
            fn(*args)


@pytest.mark.cuda
def test_tile_kernels_on_card():
    """The kernels against their plain versions on the card at every width
    of NS and K of KS (1e-3 of the largest entry, as chip_smoke.py), and
    exactly the identity on the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run python3 chip_smoke.py "
                    "on the card)")
    dev = torch.device("cuda", 0)
    for n in NS:
        a = _c64(_spd(n, 10 + n)).to(dev)
        eye = torch.eye(n, dtype=a.dtype, device=dev).expand(B, n, n)
        eye = eye.contiguous()
        want = thi.plain_herm_inv(a)
        assert float((thi.herm_inv(a) - want).abs().max()
                     / want.abs().max()) <= 1e-3
        assert torch.equal(thi.herm_inv(eye), eye)
        for k in KS:
            b = _c64(_rhs(n, k, 20 + n + k)).to(dev)
            want = tss.plain_herm_chol_solve(a, b)
            assert float((tss.herm_chol_solve(a, b) - want).abs().max()
                         / want.abs().max()) <= 1e-3
            assert torch.equal(tss.herm_chol_solve(eye, b), b)
