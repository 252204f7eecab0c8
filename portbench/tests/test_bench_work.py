"""The work counts behind the roofline shares: algorithmic at the cells'
true widths, priced against the stated peaks, and no kernel's count above
the iteration's."""
import importlib.util

import pytest

import bench_util  # noqa: F401  (puts portbench on the path)
import harness
import peaks

CELLS = {"h1c_main": (120, [203]), "p1wide_main": (180, [203]),
         "h1c_rfi": (120, [70, 80, 53])}


def _load(rel):
    spec = importlib.util.spec_from_file_location(rel, harness.HERE / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MEGA, CGEMM = _load("work/megachain.py"), _load("work/cgemm.py")


def _bound(w):
    return peaks.bound_seconds(w["products"], w["other"], w["bytes"])


def test_counts_by_hand():
    # n = 2, m = 1, T = 3, one chain of one baseline, alpha = 2
    w = MEGA.iteration(1, 1, 2, 1, [3], 2)
    cmacs = 4 * 1 * 2 * 3 + 3 * 4 * 3 + 8 / 6 + 1 * 3
    assert w["products"] == 8 * cmacs
    lanes = 2 * 3
    other = lanes * (100 + 20 + 30) + 2 * (1 * 100 + 2) + 4 * 4
    assert w["other"] == other
    assert w["bytes"] == 8 * 2 * 3 + 8 * 2 + 8 * 2 + 8
    c = CGEMM.iteration(1, 2, 1, [3])
    assert c["products"] == 8 * (4 * 6 + 2 * 12 + 3)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_count_within_the_iteration(cell):
    n, groups = CELLS[cell]
    w = MEGA.iteration(100, 25, n, 12, groups, 202)
    c = CGEMM.iteration(100, n, 12, groups)
    assert c["products"] < w["products"]
    # the products dominate: the bound is theirs at the FP32-grade rate
    assert _bound(w) == w["products"] / peaks.PRODUCT_FLOPS


def test_main_iteration_bound_at_the_cell():
    w = MEGA.iteration(100, 25, 120, 12, [203], 202)
    # 10.26 M complex multiply-adds a chain: 8.2 GFLOP at 165 TFLOP/s
    assert w["products"] == pytest.approx(8.205e9, rel=1e-3)
    assert _bound(w) == pytest.approx(4.97e-5, rel=1e-2)


def test_peaks():
    assert peaks.PRODUCT_FLOPS == 165e12
    assert peaks.bound_seconds(1.65e12, 0, 0) == 0.01
    assert peaks.bound_seconds(1.65e12, 6.7e12, 0) == 0.1   # max, not sum
    assert peaks.bound_seconds(0, 0, 3.35e12) == 1.0


def test_readers_never_make_up_a_share():
    """No trace, or a trace with no device record, reads nothing."""
    ctx = {"trace": None}
    for name in ("megachain_roofline", "step_mfu", "cgemm_roofline",
                 "iter_device_ms", "device_idle_pct"):
        assert harness.reader(name)(ctx) is None


def test_shares_from_a_trace():
    import chrometrace as trace
    tr = trace.Trace(window_s=0.1, busy_s={0: 0.08},
                     kernels=[(0, "void cgemm_kernel<T>(Args)", 0.06),
                              (0, "bandpower_kernel", 0.02)], gaps=[])
    ctx = {"trace": tr, "iters_in_turn": 100,
           "widths": {"n": 120, "m": 12, "group_times": [203],
                      "alpha": 202, "chains": 100, "baselines": 25}}
    it_ms = harness.reader("iter_device_ms")(ctx)
    assert it_ms == pytest.approx(0.8)
    share = harness.reader("megachain_roofline")(ctx)
    assert share == pytest.approx(100 * 4.973e-5 / 8e-4, rel=1e-2)
    mfu = harness.reader("step_mfu")(ctx)
    w = MEGA.iteration(100, 25, 120, 12, [203], 202)
    assert mfu == pytest.approx(100 * w["products"] / 165e12 / 8e-4)
    assert mfu <= share
    cg = harness.reader("cgemm_roofline")(ctx)
    c = CGEMM.iteration(100, 120, 12, [203])
    assert cg == pytest.approx(100 * c["products"] / 165e12 / 6e-4)
    assert harness.reader("device_idle_pct")(ctx) == pytest.approx(20.0)
