"""A run of a tiny cell on CPU devices, the harness's look for a card
skipped: sound, ``correct`` is true; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a cell can
have: a step that returns its state unchanged, half of the batch left out
(its rows filled from the rest), the exchange between devices left out
(every shard's rows taken from the first shard), an answer altered where
it is produced."""
import pytest
import torch

import bench_util


def _megachain(monkeypatch, alter):
    """Wrap the engine's chain so that ``alter(ps_in, ps_out, sample)``
    returns what the runner receives."""
    from hydra_pspec_torch.models import megachain
    orig = megachain.run_chain_megachain

    def broken(mops, dims, ps0, *a, **kw):
        ps_in = ps0.clone()
        ps_out, sample = orig(mops, dims, ps0, *a, **kw)
        return alter(ps_in, ps_out, sample)
    monkeypatch.setattr(megachain, "run_chain_megachain", broken)


def _unchanged(ps_in, ps_out, sample):
    nf = sample.ps.shape[2]
    K = sample.ps.shape[0]
    grp = ps_in.shape[0] // sample.ps.shape[1]   # rows of a chain
    ps = ps_in[::grp, :nf][None].expand(K, -1, -1).clone()
    return ps_in, sample._replace(ps=ps)


def _half(ps_in, ps_out, sample):
    B = sample.ps.shape[1]
    h = B // 2
    fields = {}
    for name in ("ps", "chisq", "ln_post"):
        x = getattr(sample, name).clone()
        x[:, h:2 * h] = x[:, :h]
        fields[name] = x
    return ps_out, sample._replace(**fields)


def _altered(ps_in, ps_out, sample):
    ps = sample.ps.clone()
    ps[..., 0] *= 1.01
    return ps_out, sample._replace(ps=ps)


@pytest.mark.parametrize("workload", ["h1c_main", "h1c_rfi"])
def test_sound_run_is_correct(workload):
    out = bench_util.run_tiny(workload)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", ["h1c_main", "h1c_rfi"])
def test_fault_is_refused(monkeypatch, workload, fault):
    _megachain(monkeypatch, fault)
    out = bench_util.run_tiny(workload)
    assert out["correct"] is False


def test_exchange_left_out_is_refused(monkeypatch):
    """The main cell split over four devices, as a multi-card cell runs:
    the harness's split and join of shards."""
    from hydra_pspec_torch import runner
    orig = runner._join_rows

    def first_only(parts):
        return orig([parts[0]] * len(parts))
    monkeypatch.setattr(runner, "_join_rows", first_only)
    out = bench_util.run_tiny("h1c_main", chips=4)
    assert out["correct"] is False


def test_sound_shards_are_correct():
    out = bench_util.run_tiny("h1c_main", chips=4)
    assert out["correct"] is True and out["device"]["count"] == 4


def test_traced_run_reads_host_metrics_without_a_card():
    out = bench_util.run_tiny("h1c_main", trace=1)
    assert out["correct"] is True
    assert "host_build_s" in out["metrics"]
    # no device records on the CPU: no device metric is made up
    assert "iter_device_ms" not in out["metrics"]
    assert "megachain_roofline" not in out["metrics"]
    assert torch.cuda.is_available() or out["device"]["busy_s"] == 0.0
