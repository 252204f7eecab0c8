"""``BENCHMARK.json`` and the data files it names: every cell finds its
configuration, traffic, limits and readers by name, and every field keeps
the contract's characters and lengths."""
import json
import re

import numpy as np
import pytest

import bench_util
import check
import harness
import synth

SPEC = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in SPEC["configs"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
        assert "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    spec, w, config, traffic, limits = harness.load_cell(cell)
    assert set(limits) == set(check.NUMBERS)
    window = harness.load_window(cell)
    assert window["chunks"] >= harness.MIN_CHUNKS and window["seconds"] > 0
    assert all(0 < v < 1 for v in limits.values())
    for m in harness.metrics_for(spec, w, False):
        assert callable(harness.reader(m["name"]))
    for m in harness.metrics_for(spec, w, True):
        assert callable(harness.reader(m["name"]))
        assert m["moves"] == "samples_per_s"
    names = {m["name"] for m in harness.metrics_for(spec, w, False)}
    assert {"samples_per_s", "setup_s"} <= names
    assert harness.metrics_for(spec, w, True)
    assert w["chips"] in (1, 4)


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_shapes(cell):
    _, _, config, traffic, _ = harness.load_cell(cell)
    nt, nf = config["ntimes"], config["nfreqs"]
    flags = synth.time_flags(traffic.get("flag_windows"), nt, nf)
    assert traffic["nchains"] >= 2
    if flags is not None:
        patterns = np.unique(flags, axis=0)
        assert 1 < len(patterns) <= 8       # the megachain engine's groups
        assert not flags.all(axis=0).any()  # no channel flagged all night


def test_rfi_signature():
    _, _, config, traffic, _ = harness.load_cell("h1c_rfi")
    f = synth.time_flags(traffic["flag_windows"], config["ntimes"],
                         config["nfreqs"])
    assert f[60:140, 40:44].all() and f[150:, 90].all()
    assert f.sum() == 80 * 4 + 53


def test_inputs_from_the_seed_repeat():
    from hydra_pspec_torch import runner
    _, _, config, traffic, _ = bench_util.tiny_cell("h1c_rfi")
    a = harness.Inputs(config, traffic, 1, 2 ** 33 + 5, runner.BaselineJob)
    b = harness.Inputs(config, traffic, 1, 2 ** 33 + 5, runner.BaselineJob)
    c = harness.Inputs(config, traffic, 1, 2 ** 33 + 6, runner.BaselineJob)
    assert np.array_equal(a.jobs[1].d, b.jobs[1].d)
    assert not np.array_equal(a.jobs[1].d, c.jobs[1].d)
    assert a.rows == 4 and a.group_times == [6, 6, 8]


def test_pick_covers_starts_ends_and_rows():
    pairs = check.pick(2 ** 31 + 3, 100, 3000, 100)
    its = [it for _, it in pairs]
    assert 0 in its and 2999 in its
    assert any(it % 100 == 0 and it > 0 for it in its)
    assert len({r for r, _ in pairs}) > 80
    assert pairs == check.pick(2 ** 31 + 3, 100, 3000, 100)
