"""Reduction of a ``torch.profiler`` Chrome trace of one chunk's turn to the
numbers the per-layer readers take: each card's busy time (the union of
its kernel, copy and set records), the traced window, the kernel records
by name, and the device's idle gaps labelled by what the host was doing.
"""
import json
from pathlib import Path
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
TOP = 10


class Trace(NamedTuple):
    window_s: float
    busy_s: dict          # device id -> seconds of the union of records
    kernels: list         # (device id, name, seconds) of each kernel record
    gaps: list            # (seconds, host label) of each device idle gap


def _union(spans):
    total, hi = 0.0, float("-inf")
    merged = []
    for t0, t1 in sorted(spans):
        if t1 <= hi:
            continue
        if t0 > hi:
            merged.append([t0, t1])
        else:
            merged[-1][1] = t1
        total += t1 - max(t0, hi)
        hi = t1
    return total, merged


def _host_label(host, t):
    """The shortest host span that holds time ``t``."""
    best = None
    for t0, t1, name in host:
        if t0 <= t <= t1 and (best is None or t1 - t0 < best[0]):
            best = (t1 - t0, name)
    return best[1] if best else "host idle"


def read(path: Path) -> Trace:
    ev = [e for e in json.loads(Path(path).read_text())["traceEvents"]
          if e.get("ph") == "X" and "dur" in e]
    if not ev:
        raise ValueError(f"{path}: no timed events")
    lo = min(e["ts"] for e in ev)
    hi = max(e["ts"] + e["dur"] for e in ev)
    spans, kernels = {}, []
    for e in ev:
        if e.get("cat") not in DEVICE_CATS:
            continue
        dev = int(e.get("args", {}).get("device", 0))
        spans.setdefault(dev, []).append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            kernels.append((dev, e["name"], e["dur"] / 1e6))
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
            if e.get("cat") in HOST_CATS]
    busy, gaps = {}, []
    for dev, sp in spans.items():
        busy[dev], merged = _union(sp)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append(((b - a) / 1e6, _host_label(host, (a + b) / 2)))
    return Trace((hi - lo) / 1e6, {d: b / 1e6 for d, b in busy.items()},
                 kernels, sorted(gaps, reverse=True))


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    by_name = {}
    for _, name, s in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[label[:120], s] for s, label in tr.gaps[:TOP]]}
