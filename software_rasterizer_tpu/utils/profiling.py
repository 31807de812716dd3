"""Device-time profiling (SURVEY.md 5.1).

The reference's profiling is ad-hoc chrono spans (PathTracing.cpp:42,
BVHAcceleration.cpp:63-77). Here: a `trace()` context manager wrapping
`jax.profiler` plus a summarizer that aggregates per-op device time from
the captured trace — the per-kernel breakdown used to drive the
roofline work in ops/ (e.g. it exposed the variadic argmin reduce
costing 30x the intersection math).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
from typing import Dict, List, Tuple


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace around the enclosed block."""
    import jax

    with jax.profiler.trace(log_dir):
        yield log_dir


def summarize_device_time(log_dir: str, top: int = 20) -> List[Tuple[str, float, int]]:
    """Aggregate device-op time from the newest trace under `log_dir`.
    Device events are those of processes named "/device:<KIND>:<n>"
    (one per GPU); host threads are skipped.
    Returns [(op_name, total_seconds, count)] sorted by time."""
    files = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        return []
    with gzip.open(files[-1]) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", [])
    pids: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
    dur: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in events:
        if (e.get("ph") == "X" and "dur" in e
                and pids.get(e["pid"], "").startswith("/device:")):
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    rows = [(name, us / 1e6, cnt[name]) for name, us in dur.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def print_summary(log_dir: str, top: int = 20) -> None:
    rows = summarize_device_time(log_dir, top)
    if not rows:
        print("no device events captured")
        return
    total = sum(r[1] for r in rows)
    print(f"{'device-s':>10}  {'count':>7}  op")
    for name, s, c in rows:
        print(f"{s:10.4f}  {c:7d}  {name[:80]}")
    print(f"{total:10.4f}  (top-{len(rows)} total)")
