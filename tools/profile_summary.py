"""Aggregate the device events of a jax-profiler trace.

Companion to `-profile DIR` (mgtpu/pipelines/standard.py — the
tracing subsystem, SURVEY §5): sums device-side op time from the
captured trace, grouped by the event's ``hlo_category`` where the trace
carries one and by the op name otherwise (GPU kernel events carry
none), so per-step op times are reproducible from artifacts. A trace
with no device events is an error, never an empty table.

Usage:
  python tools/profile_summary.py <profile_dir> [--top N] [--steps K]

<profile_dir> is the directory passed to -profile (it contains
plugins/profile/<run>/<host>.trace.json.gz). Durations are summed over
the whole capture; pass --steps to also print per-step numbers (the
standard pipeline captures iterations 2..9, i.e. 8 steps).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_trace(profile_dir: str) -> str:
    pats = [
        os.path.join(profile_dir, "plugins", "profile", "*", "*.trace.json.gz"),
        os.path.join(profile_dir, "**", "*.trace.json.gz"),
    ]
    for p in pats:
        hits = sorted(glob.glob(p, recursive=True))
        if hits:
            return hits[-1]  # newest capture
    raise FileNotFoundError(f"no *.trace.json.gz under {profile_dir}")


# Device-track threads that summarize other rows (whole modules, steps,
# name scopes): counting them would double-count the ops beneath.
_SUMMARY_THREADS = ("XLA Modules", "Steps", "TensorFlow Name Scope",
                    "Framework Name Scope", "Source code")


def device_events(trace: dict):
    """Complete op events from device tracks: processes named
    ``/device:<KIND>:<n>`` (a GPU's streams live under
    ``/device:GPU:0``); host threads (``/host:CPU``) and summary rows are
    excluded. Where XLA op events carry ``hlo_category``, only those are
    kept, so kernels are not counted twice beside their ops."""
    pnames, tnames = {}, {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "M":
            continue
        name = ev.get("args", {}).get("name", "")
        if ev.get("name") == "process_name":
            pnames[ev["pid"]] = name
        elif ev.get("name") == "thread_name":
            tnames[(ev["pid"], ev.get("tid"))] = name
    dev_pids = {pid for pid, name in pnames.items() if name.startswith("/device:")}
    events = [
        ev for ev in trace.get("traceEvents", [])
        if ev.get("ph") == "X" and ev.get("pid") in dev_pids
        and not tnames.get((ev["pid"], ev.get("tid")), "").startswith(_SUMMARY_THREADS)
    ]
    ops = [ev for ev in events if "hlo_category" in (ev.get("args") or {})]
    return ops or events


def summarize(trace: dict):
    """(total device microseconds, {category: us}, {op name: us}).
    Raises ValueError when the trace holds no device events."""
    events = device_events(trace)
    if not events:
        raise ValueError(
            "no device events in this trace (no /device:* process with "
            "complete op events): was it captured on an accelerator?")
    by_cat = collections.Counter()
    by_op = collections.Counter()
    for ev in events:
        dur = float(ev.get("dur", 0.0))  # microseconds
        name = ev.get("name", "?")
        by_cat[(ev.get("args") or {}).get("hlo_category", name)] += dur
        by_op[name] += dur
    return sum(by_op.values()), by_cat, by_op


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--steps", type=int, default=0,
                    help="divide totals by this step count for per-step ms")
    args = ap.parse_args()

    path = find_trace(args.profile_dir)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)

    total, by_cat, by_op = summarize(trace)

    div = args.steps if args.steps else 1
    unit = "ms/step" if args.steps else "ms total"
    print(f"trace: {path}")
    print(f"device op time: {total / 1000 / div:.2f} {unit}\n")
    print(f"{'category':40s} {unit:>10s}  share")
    for cat, dur in by_cat.most_common(args.top):
        print(f"{cat:40s} {dur / 1000 / div:10.2f}  {dur / total:6.1%}")
    print(f"\ntop individual ops ({unit}):")
    for op, dur in by_op.most_common(args.top):
        print(f"  {dur / 1000 / div:8.2f}  {op[:90]}")


if __name__ == "__main__":
    sys.exit(main())
