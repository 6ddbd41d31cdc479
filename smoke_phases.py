#!/usr/bin/env python3
"""Seconds by phase of chip_smoke.py, run from one or more checkouts in turn.

    python3 smoke_phases.py [--log-dir DIR] CHECKOUT [CHECKOUT ...]

Compares the smoke of two commits on one card: unpack each commit into a
directory (``git archive``) and name them in the order to run, e.g.
parent, change, change, parent. Before each run the checkout's kernel
build (``crisperwhisper_tpu_torch/_build``) is removed, so every run
builds its kernels from nothing, as a fresh checkout does. Each line the
smoke prints (stdout and stderr) is stamped with the seconds since its
start. A phase ends at the last line that starts with ``phase N``, and its
seconds run from the end of the phase before (phase 0's from the start).

Prints one JSON line a run: ``{"checkout": ..., "rc": ..., "seconds":
..., "phases": {"0": s, "1": s, ...}}``; with ``--log-dir`` the stamped
output of run i goes to ``DIR/smoke_<i>.log``. Exits 1 when any run
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

_PHASE = re.compile(r"phase (\d+)\b")


def phase_seconds(stamped: list[tuple[float, str]]) -> dict[str, float]:
    """{phase: seconds} from (seconds since start, line) pairs: each phase
    from the end of the phase before to its own last line."""
    ends: dict[str, float] = {}
    for t, line in stamped:
        m = _PHASE.match(line)
        if m:
            ends[m.group(1)] = t
    out, prev = {}, 0.0
    for phase, end in sorted(ends.items(), key=lambda kv: int(kv[0])):
        out[phase] = end - prev
        prev = end
    return out


def run_smoke(checkout: str) -> tuple[int, list[tuple[float, str]], float]:
    """(exit code, stamped lines, seconds) of one run of the checkout's
    chip_smoke.py, its kernel build removed first."""
    shutil.rmtree(os.path.join(checkout, "crisperwhisper_tpu_torch",
                               "_build"), ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=checkout, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    stamped = [(time.perf_counter() - t0, line.rstrip("\n"))
               for line in proc.stdout]
    rc = proc.wait()
    return rc, stamped, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--log-dir")
    args = ap.parse_args(argv)
    failed = False
    for i, checkout in enumerate(args.checkouts):
        rc, stamped, seconds = run_smoke(checkout)
        failed |= rc != 0
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"smoke_{i}.log"), "w") as f:
                f.writelines(f"{t:9.2f} {line}\n" for t, line in stamped)
        print(json.dumps({"checkout": checkout, "rc": rc,
                          "seconds": round(seconds, 2),
                          "phases": {k: round(v, 2) for k, v in
                                     phase_seconds(stamped).items()}}),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
