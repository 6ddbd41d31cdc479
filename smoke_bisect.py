#!/usr/bin/env python3
"""Bisect a slowdown of chip_smoke.py's phase 4 between checkouts, on one card.

    python3 smoke_bisect.py [--log-dir DIR] RUN [RUN ...]

A RUN is ``CHECKOUT[,skip2][,lib=OTHER]``: a directory holding a
``git archive`` of a commit. Each run is one process, started in the
checkout, that imports the checkout's own ``chip_smoke.py`` as a module
and drives its functions, not its ``main``:

  1. phase 0 (the card) and the kernel build (``_build.kernels``); with
     ``lib=OTHER``, the library that OTHER's run built instead of its own
     (the checkout's Python on the other commit's ``.so``: name a run of
     OTHER earlier in the list);
  2. unless ``skip2``, phase 2 (``phase2_kernels`` and
     ``phase2_remaining`` of the checkout's smoke), as the smoke runs it
     before phase 4;
  3. round "cold": phase 4's pipeline (``load_pipeline`` at large-v3 with
     the random bf16 weights of ``_large_params``, 96 new tokens, one seek
     pass a window) answers the 12 s array, to warm the process up;
  4. rounds "warm" and "again": the same pipeline answers phase 4's two
     requests (the 60 s WAV and the 12 s array), twice.

Each round prints one JSON line: the wall of each request (a host clock
around ``pipe(...)`` and ``torch.cuda.synchronize()``), the round's
seconds from its first line to its last (pipeline set-up included), the
process's CPU seconds, the seconds and count of Python's garbage
collections, the caching allocator's device allocations, frees and
retries, the SM clock after the round (nvidia-smi), and per layer call
(``extract_features``, ``encode``, ``greedy_decode``,
``attention_to_jump_times``) its calls, host seconds (a clock around the
call, no synchronisation) and device seconds (CUDA events around the
call on the current stream). Kernels are built once per checkout: the
checkouts' ``_build`` directories are removed before the first run.

Prints ``{"run": ..., "rc": ...}`` after each run; with ``--log-dir`` the
output of run i goes to ``DIR/bisect_<i>.log``. Exits 1 when any run
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_CHILD = r'''
import gc, glob, json, os, subprocess, sys, tempfile, time
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as S
from crisperwhisper_tpu_torch import _build
from crisperwhisper_tpu_torch.decoding import longform
from crisperwhisper_tpu_torch.hub import load_pipeline
from crisperwhisper_tpu_torch.pipeline import asr

SKIP2, LIB = json.loads(sys.argv[1]), json.loads(sys.argv[2])
if LIB:
    so = sorted(glob.glob(os.path.join(
        LIB, "crisperwhisper_tpu_torch", "_build", "libcw_kernels_*.so")))
    assert len(so) == 1, f"expected one built library under {LIB}: {so}"
    _build._build = lambda: (Path(so[0]), 0.0, "")
print(S.phase0_device(), flush=True)
kern = _build.kernels()
print(f"library {kern.path} (built in {kern.build_seconds:.1f} s)",
      flush=True)
large = S._large_params()
tmp = tempfile.mkdtemp(prefix="cw_bisect_")

layers, gc_log = {}, []


def timed(module, name):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        try:
            return real(*args, **kwargs)
        finally:
            stop.record()
            layers.setdefault(name, []).append(
                (time.perf_counter() - t0, start, stop))
    setattr(module, name, wrapper)


for module, name in ((asr, "extract_features"), (longform, "encode"),
                     (longform, "greedy_decode"),
                     (longform, "attention_to_jump_times")):
    timed(module, name)


def on_gc(phase, info):
    if phase == "start":
        gc_log.append([time.perf_counter(), info["generation"]])
    elif gc_log:
        gc_log[-1][0] = time.perf_counter() - gc_log[-1][0]


gc.callbacks.append(on_gc)


def sm_clock():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def round_(label, requests):
    arch, params = large
    torch.cuda.synchronize()
    layers.clear()
    gc_log.clear()
    stats0 = torch.cuda.memory_stats()
    t0, c0 = time.perf_counter(), time.process_time()
    pipe = load_pipeline(S._large_ckpt(tmp, arch), params=params,
                         device="cuda", language="en")
    pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=96,
                            force_unique_generate_call=True)
    walls = []
    for req, _ in requests:
        t = time.perf_counter()
        pipe(req, return_timestamps="word", adjust_pauses_threshold=0.12)
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t, 3))
    seconds = time.perf_counter() - t0
    stats = torch.cuda.memory_stats()
    print(json.dumps({
        "round": label, "walls": walls, "wall_sum": round(sum(walls), 3),
        "round_s": round(seconds, 3),
        "cpu_s": round(time.process_time() - c0, 3),
        "gc_s": round(sum(d for d, _ in gc_log), 4),
        "gc_n": len(gc_log),
        "gc_gen2": sum(1 for _, g in gc_log if g == 2),
        "alloc": {k: stats.get(k, 0) - stats0.get(k, 0)
                  for k in ("num_device_alloc", "num_device_free",
                            "num_alloc_retries", "num_sync_all_streams")},
        "reserved_gib": round(stats.get("reserved_bytes.all.current", 0)
                              / 2**30, 3),
        "sm_clock_mhz": sm_clock(),
        "layers": {n: {"calls": len(v),
                       "host_s": round(sum(h for h, _, _ in v), 4),
                       "device_s": round(sum(a.elapsed_time(b)
                                             for _, a, b in v) / 1e3, 4)}
                   for n, v in layers.items()}}), flush=True)


if not SKIP2:
    t = time.perf_counter()
    S.phase2_kernels(large)
    S.phase2_remaining(large)
    print(f"phase 2 took {time.perf_counter() - t:.1f} s", flush=True)
requests = S._large_requests(tmp)
round_("cold", requests[1:])
round_("warm", requests)
round_("again", requests)
'''


def _parse(spec: str) -> tuple[str, bool, str | None]:
    checkout, *flags = spec.split(",")
    skip2, lib = False, None
    for flag in flags:
        if flag == "skip2":
            skip2 = True
        elif flag.startswith("lib="):
            lib = os.path.abspath(flag[4:])
        else:
            raise SystemExit(f"unknown flag {flag!r} in {spec!r}")
    return os.path.abspath(checkout), skip2, lib


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--log-dir")
    args = ap.parse_args(argv)
    runs = [_parse(spec) for spec in args.runs]
    for checkout in {c for c, _, _ in runs}:
        shutil.rmtree(os.path.join(checkout, "crisperwhisper_tpu_torch",
                                   "_build"), ignore_errors=True)
    failed = False
    for i, (spec, (checkout, skip2, lib)) in enumerate(zip(args.runs, runs)):
        proc = subprocess.run(
            [sys.executable, "-u", "-c", _CHILD, json.dumps(skip2),
             json.dumps(lib)], cwd=checkout, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        failed |= proc.returncode != 0
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"bisect_{i}.log"),
                      "w") as f:
                f.write(proc.stdout)
        for line in proc.stdout.splitlines():
            if line.startswith('{"round"'):
                print(json.dumps({"run": spec, **json.loads(line)}),
                      flush=True)
        print(json.dumps({"run": spec, "rc": proc.returncode}), flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
