"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic mix, a cell's
limits or a per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the published HF config keys, the served
  dtype, the alignment heads, ``reduced`` and ``assumed``;
* ``traffic/<mix>.json``: the pipeline path, the decode policy and the
  parameters of ``generator.py``;
* ``limits/<workload>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric, None
  where it finds nothing to read;
* ``archs/<model_type>.py``: the model's shapes, weights, checkpoint,
  prompt, reference check, work counts and text vocabulary, found by the
  configuration's published ``model_type`` (the contract is
  ``ARCH_NAMES``).

The program under test is ``crisperwhisper_tpu_torch``; the benchmark
takes from it the pipeline and the layer entry points its spans wrap.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import check, generator, spans, trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "crisperwhisper_tpu")
WEAK_SAMPLE = 5         # fewer distinct tokens in the sample are flagged
HARNESS_KEYS = ("name", "source", "serve_dtype", "alignment_heads",
                "reduced", "assumed")
# Compared in every run with the limit 0; a limits file may not name them.
GATES = ("failed", "short_windows", "stitch_mismatch")
# What the harness calls of an architecture file, and nothing else:
# arch(cfg) -> shapes with vocab_size; weights(arch, seed, device, dtype)
# -> params; checkpoint(path, cfg) -> the weightless checkpoint directory;
# prompt_ids(mix); compare(params, arch, cfg, windows, audio, prompt, mix,
# mode, device, control) -> readings; work, the module of operation and
# byte counts (window_flops, bound_s); text_pieces() -> bytes of each
# text id.
ARCH_NAMES = ("arch", "weights", "checkpoint", "prompt_ids", "compare",
              "work", "text_pieces")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (``crisperwhisper_tpu_torch.x`` is not
    ``crisperwhisper_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, name + ".json"),
              encoding="utf-8") as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: every
    per-layer metric lists its cells; an end-to-end metric without a list
    (``setup_s``) is reported by every cell."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def hf_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k not in HARNESS_KEYS}


def generation_fields(mix: dict, arch) -> dict:
    """GenerationOptions fields of the mix's decode policy (lists made
    tuples); ``suppress_ids_from`` suppresses every id from it to the end
    of the vocabulary."""
    out = {k: tuple(v) if isinstance(v, list) else v
           for k, v in mix["generation"].items()}
    start = mix.get("suppress_ids_from")
    if start is not None:
        out["suppress_tokens"] = tuple(range(start, arch.vocab_size))
    return out


def card_info() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return smi.stdout.strip() or smi.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


@dataclass
class Context:
    """What a per-layer metric's reader may read."""
    arch: object
    spans: spans.Spans
    trace: trace.Summary
    window_s: float
    windows: list                  # check.Window of every call completed
    latencies: list                # seconds of every call
    prompt_len: int
    n_align: int
    work: object                   # the architecture's work module


def _module(root: str, kind: str, name: str):
    """``<root>/<kind>/<name>.py``, loaded by path."""
    path = os.path.join(root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_metric(root: str, name: str, ctx: Context):
    return _module(root, "metrics", name).read(ctx)


def architecture(root: str, cfg: dict):
    """``archs/<model_type>.py`` of ``cfg``, holding every name of
    ``ARCH_NAMES``."""
    name = cfg["model_type"]
    mod = _module(root, "archs", name)
    missing = [n for n in ARCH_NAMES if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"archs/{name}.py lacks {', '.join(missing)}")
    return mod


def _well_formed(res, seconds: float, word: bool) -> bool:
    """Non-empty text, JSON-serialisable; with ``word`` times, word
    chunks with finite, ordered timestamps inside the recording."""
    try:
        if not (isinstance(res.get("text"), str) and res["text"]):
            return False
        if not word:
            json.dumps(res)
            return True
        chunks = res.get("chunks")
        if not (isinstance(chunks, list) and chunks):
            return False
        for c in chunks:
            s, e = c["timestamp"]
            if not all(isinstance(x, float) and math.isfinite(x)
                       and -1e-6 <= x <= seconds + check.TS_FRAME
                       for x in (s, e)) or e < s:
                return False
        json.dumps(res)
        return True
    except (KeyError, TypeError, ValueError):
        return False


def _window(traffic, call, seconds: float, n_calls: int | None,
            sync) -> tuple[list, list, list, float, float]:
    """Calls back to back until ``seconds`` have passed (the call in
    flight finished and counted) or ``n_calls`` are done: (calls, their
    results, their latencies, start, end)."""
    done, results, latencies = [], [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        c = traffic.next_call()
        c0 = time.perf_counter()
        with torch.profiler.record_function("pb.call"):
            out = call([traffic.audio[r] for r in c.recordings], c.max_new)
        c1 = time.perf_counter()
        done.append(c)
        results.append(out)
        latencies.append(c1 - c0)
        if (c1 >= deadline if n_calls is None else len(done) >= n_calls):
            break
    sync()
    return done, results, latencies, t_start, c1


def run_cell(bench: dict, workload: dict, seed: int, seconds: float,
             traced: bool, t0: float, device: str = "cuda",
             root: str = HERE, n_calls: int | None = None,
             control: str | None = None) -> tuple[dict, list[str], dict]:
    """(the result object, the lines to print before it, the check's
    readings). ``n_calls`` runs that many calls instead of ``seconds``.
    ``control`` reads the reference in that mode too (``control.py``) and
    judges it in the program's place: the compared numbers are the
    control's, and ``correct`` is the control's verdict.

    A traced run measures two windows of ``seconds`` each: the first with
    the benchmark's spans alone, from which the host-clock and span
    metrics are read, and the second under the profiler too, from which
    the metrics of the device trace are read (``source`` in
    BENCHMARK.json), so the profiler's host cost reaches no host-clock
    metric."""
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.hub import load_pipeline

    cfg = load(root, "configs", workload["config"])
    mix = load(root, "traffic", workload["traffic"])
    limits = load(root, "limits", workload["name"])
    gated = sorted(set(limits) & set(GATES))
    if gated:
        raise ValueError(f"limits/{workload['name']}.json names "
                         f"{', '.join(gated)}, compared with the limit 0 "
                         "in every run")
    model = architecture(root, cfg)
    arch = model.arch(cfg)
    dtype = getattr(torch, cfg["serve_dtype"])
    path = mix["pipeline"]
    word = bool(mix["generation"]["return_token_timestamps"])
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("imports", time.perf_counter())]
    params = model.weights(arch, seed, device, dtype)
    sync()
    marks.append(("weights", time.perf_counter()))
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ck = model.checkpoint(os.path.join(tmp, "ckpt"), cfg)
        pipe = load_pipeline(
            ck, dtype=dtype, device=device, language=mix["language"],
            quantize=path["quantize"], params=params,
            pipe_opts=PipelineOptions(batch_size=path["batch_size"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pipe.gen_opts = replace(pipe.gen_opts, **generation_fields(mix, arch))
    sync()
    marks.append(("load_pipeline", time.perf_counter()))
    traffic = generator.Traffic(mix, seed, path["batch_size"])
    marks.append(("audio", time.perf_counter()))
    pauses = mix["adjust_pauses_threshold"]

    def call(audios: list, max_new: int) -> list:
        if pipe.gen_opts.max_new_tokens != max_new:
            pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=max_new)
        return pipe([{"raw": a, "sampling_rate": generator.SR}
                     for a in audios],
                    return_timestamps="word" if word else False,
                    adjust_pauses_threshold=pauses)

    capture = spans.Capture().install()
    for audios, max_new in traffic.warmup():
        call(audios, max_new)
    sync()
    capture.batches.clear()
    marks.append(("warm-up", time.perf_counter()))

    # ---- the measured window(s) -----------------------------------------
    setup_s = time.perf_counter() - t0
    span_set = spans.Spans(device)
    if traced:
        span_set.install()
    done, results, latencies, t_start, t_end = _window(
        traffic, call, seconds, n_calls, sync)
    window_s = t_end - t_start
    summary, traced_ctx = None, None
    if traced:
        span_set.uninstall()
        traced_spans = spans.Spans(device).install()
        prof = trace.Profile(device)
        prof.start()
        t_done, t_results, _, b_start, b_end = _window(
            traffic, call, seconds, n_calls, sync)
        summary = prof.stop()
        traced_spans.uninstall()
    capture.uninstall()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- what the window served -----------------------------------------
    calls = done + (t_done if traced else [])
    served = results + (t_results if traced else [])
    attempted = sum(len(c.recordings) for c in calls)
    failed = sum(not _well_formed(res, traffic.lengths[r] / generator.SR,
                                  word)
                 for c, out in zip(calls, served)
                 for r, res in zip(c.recordings, out))
    windows = check.served_windows(traffic, calls, capture.batches,
                                   path["batch_size"])
    short = sum(len(w.tokens) != w.max_new for w in windows)
    tokens = sum(len(w.tokens) for w in windows)
    first = windows[:sum(len(traffic.windows(c)) for c in done)]
    audio_s = check.audio_seconds(traffic, done)
    prompt = model.prompt_ids(mix)
    n_align = len(cfg.get("alignment_heads", []))
    ctx = Context(arch, span_set, None, window_s, first, latencies,
                  len(prompt), n_align, model.work)
    if traced:
        traced_ctx = Context(arch, traced_spans, summary, b_end - b_start,
                             windows[len(first):], [], len(prompt),
                             n_align, model.work)
    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in cell_metrics(bench, workload["name"], kind):
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] == "rtfx":
            value = audio_s / window_s
        elif m["name"] == "clip_latency_p90_s":
            value = float(np.percentile(latencies, 90))
        else:
            value = _read_metric(root, m["name"], traced_ctx if
                                 m["source"] == "device_trace" else ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check, on the program's weights' inputs, program freed -----
    del pipe, ctx, traced_ctx, span_set
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    picked = check.sample(windows, mix["check_windows"], seed,
                          traffic.lengths)
    readings = model.compare(
        params, arch, cfg, picked, traffic.audio, prompt, mix,
        "serving" if path["quantize"] == "serving" else "f32", device,
        control)
    mismatched, stitched = check.stitch_mismatches(
        traffic, calls, served, windows, picked, pauses,
        model.text_pieces(), word)
    readings["stitch_mismatch"] = mismatched
    check_s = time.perf_counter() - t_check
    judged = readings["control"] if control else readings
    checks = {"failed": {"value": failed, "limit": 0},
              "short_windows": {"value": short, "limit": 0},
              "stitch_mismatch": {"value": mismatched, "limit": 0}}
    for name, limit in limits.items():
        value = judged.get(name)        # None where the run read none
        checks[name] = {"value": value if isinstance(value, (int, float))
                        else None, "limit": limit}
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": workload.get("chips", 1), "memory_peak_bytes": peak}
    if traced:
        dev.update(busy_s=summary.busy_s, window_s=b_end - b_start)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": summary.top_ops(),
                               "idle_gaps": summary.top_gaps()}
    result["checks"] = checks
    lat = sorted(latencies)
    ts = readings.get("ts", "none")
    lines = [
        f"cell {workload['name']} seed {seed} trace {int(traced)}: "
        f"{len(done)} calls, {len(first)} windows, {audio_s:.3f} audio s "
        f"in {window_s:.4f} s window (asked {seconds} s)"
        + (f", then {len(t_done)} calls in {b_end - b_start:.4f} s traced"
           if traced else "")
        + f"; {attempted} requests ({failed} failed), {tokens} tokens "
        f"decoded; set-up {setup_s:.3f} s",
        f"call latency s: min {lat[0]:.4f} median "
        f"{float(np.median(lat)):.4f} max {lat[-1]:.4f} over {len(lat)}",
        f"check: {len(picked)} windows, {readings['tokens']} tokens, "
        f"logit_gap {readings['logit_gap']!r}, token times {ts}, "
        f"{stitched} results stitched again, {mismatched} differ; "
        f"{check_s:.2f} s",
        f"check sample: {readings['distinct_tokens']} distinct tokens, "
        f"reference median margin {readings['median_margin']!r}"
        + (" (few distinct tokens: a weak sample)"
           if readings["distinct_tokens"] < WEAK_SAMPLE else ""),
        "set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b) in
            zip([("start", t0)] + marks, marks)),
        f"peak device memory {peak} bytes",
        f"card: {card_info() if cuda else 'cpu'}"]
    if control:
        c = readings["control"]
        lines.append(f"control ({control}) judged in the program's place: "
                     f"logit_gap {c['logit_gap']!r}, token times "
                     f"{c.get('ts', 'none')}")
        if "faults" in readings:
            lines.append("planted faults of the token times: " + ", ".join(
                f"{k} {v}" for k, v in readings["faults"].items()))
    return result, lines, readings
