#!/usr/bin/env python3
"""Smoke run of the PyTorch port (crisperwhisper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one line each on stdout:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from crisperwhisper_tpu_torch/csrc (one nvcc
     per source, in parallel; ptxas registers and spills of the
     decode-step kernel) and import the Triton module (Triton compiles at
     the first launch, in phase 2);
  2. each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the maximum error and both times (the
     comparisons and bands of crisperwhisper_tpu_torch.testing, which
     tests/test_torch_gpu.py runs too); the decode-step kernel at
     large-v3 width (random int8 weights, random decoder biases and
     LayerNorms, a ring of 128 at position 60) for one row with int4 and
     int8 cross caches and four rows with int4, timed beside the
     quantized non-kernel decode_step; then one row at position 0 (the
     fresh column alone in the ring), untimed; in each case also fresh
     columns placed on the int8 rounding's ties;
  3. the TINY f32 slice on the card against the same slice on the CPU
     (plain versions), same seeded weights: tokens equal, word
     timestamps within 0.02 s; then the quantized serving slice with the
     decode-step kernel, one window (batch 1) and four (rows);
  4. the full large-v3 geometry with random bf16 weights built on the
     card: load_pipeline answers a 60 s WAV file and a 12 s array with
     word timestamps and adjust_pauses=0.12; every kernel's launch count
     is reset just before and read just after, and must be > 0;
  5. the same weights through load_pipeline(quantize="serving") with
     b1_decode_kernel: the 12 s array (batch 1, decode_step_b1) and the
     60 s WAV (3 windows, decode_step_rows), counts reset before each
     request; each must launch the decode-step kernel in its own mode and
     the other three kernels.
Then a JSON line with one entry per kernel (launches: phase 4 for the
first three, phase 5 for the decode step), and as the last line
{"ok": true, "device": {...}}.

Exits non-zero, without that last line, when no CUDA card is present, when
the port cannot be imported, or when any phase fails. Imports no JAX and,
of the repo, only crisperwhisper_tpu_torch (synthetic checkpoints and
audio come from its ``testing`` module).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def _time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase0_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 0 ok: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return card


def phase1_build() -> None:
    from crisperwhisper_tpu_torch import _build
    from crisperwhisper_tpu_torch.ops import _align_prep_triton  # noqa: F401
    kern = _build.kernels()
    regs = [ln.strip() for ln in kern.ptxas_log.splitlines()
            if "registers" in ln]
    print(f"phase 1 ok: nvcc built {kern.path.name} in "
          f"{kern.build_seconds:.2f} s; ptxas: {' | '.join(regs)}",
          flush=True)
    print("phase 1 decode_step.cu: " + "; ".join(
        _ptxas_summary(kern.ptxas_log, "decode_step_kernel")), flush=True)


def _ptxas_summary(log: str, kernel: str) -> list[str]:
    """'<entry>: N registers, S bytes spill stores, L bytes spill loads'
    for each compiled entry whose name holds ``kernel``."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
        elif name and "spill stores" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def phase2_kernels(large) -> list[dict]:
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import alignment as al
    from crisperwhisper_tpu_torch.ops import dtw as dt
    from crisperwhisper_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = []

    # --- kernel 1: encoder attention against the plain version on the
    # f32 widening of its inputs (bands: testing.attention_error)
    rows = []
    for shape, dtype in (((4, 20, 1500, 64), torch.bfloat16),
                         ((4, 20, 1500, 64), torch.float32),
                         ((4, 20, 300, 64), torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev) * s
                   for s in (0.3, 0.3, 1.0))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        err, band = testing.attention_error(q, k, v)
        ms = _time_ms(lambda: fa.fused_attention(q, k, v), 10)
        plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v), 10)
        _require(err <= band, f"attention {shape} {dtype}: max err {err} "
                              f"> {band}")
        rows.append(f"{list(shape)} {str(dtype)[6:]} err {err:.3g} "
                    f"(band {band:.3g}) {ms:.3f} ms vs plain "
                    f"{plain_ms:.3f} ms")
        if len(entries) == 0:           # the main path's case (bf16)
            entries.append({
                "name": "encoder_attention", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/encoder_attention.cu",
                "replaces": "crisperwhisper_tpu/ops/fused_attention.py:37",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print("phase 2 attention: " + "; ".join(rows), flush=True)

    # --- kernel 2: alignment prep, one row cropped to 1000 frames
    b, a, t, m = 4, 15, 96, 1500
    w = torch.softmax(torch.randn((b, a, t, m), generator=gen, device=dev)
                      * 3.0, dim=-1).contiguous()
    nt = torch.tensor([96, 80, 51, 96], dtype=torch.int32, device=dev)
    nf = torch.tensor([1500, 1500, 1500, 1000], dtype=torch.int32,
                      device=dev)
    err, got = testing.align_prep_error(w, nt, nf)
    ms = _time_ms(lambda: ap.align_prep(w, nt, nf, 7), 10)
    plain_ms = _time_ms(lambda: ap.align_prep_plain(w, nt, nf, 7), 3)
    _require(err <= testing.PREP_BAND,
             f"align_prep: max err {err} > {testing.PREP_BAND}")
    print(f"phase 2 align_prep: {[b, a, t, m]} err {err:.3g} (band "
          f"{testing.PREP_BAND}) {ms:.3f} ms vs plain {plain_ms:.3f} ms",
          flush=True)
    entries.append({
        "name": "align_prep", "route": "triton",
        "source": "crisperwhisper_tpu_torch/ops/_align_prep_triton.py",
        "replaces": "crisperwhisper_tpu/ops/pallas_align.py:44",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # --- kernel 3: DTW, exact, on the masked cost of that prep
    cost = torch.where(testing.live_cells(nt, nf, t, m), got,
                       torch.tensor(1e9, device=dev)).contiguous()
    err = testing.dtw_error(cost, nt, nf)
    ms = _time_ms(lambda: dt.dtw(cost, nt, nf), 10)
    plain_ms = _time_ms(lambda: al.dtw_jump_times(cost, nt, nf), 2)
    _require(err == 0, f"dtw: off by up to {err} frames")
    print(f"phase 2 dtw: {[b, t, m]} exact (max diff {err} frames) "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms", flush=True)
    entries.append({
        "name": "dtw", "route": "cuda",
        "source": "crisperwhisper_tpu_torch/csrc/dtw.cu",
        "replaces": "crisperwhisper_tpu/ops/pallas_dtw.py:59",
        "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms})

    # --- kernel 4: the whole-step decoder at large-v3 width
    from crisperwhisper_tpu_torch.models.whisper import (alignment_selector,
                                                         decode_step)
    from crisperwhisper_tpu_torch.ops import decode_step as ds
    arch, params = large
    qparams = testing.quantized_decoder(params, arch)
    dec = qparams["decoder"]
    heads = testing.large_v3_align_heads(arch)
    sel = alignment_selector(arch, heads)
    # ring 128 at position 60, then at position 0, where the fresh column
    # is the only live slot, so its bf16 scales weigh fully (checked, not
    # timed)
    for rows, cross, pos in ((1, "int4", 60), (1, "int8", 60),
                             (4, "int4", 60), (1, "int4", 0)):
        cache = testing.random_step_cache(arch, rows, cross, 128, pos, gen)
        tok = torch.randint(0, arch.vocab_size, (rows,), generator=gen,
                            device=dev)
        x0 = (dec["tok_emb"][tok].float()
              + dec["pos_emb"][pos][None].float()).contiguous()
        errs = testing.decode_step_errors(qparams, arch, x0, pos, cache,
                                          tuple(heads))
        errs["ties"] = (testing.tie_column_error(qparams, arch, x0, pos,
                                                 cache), 0)
        for name, (err, band) in errs.items():
            _require(err <= band, f"decode step M={rows} {cross} at {pos}: "
                                  f"{name} max err {err} > {band}")
        line = (f"phase 2 decode_step: M={rows} {cross} cross, ring 128 at "
                f"{pos}: " + ", ".join(f"{k} err {e:.3g} (band {b:.3g})"
                                       for k, (e, b) in errs.items()))
        if pos == 0:
            print(line, flush=True)
            continue
        work = testing.clone_cache(cache)
        ms = _time_ms(lambda: ds.whole_step(qparams, arch, x0, pos, work,
                                            tuple(heads)), 20)
        plain_ms = _time_ms(lambda: ds.whole_step_plain(
            qparams, arch, x0, pos, work, tuple(heads)), 3)
        step_ms = _time_ms(lambda: decode_step(qparams, arch, tok, pos, work,
                                               align_sel=sel), 3)
        print(line + f"; kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
              f"quantized decode_step {step_ms:.3f} ms", flush=True)
        if len(entries) == 3:           # the batch-1 serving case
            entries.append({
                "name": "decode_step", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/decode_step.cu",
                "replaces": "crisperwhisper_tpu/ops/pallas_decode_b1.py:162",
                "max_abs_err": errs["hid"][0], "ms": ms,
                "plain_ms": plain_ms})
    del work, cache
    return entries


def phase3_tiny(tmp: str) -> None:
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params

    ckpt = testing.write_tiny_configs(os.path.join(tmp, "tiny"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(12.0, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", audio)
    gpu = testing.tiny_slice(ckpt, params, "cuda", audio)
    try:
        gap = testing.slice_timestamp_gap(cpu, gpu)
    except AssertionError as e:
        raise SmokeError(f"tiny slice, CUDA against CPU: {e}") from e
    _require(gap <= testing.TS_BAND,
             f"tiny slice: timestamps differ by {gap}")
    print(f"phase 3 ok: tiny f32 slice, CUDA == CPU over {len(cpu[1])} "
          f"chunks ({sum(t.shape[1] for t in cpu[1])} tokens, "
          f"{len(cpu[0]['chunks'])} words), max timestamp diff {gap:.4f} s "
          f"(band {testing.TS_BAND})", flush=True)

    from crisperwhisper_tpu_torch.ops import decode_step as ds
    for seconds, mode in ((5.0, "b1"), (12.0, "rows")):
        clip = testing.tone_audio(seconds, 0)
        cpu = testing.tiny_slice(ckpt, params, "cpu", clip, "serving")
        before = ds.whole_step.launches
        gpu = testing.tiny_slice(ckpt, params, "cuda", clip, "serving")
        launched = ds.whole_step.launches - before
        _require(launched > 0, f"tiny serving {mode}: no decode-step launch")
        try:
            gap = testing.slice_timestamp_gap(cpu, gpu)
        except AssertionError as e:
            raise SmokeError(f"tiny serving {mode}, CUDA against CPU: {e}"
                             ) from e
        _require(gap <= testing.TS_BAND,
                 f"tiny serving {mode}: timestamps differ by {gap}")
        print(f"phase 3 ok: tiny serving slice ({mode}, {seconds:.0f} s), "
              f"CUDA == CPU over {len(cpu[1])} chunks "
              f"({sum(t.shape[1] for t in cpu[1])} tokens), "
              f"{launched} decode-step launches, max timestamp diff "
              f"{gap:.4f} s", flush=True)


def _check_results(requests, results) -> None:
    """Non-empty text, word chunks with finite timestamps inside the clip,
    JSON-serialisable."""
    import math

    from crisperwhisper_tpu_torch import testing
    for (_, dur), res in zip(requests, results):
        _require(isinstance(res.get("text"), str) and res["text"],
                 f"{dur:.0f} s request: empty or malformed text")
        chunks = res.get("chunks")
        _require(isinstance(chunks, list) and len(chunks) > 0,
                 f"{dur:.0f} s request: no word chunks")
        for c in chunks:
            s, e = c["timestamp"]
            _require(all(isinstance(x, float) and math.isfinite(x)
                         and -1e-6 <= x <= dur + testing.TS_BAND
                         for x in (s, e)),
                     f"{dur:.0f} s request: timestamp {c['timestamp']} "
                     "outside the clip")
        json.dumps(res)


def _large_requests(tmp: str) -> list:
    from crisperwhisper_tpu_torch import testing
    wav = os.path.join(tmp, "speech60.wav")
    if not os.path.exists(wav):
        testing.write_wav(wav, testing.tone_audio(60.0, 1))
    return [(wav, 60.0), ({"raw": testing.tone_audio(12.0, 2),
                           "sampling_rate": testing.SR}, 12.0)]


def _large_ckpt(tmp: str, arch) -> str:
    from crisperwhisper_tpu_torch import testing
    return testing.write_large_v3_configs(os.path.join(tmp, "large_v3"),
                                          arch)


def phase4_large(tmp: str, large) -> dict[str, int]:
    import numpy as np
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models.whisper import (decode_step, encode,
                                                         init_cache)
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import dtw as dt
    from crisperwhisper_tpu_torch.ops import fused_attention as fa

    arch, params = large
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en")
    # random weights rarely close a segment: one seek pass per window and
    # 96 new tokens bound the time; the temperature ladder stays default
    pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=96,
                            force_unique_generate_call=True)
    requests = _large_requests(tmp)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in (fa.fused_attention, ap.align_prep, dt.dtw):
        wrapper.launches = 0
    results, walls = [], []
    for req, _ in requests:
        t0 = time.perf_counter()
        results.append(pipe(req, return_timestamps="word",
                            adjust_pauses_threshold=0.12))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"encoder_attention": fa.fused_attention.launches,
                "align_prep": ap.align_prep.launches,
                "dtw": dt.dtw.launches}
    peak = torch.cuda.max_memory_allocated()

    _check_results(requests, results)
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched on the main path")

    # the first window's logits: finite (no NaN) at full geometry
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    feats = extract_features(
        torch.from_numpy(np.pad(testing.tone_audio(12.0, 2),
                                (0, 18 * testing.SR)))[None]
        .cuda(), pipe.feat_cfg)
    enc = encode(pipe.params, arch, feats)
    cache = init_cache(pipe.params, arch, enc, cache_len=8)
    logits, _, _ = decode_step(
        pipe.params, arch,
        torch.full((1,), pipe.specials.sot, device="cuda"), 0, cache)
    _require(bool(torch.isfinite(logits).all()), "logits hold NaN or inf")

    print(f"phase 4 ok: large-v3 bf16 random weights; requests 60 s file "
          f"{walls[0]:.2f} s wall ({len(results[0]['chunks'])} words), "
          f"12 s array {walls[1]:.2f} s wall "
          f"({len(results[1]['chunks'])} words); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    return launches


def phase5_serving(tmp: str, large) -> int:
    """Quantized serving with the whole-step decode kernel. Returns the
    decode-step kernel's launches over both requests."""
    import torch
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import decode_step as ds
    from crisperwhisper_tpu_torch.ops import dtw as dt
    from crisperwhisper_tpu_torch.ops import fused_attention as fa

    arch, params = large
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en", quantize="serving")
    pipe.gen_opts = replace(pipe.gen_opts, b1_decode_kernel=True,
                            temperatures=(0.0,), max_new_tokens=96,
                            force_unique_generate_call=True)
    wav, arr = _large_requests(tmp)
    requests = [(arr, "decode_step_b1"), (wav, "decode_step_rows")]
    modes = {"decode_step_b1": 0, "decode_step_rows": 0}
    originals = {name: getattr(ds, name) for name in modes}

    def counted(name):
        def step(*a, **kw):
            modes[name] += 1
            return originals[name](*a, **kw)
        return step

    total, lines = 0, []
    try:
        for name in modes:
            setattr(ds, name, counted(name))
        for (req, dur), mode in requests:
            for wrapper in (fa.fused_attention, ap.align_prep, dt.dtw,
                            ds.whole_step):
                wrapper.launches = 0
            for name in modes:
                modes[name] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = pipe(req, return_timestamps="word",
                       adjust_pauses_threshold=0.12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"encoder_attention": fa.fused_attention.launches,
                        "align_prep": ap.align_prep.launches,
                        "dtw": dt.dtw.launches,
                        "decode_step": ds.whole_step.launches}
            _check_results([(req, dur)], [res])
            for name, n in launches.items():
                _require(n > 0, f"serving {dur:.0f} s request: kernel {name} "
                                "was not launched")
            _require(modes[mode] > 0 and sum(modes.values()) == modes[mode],
                     f"serving {dur:.0f} s request: steps by mode {modes}, "
                     f"expected {mode} only")
            total += launches["decode_step"]
            lines.append(f"{dur:.0f} s {mode}: {wall:.2f} s wall "
                         f"({len(res['chunks'])} words), peak device memory "
                         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
                         f"GiB, launches {launches}")
    finally:
        for name, fn in originals.items():
            setattr(ds, name, fn)
    print("phase 5 ok: large-v3 quantize='serving', b1_decode_kernel; "
          + "; ".join(lines), flush=True)
    return total


def _large_params():
    import torch
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    arch = WhisperArch.large_v3()
    return arch, init_params(arch, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda", torch.bfloat16)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import crisperwhisper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {HERE} ({e})",
              file=sys.stderr)
        return 2
    try:
        phase0_device()
        phase1_build()
        large = _large_params()
        entries = phase2_kernels(large)
        with tempfile.TemporaryDirectory(prefix="cw_smoke_") as tmp:
            phase3_tiny(tmp)
            launches = phase4_large(tmp, large)
            launches["decode_step"] = phase5_serving(tmp, large)
        _require("jax" not in sys.modules, "jax was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    kernels = [{k: (launches[e["name"]] if k == "launches" else e[k])
                for k in keys} for e in entries]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
