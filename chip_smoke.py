#!/usr/bin/env python3
"""Smoke run of the PyTorch port (crisperwhisper_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one line each on stdout:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from crisperwhisper_tpu_torch/csrc (one nvcc
     per source, in parallel; ptxas registers, spills and shared memory of
     both encoder-attention kernels, of the decode-step kernel and of the
     log-mel kernel and its clip kernel, the decode-attention kernel's
     instances and the probe kernel; registers and spills
     over the instantiations of the align-prep and DTW kernels);
  2. each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the maximum error and both times (the
     comparisons and bands of crisperwhisper_tpu_torch.testing, which
     tests/test_torch_gpu.py runs too); the alignment prep at [4, 15, 96,
     1500] and at the CLI's batch of 16 windows, one launch a call; the
     DTW, exact, at [4, 96, 1500] (also on the unmasked prep output, which
     must give the same path), [16, 96, 1500] and [4, 381, 1500] (the
     CLI's max_new_tokens), one launch a call, each with its walk and
     backtrace (globaltimer stamps) and its chain bound at the card's
     maximum SM clock; the encoder attention at bf16 and
     f16 [4, 20, 1500, 64] and bf16 [16, 20, 1500, 64] (the CLI's batch
     of 16 windows) on the tensor-core route and at f32 on the CUDA-core
     route, each row with its route, error, times, bound and the time of
     scaled_dot_product_attention; the decode-step kernel at
     large-v3 width (random int8 weights, random decoder biases and
     LayerNorms, a ring of 128 at position 60) for one row with int4 and
     int8 cross caches and four rows with int4, timed beside the
     quantized non-kernel decode_step, with the kernel's phase split
     (globaltimer stamps) from one untimed launch; then one row at
     position 0 (the fresh column alone in the ring), untimed, and eight
     more position-0 draws, each with where its fresh columns first part
     printed; at position 0 hid and align are held against the plain
     step fed the kernel's own fresh columns; in each case also fresh
     columns placed on the int8 rounding's ties; the verify-block (multi)
     mode at M = 5 with the same checks, timed beside the b1 mode, and
     at M = 1, where it must equal the b1 mode bit for bit; the beams
     mode at R = 5 (per-row rings, one int4 cross cache of batch 1) with
     the same checks, bit for bit equal to the rows mode on the cross
     cache repeated per row, timed beside b1 and rows at M = 4; the
     ring-write kernel at large-v3 width, batch 16, 5 columns a row, for
     bf16, int8 (with scales) and packed int4 rings, bit-identical to its
     plain version, timed per call with the rings' plan at hand (as
     models/whisper.py calls it) and looking it up, and, replayed from a
     CUDA graph, on the device alone; the fused log-mel at the CLI's
     batch of 16 windows x 128 mels, timed in turns with
     extract_features (torch.stft), with its split into the FFT launch
     and the clip launch (globaltimer stamps); the
     int8 cross attention of v1 and v2 at B = 16, H = 20, K = 1500 with
     an f32 q; the stacked-cache attention (v3) at the reference
     microbench's shape (L = 2, B = 64, H = 20, T = 1536, sel of 15
     heads) for int8, int4 and bf16 caches, at phase 8 (c)'s rows (B
     = 4, T = 1500) for int8 and int4, and at the plain decode step's
     shapes (large-v3, B = 64: the bf16 cross cache [32, 64, 20, 1500, 64]
     with a one-slot sel, the bf16 self ring [32, 64, 20, 100, 64] at
     position 60), there also through bind_decode_gemv, as
     models/whisper.py calls it; at the graphed step's bulk shapes (16
     and 64 rows, a bf16 self ring of 99) the stacked-cache attention at
     a 0-d int32 position on the device (-1, 0, 61, 98) within its bands
     of the plain version, and the ring write of one column a row at
     that position copied to every row (0, 61, 98) bit-identical to its
     plain version, each then captured in a CUDA graph and replayed with
     the position moved in place, equal to the integer form's bytes;
     each decode-attention row with the
     cluster size its plan picked, timed per call and, from a CUDA graph,
     on the device; the probe kernel, exact, timed per call and from a
     CUDA graph. Each timed kernel also prints
     its bound (the bytes it must move over 3.35 TB/s, or its operations
     over the peak rate of their type, whichever is larger; for the
     log-mel the operations of an FFT; for the DTW also its chain of
     dependent anti-diagonals)
     and the time
     of the one PyTorch call that computes the same function, where there
     is one;
  3. the TINY f32 slice on the card against the same slice on the CPU
     (plain versions), same seeded weights: tokens equal, word
     timestamps within 0.02 s; then the quantized serving slice with the
     decode-step kernel, one window (batch 1) and four (rows); then the
     speculative slice (prompt lookup over four windows: the ring-write
     kernel; self:1 on one serving window: the verify-block kernel),
     equal to the CPU and to greedy on the card; the beam slice
     (num_beams=4) equal to the CPU, and on one serving window with
     b1_decode_kernel (the beams mode, token agreement with the CPU at
     least 0.9); the prompting slice (prompt= text with
     condition_on_prev_tokens) equal to the CPU; the serving slice
     (testing.serving_slice: a StreamingBatcher whose worker thread runs
     the device batches of a 7 s and three 12 s streams, and a
     LiveSession fed the 12 s clip in ragged blocks) on the card and on
     the CPU: each stream's result equal to the card's pipe() of its
     audio in text and words, timestamps within 0.02 s, finish() equal to
     pipe(whole, adjust_pauses_threshold=0.12), partials in order and
     prefix-stable but for the open last word, the card's results equal
     to the CPU's;
  4. the full large-v3 geometry with random bf16 weights built on the
     card: load_pipeline answers a 60 s WAV file and a 12 s array with
     word timestamps and adjust_pauses=0.12, each with its wall and the
     process's CPU seconds inside it, both under torch.profiler and a
     recording() of the program's spans; every kernel's launch count
     is reset just before and read just after, and must be > 0 for the
     encoder attention, the alignment prep and the DTW; the stacked-cache
     attention (kernel 9) and the ring write (kernel 6), which the
     one-token step runs inside its CUDA graph, are counted in the device
     trace, and must equal two a layer and one a layer for every
     cw.decode.step record, where each decode (cw.decode.cache) has one
     cw.decode.capture and one eager step, the others replays (``graph``
     1), the captures' host ms printed; every encoder-attention launch
     must have taken the tensor-core
     route; the alignment tail (attention_to_jump_times: align prep +
     DTW) of each request is timed between CUDA events, with its calls
     and its share of the wall; then the plain step captured as one CUDA
     graph at a device position, 16 and 64 rows, a ring of 99: its device
     time over 20 replays (CUDA events);
  5. the same weights through load_pipeline(quantize="serving") with
     b1_decode_kernel: the 12 s array (batch 1, decode_step_b1) and the
     60 s WAV (3 windows, decode_step_rows), counts reset before each
     request; each must launch the decode-step kernel in its own mode and
     the other three kernels;
  6. speculative decoding at large-v3 geometry: (a) the default path with
     assistant="prompt_lookup" on the 60 s WAV (3 windows at per-row
     positions: the ring-write kernel), (b) quantize="serving" with
     b1_decode_kernel and prompt lookup on the 12 s array (batch 1: the
     verify-block kernel), (c) as (b) with assistant="self:4" (the draft
     chain on the b1 kernel). Each request runs greedy first, then
     speculatively with every count reset just before and read just
     after; it prints both walls, the acceptance rate, the token agreement
     with greedy (at least 0.9, the reference's band) and the launches by
     kernel and mode, and for (a) the host seconds spent inside the
     ring-write wrapper that models/whisper.py calls (a host clock around
     each call, no sync), a call's mean, the part of it spent in the
     launch (the ctypes call of the C entry, which waits when the card's
     launch queue is full) and their share of the wall;
  7. beams and prompts at large-v3 geometry: (a) num_beams=5 on the
     default path on the 60 s WAV (3 windows, one cross cache per item),
     (b) quantize="serving" with b1_decode_kernel and num_beams=5 on the
     12 s array (batch 1: the beams mode); the same request on f32 weights
     must agree with itself without b1_decode_kernel to at least 0.9 (the
     reference's band, set where both sides run f32 activations), and the
     agreements at bf16, where the plain step rounds its activations, are
     printed beside it, (c)
     pipe(audio, prompt=...) on the 12 s array. Each prints its wall
     beside the greedy wall of the same request and the launches by
     kernel and mode (counts reset just before each request);
  8. the remaining entry points at large-v3 width, on the main path's
     data, every count reset just before each part and read just after:
     (a) fused_log_mel on the windows ASRPipeline cuts from the 60 s WAV,
     against extract_features and the plain twin, and the encoder states
     of both feature batches compared (informative); (b) v1 and v2 on
     every layer of the int8 cross cache init_cache builds from that
     encoder output; (c) v3 on the stacked int8 and int4 cross caches of
     all 32 layers (sel of each layer's alignment heads) and on an int8
     self ring of 448 slots at position 60 with left pads; (d) the probe
     ladder's card rungs, in process and as
     ``python -m crisperwhisper_tpu_torch.probe plain,probe_add``;
  9. serving at large-v3 width (random bf16 weights, batch_size 8, one
     temperature, 96 new tokens): the 60 s WAV twice and the 12 s array
     submitted together with on_partial to (a) StreamingBatcher(pipe,
     warmup=True) on the default path (the warmed batch sizes and their
     seconds), (b) a batcher over quantize="serving" with
     b1_decode_kernel (the decode step's rows mode), then a LiveSession
     fed the 60 s WAV in 0.5 s blocks (its b1 mode); every count reset
     just before each run and read once every stream has its result
     (no other thread launches then). Each prints each stream's seconds
     from submit() to result(), the first partial's time, the audio
     seconds per wall second, the live session's seconds per window at
     batch 1 and the token agreement with pipe() of the same audio
     (printed, not gated: bf16), and holds well-formed results, ordered
     prefix-stable partials and launches of kernels 1-3 (and of the
     decode step in its mode, in (b)). A failure in a batcher's worker
     thread reaches the smoke through result() and fails it;
 10. the full-sequence, auxiliary, short-form, checkpoint and progress
     entry points at large-v3 width (random bf16 weights) on the 4 rows
     ASRPipeline cuts from the 60 s WAV (3 windows and a padding row),
     every count reset just before each part and read just after: (a)
     forward on 96 decoder ids (the prompt and the seek loop's tokens for
     those windows) against decode_step fed the same ids one by one: top-1
     agreement at least 0.9 and the largest logit difference at most
     1e-3 on f32 weights (phase 2 turned TF32 off), the agreement and the
     difference at bf16 printed beside them, every encoder-attention launch on the tensor cores; (b)
     audio_classification_forward with a random 16-label head: finite
     [4, 16] f32 logits; (c) generate_short_form with word timestamps:
     kernels 1-3 launched, timestamps non-decreasing over each row's
     prompt and tokens, its wall and the process's CPU seconds; (d) the
     same on fused group-wise int4 weights with b1_decode_kernel: kernels
     1-3 launched, the decode-step kernel not (its gate takes int8 weights
     only), the token agreement with (c) printed; (e) the first 4 layers
     of each stack through save_hf_checkpoint -> load_params(device=
     "cuda") and, fused int8 and int4, save_params -> load_saved_params(
     device="cuda"): every leaf back bit-equal with its dtype, bytes and
     seconds printed; (f) generate(monitor_progress=...) on the 60 s WAV's
     features: one call a seek pass, seek non-decreasing below max_frames;
 11. tensor-parallel serving over torch.distributed (parallel/): (a)
     load_pipeline(mesh=) on a 1 x 1 mesh, a world of one over NCCL in
     this process, on phase 4's weights and 60 s WAV: text and words equal
     to phase 4's, timestamps within 0.02 s; (b) two ranks at model = 2
     (testing.run_world: NCCL on two cards where the machine has them,
     else both on this card over gloo, printed) at large-v3 width on the
     12 s array with 48 new tokens, bf16 then f32 weights with TF32 off
     (testing.mesh_slice): each rank at most
     0.55 + 0.45 / 2 of the replicated parameter bytes, its encoder
     attention at 10 heads, on the tensor cores at bf16; rank 0's f32
     tokens agreeing with the unsharded f32 run here at least 0.9; rank
     0's bf16 wall beside the unsharded one (not a speed comparison when
     both ranks share one card); three streams through a StreamingBatcher
     over the f32 mesh pipeline equal to the direct call in text and
     words, timestamps within 0.02 s; (c) dryrun_multichip on every card where there are
     two or more, else printed as not run.
 12. the speech LM's grouped expert kernel (csrc/moe.cu) at
     Uni-MoE-2.0-Omni's published widths and 2 of its 28 language-model
     layers (random bf16 weights at the benchmark's scales,
     testing.speech_moe_params): (a) one layer's routed experts at the
     benchmark cell's shapes, 64 decode tokens (step tiles) and a prefill
     of 64 window prompts (block tiles; 64 x 251 positions in this
     checkpoint's vocabulary, 64 x 215 in the benchmark's), routed by the
     layer's gate, against moe._plain within testing.MOE_BAND, timed
     beside the plain twin and the bound of the experts with rows and the
     routed rows (portbench/work_speech_moe.expert_work); (b) the main
     path:
     load_pipeline on a weightless checkpoint of it and pipe() on 64
     recordings of 10 s (one batch of 64 windows, 96 new tokens each),
     the kernel's launch count reset just before and read just after:
     two a layer for each prefill and each step that the call's
     cw.decode records count, every result non-empty text.
Then a JSON line with one entry per kernel (launches: phases 4, 9, 10 and
11 for the first three, over every rank in phase 11, phases 5, 6, 7 and
9 for the decode step, phases 4 (on the device) and 6 (a) for the ring
write, phases 4 (on the device) and 8 for the stacked-cache attention, phase 8 for the other four, phase 12
(b) for the grouped expert kernel), the card's
name and power limit, and as the last line
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


def _graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's cost per call drops out."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


HBM_BYTES_PER_MS = 3.35e9          # H100 SXM data sheet: 3.35 TB/s
PEAK_OPS_PER_MS = {"bf16": 989e9, "f16": 989e9,   # tensor cores
                   "f32": 67e9}                    # CUDA cores


def _bound(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card needs for this work, what binds it): the bytes
    over the memory rate, or the operations over the peak rate of their
    type, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_MS
    t_ops = ops / PEAK_OPS_PER_MS[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz (nvidia-smi clocks.max.sm)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0])


def _dtw_chain_ms(n_tokens, n_frames, clock_mhz: float) -> float:
    """The DTW's chain bound: its longest item walks nt + nf - 1 dependent
    anti-diagonals, each at least one f32 min and one f32 add of 4 cycles
    each at the SM clock (the backtrace's steps left out: a design could
    hold them in registers)."""
    diagonals = int((n_tokens.long() + n_frames.long()).max()) - 1
    return max(diagonals, 0) * 2 * 4 / (clock_mhz * 1e3)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _step_work(params, arch, cache, position: int, m: int, multi: bool,
               n_align: int) -> tuple[float, float]:
    """(bytes, f32 operations) of one whole decoder step over M rows: every
    int8 weight and f32 vector row once, the cross caches and scales, the
    live ring prefix read and the fresh columns written, x0 in, hid and
    alignment rows out; two operations per weight and row, and per
    attended key and value element."""
    lay = params["decoder"]["layers"]
    weights = sum(_nbytes(lp[g][n]["w_q"]) for lp in lay
                  for g, n in (("self", "qkv"), ("self", "o"),
                               ("cross", "q"), ("cross", "o"),
                               ("mlp", "fc1"), ("mlp", "fc2")))
    d, f = arch.d_model, arch.decoder_ffn_dim
    vec = len(lay) * (20 * d + 2 * f) * 4
    cross = _nbytes(cache.cross_k, cache.cross_v, cache.cross_k_scale,
                    cache.cross_v_scale)
    n_new = m if multi else 1
    live = position + n_new
    slots = cache.self_k.shape[0] * cache.self_k.shape[1] \
        * cache.self_k.shape[2]                  # L x streams x H
    ring = 2 * slots * (live * (arch.head_dim + 2) + n_new * (
        arch.head_dim + 2))
    io = 2 * m * d * 4 + m * n_align * cache.cross_k.shape[3] * 4
    ops = 2 * weights * m + 4 * arch.decoder_layers * m * d * (
        live + cache.cross_k.shape[3])
    return weights + vec + cross + ring + io, ops


def _log_mel_work(cfg, wave) -> tuple[float, float]:
    """(bytes, f32 operations) that the log-mel function needs on ``wave``
    [B, n_samples]: each sample read once, each feature written once, the
    mel bank's nonzero weights read once; per frame the window (one
    multiply a tap), a real FFT of n_fft points (2.5 n log2 n, half the 5
    n log2 n of a complex FFT), the power (3 a bin), the mel sums over the
    bank's nonzeros (2 each; a bin falls in at most two filters), and
    log10, the clip and the affine step (4 a feature)."""
    import math

    from crisperwhisper_tpu_torch.audio import fused_mel as fm
    n_bins, n_mels = cfg.n_fft // 2 + 1, cfg.feature_size
    frames = wave.shape[0] * cfg.nb_max_frames
    nonzero = int((fm._tables(cfg, wave.device)[1] != 0).sum())
    n_bytes = _nbytes(wave) + 4 * (frames * n_mels + nonzero)
    ops = frames * (cfg.n_fft + 2.5 * cfg.n_fft * math.log2(cfg.n_fft)
                    + 3 * n_bins + 2 * nonzero + 4 * n_mels)
    return n_bytes, ops


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
    kern = _build.kernels()
    regs = [ln.strip() for ln in kern.ptxas_log.splitlines()
            if "registers" in ln]
    print(f"phase 1 ok: nvcc built {kern.path.name} in "
          f"{kern.build_seconds:.2f} s; ptxas: {' | '.join(regs)}",
          flush=True)
    print("phase 1 encoder_attention.cu: " + "; ".join(
        sum((_ptxas_summary(kern.ptxas_log, name) for name in (
            "attention_tc_kernel", "encoder_attention_kernel")), []))
        + "; tensor-core CTA dynamic shared memory (Dh 16/32/64): "
        + "/".join(str(kern.lib.cw_encoder_attention_tc_smem(d))
                   for d in (16, 32, 64)) + " bytes", flush=True)
    print("phase 1 align_prep.cu, dtw.cu: " + "; ".join(
        _ptxas_range(kern.ptxas_log, name)
        for name in ("align_prep_kernel", "dtw_kernel")), flush=True)
    print("phase 1 decode_step.cu: " + "; ".join(
        _ptxas_summary(kern.ptxas_log, "decode_step_kernel")), flush=True)
    print("phase 1 log_mel.cu, decode_attention.cu, probe.cu: " + "; ".join(
        sum((_ptxas_summary(kern.ptxas_log, name) for name in (
            "log_mel_kernel", "clip_affine_kernel",
            "decode_attention_kernel", "probe_add_kernel")), [])),
        flush=True)


def _ptxas_summary(log: str, kernel: str) -> list[str]:
    """'<entry>: N registers[, static smem and the rest of ptxas's Used
    line], S bytes spill stores, L bytes spill loads' for each compiled
    entry whose name holds ``kernel``."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if kernel in ln else None
        elif name and "spill stores" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].strip()
            out.append(f"{name}: {regs}, {spill}")
            name = None
    return out


def _ptxas_range(log: str, kernel: str) -> str:
    """'<kernel>: E entries, R0-R1 registers, S bytes spill stores, L bytes
    spill loads' over every compiled instantiation of ``kernel``."""
    import re
    regs, spills = [], [0, 0]
    for line in _ptxas_summary(log, kernel):
        regs.append(int(re.search(r"(\d+) registers", line).group(1)))
        for i, what in enumerate(("spill stores", "spill loads")):
            found = re.search(rf"(\d+) bytes {what}", line)
            spills[i] += int(found.group(1)) if found else 0
    return (f"{kernel}: {len(regs)} entries, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {spills[0]} bytes spill "
            f"stores, {spills[1]} bytes spill loads")


def _print_phases(mode: str, ms: float, shares: dict) -> None:
    """One line of the decode-step kernel's phase split (globaltimer
    stamps of one untimed launch)."""
    print(f"phase 2 decode_step phases {mode}: {ms:.4f} ms start to last "
          "barrier; " + ", ".join(f"{k} {100 * v:.1f}%"
                                  for k, v in shares.items()), flush=True)


def phase2_kernels(large) -> list[dict]:
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import alignment as al
    from crisperwhisper_tpu_torch.ops import dtw as dt
    from crisperwhisper_tpu_torch.ops import fused_attention as fa

    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = []

    # --- kernel 1: encoder attention against the plain version on the
    # f32 widening of its inputs (bands: testing.attention_error); 16-bit
    # rows on the tensor-core route, f32 on the CUDA-core route. The f16
    # and batch-16 rows draw from a generator of their own, so the shared
    # one's stream, and with it every later check's inputs, stay as they
    # were before those rows existed.
    own = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for shape, dtype, g in (((4, 20, 1500, 64), torch.bfloat16, gen),
                            ((4, 20, 1500, 64), torch.float16, own),
                            ((16, 20, 1500, 64), torch.bfloat16, own),
                            ((4, 20, 1500, 64), torch.float32, gen),
                            ((4, 20, 300, 64), torch.float32, gen)):
        q, k, v = (torch.randn(shape, generator=g, device=dev) * s
                   for s in (0.3, 0.3, 1.0))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        path = fa.route(dtype, shape[3])
        before = fa.fused_attention.route_launches[path]
        err, band = testing.attention_error(q, k, v)
        _require(fa.fused_attention.route_launches[path] == before + 1,
                 f"attention {shape} {dtype}: not on the {path} route")
        ms = _time_ms(lambda: fa.fused_attention(q, k, v), 20)
        plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v), 5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0), 20)
        _require(err <= band, f"attention {shape} {dtype}: max err {err} "
                              f"> {band}")
        kind = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype,
                                                                 "f32")
        bound, by = _bound(_nbytes(q, k, v, q), 4 * q.numel() * shape[2],
                           kind)
        rows.append(f"{list(shape)} {str(dtype)[6:]} {path} err {err:.3g} "
                    f"(band {band:.3g}) {ms:.4f} ms vs plain "
                    f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
                    f"scaled_dot_product_attention {lib_ms:.4f} ms")
        if len(entries) == 0:           # the main path's case (bf16)
            entries.append({
                "name": "encoder_attention", "route": "cuda",
                "kernel_route": path,
                "source": "crisperwhisper_tpu_torch/csrc/encoder_attention.cu",
                "replaces": "crisperwhisper_tpu/ops/fused_attention.py:37",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    print("phase 2 attention: " + "; ".join(rows), flush=True)

    # --- kernel 2: alignment prep, one row cropped to 1000 frames; then
    # the CLI's batch of 16 windows (a generator of its own, so the shared
    # one's stream stays as it was)
    b, a, t, m = 4, 15, 96, 1500
    w = torch.softmax(torch.randn((b, a, t, m), generator=gen, device=dev)
                      * 3.0, dim=-1).contiguous()
    nt = torch.tensor([96, 80, 51, 96], dtype=torch.int32, device=dev)
    nf = torch.tensor([1500, 1500, 1500, 1000], dtype=torch.int32,
                      device=dev)
    own = torch.Generator(device=dev).manual_seed(2)
    w16 = torch.softmax(torch.randn((16, a, t, m), generator=own, device=dev)
                        * 3.0, dim=-1).contiguous()
    nt16, nf16 = nt.repeat(4), nf.repeat(4)
    rows = []
    for ww, nn, ff in ((w, nt, nf), (w16, nt16, nf16)):
        err, got = testing.align_prep_error(ww, nn, ff)
        before = ap.align_prep.launches
        ms = _time_ms(lambda: ap.align_prep(ww, nn, ff, 7), 20)
        _require(ap.align_prep.launches == before + 21,
                 "align_prep: not one launch a call")
        plain_ms = _time_ms(lambda: ap.align_prep_plain(ww, nn, ff, 7), 3)
        _require(err <= testing.PREP_BAND,
                 f"align_prep {list(ww.shape)}: max err {err} > "
                 f"{testing.PREP_BAND}")
        # the live input cells read once, the output written once; z-norm,
        # a 7-tap median (a sorting network) and the head mean: about 20 f32
        # operations per live input value
        live = a * int((nn.long() * ff.long()).sum())
        bound, by = _bound(4 * live + _nbytes(nn, ff, got), 20 * live, "f32")
        rows.append(f"{list(ww.shape)} err {err:.3g} (band "
                    f"{testing.PREP_BAND}) {ms:.4f} ms vs plain "
                    f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})")
        if ww is w:
            prep, entry = got, {
                "name": "align_prep", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/align_prep.cu",
                "replaces": "crisperwhisper_tpu/ops/pallas_align.py:44",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}
    entries.append(entry)
    print("phase 2 align_prep: " + "; ".join(rows)
          + "; no single library call", flush=True)

    # --- kernel 3: DTW, exact, on the masked cost of that prep (and equal
    # on the unmasked prep: it reads only the live rectangle); then at the
    # CLI's batch of 16 and at N = 381 (the CLI's max_new_tokens)
    clock = _sm_clock_mhz()
    big = torch.tensor(1e9, device=dev)
    cost = torch.where(testing.live_cells(nt, nf, t, m), prep, big
                       ).contiguous()
    _require(bool((dt.dtw(prep, nt, nf) == dt.dtw(cost, nt, nf)).all()),
             "dtw: the unmasked cost gives another path")
    w381 = torch.softmax(torch.randn((4, a, 381, m), generator=own,
                                     device=dev) * 3.0, dim=-1).contiguous()
    nt381 = torch.tensor([381, 300, 200, 381], dtype=torch.int32, device=dev)
    rows = []
    for pw, nn, ff in ((prep, nt, nf),
                       (ap.align_prep(w16, nt16, nf16, 7), nt16, nf16),
                       (ap.align_prep(w381, nt381, nf, 7), nt381, nf)):
        cb, cn, cm = pw.shape
        c = torch.where(testing.live_cells(nn, ff, cn, cm), pw, big
                        ).contiguous()
        err = testing.dtw_error(c, nn, ff)
        before = dt.dtw.launches
        ms = _time_ms(lambda: dt.dtw(c, nn, ff), 20)
        _require(dt.dtw.launches == before + 21, "dtw: not one launch a call")
        plain_ms = _time_ms(lambda: al.dtw_jump_times(c, nn, ff), 1)
        _require(err == 0, f"dtw {[cb, cn, cm]}: off by up to {err} frames")
        total, walk, back = testing.dtw_phases(c, nn, ff)
        # the live cells of this run's rows, read once; the DP does about
        # four f32 operations a cell; the path out is one int32 a token
        cells = int((nn.long() * ff.long()).sum())
        bound, by = _bound(4 * cells + _nbytes(nn, ff) + 4 * cb * cn,
                           4 * cells, "f32")
        chain = _dtw_chain_ms(nn, ff, clock)
        if chain > bound:
            bound, by = chain, "chain"
        rows.append(f"{[cb, cn, cm]} exact (max diff {err} frames) {ms:.4f} "
                    f"ms vs plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
                    f"({by}; chain {chain:.5f} ms at {clock:.0f} MHz); "
                    f"stamps {total:.4f} ms, walk {walk:.4f} ms, backtrace "
                    f"{back:.4f} ms")
        if pw is prep:
            entries.append({
                "name": "dtw", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/dtw.cu",
                "replaces": "crisperwhisper_tpu/ops/pallas_dtw.py:59",
                "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    print("phase 2 dtw: " + "; ".join(rows) + "; no single library call",
          flush=True)

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
    # timed). At position 0 hid and align are held against the plain step
    # fed the kernel's own fresh columns, and those columns' values and
    # bf16 scales against the plain step's own rounding
    # (testing.decode_step_errors): a fresh V value or scale that rounds
    # one step apart on the two sides is there the head's only V slot and
    # would reach the unfed hid whole.
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
        bound, by = _bound(*_step_work(qparams, arch, cache, pos, rows,
                                       False, len(heads)), "f32")
        print(line + f"; kernel {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
              f"quantized decode_step {step_ms:.3f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
        if cross == "int4":
            _print_phases(f"M={rows}" if rows > 1 else "b1",
                          *testing.decode_step_phases(
                              qparams, arch, x0, pos, cache, tuple(heads)))
        if rows == 4:
            rows_ms = ms
        if len(entries) == 3:           # the batch-1 serving case
            b1_ms = ms
            entries.append({
                "name": "decode_step", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/decode_step.cu",
                "replaces": "crisperwhisper_tpu/ops/pallas_decode_b1.py:162",
                "max_abs_err": errs["hid"][0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None})
    del work, cache

    # --- kernel 4 at position 0 over other draws (generators of their
    # own): each draw's fed hid and align and its fresh values and scales
    # held to the bands above, and where the fresh columns (values or
    # bf16 scales) first part from the unfed plain step's printed
    # (testing.fresh_column_divergence).
    for seed in range(8):
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        cache = testing.random_step_cache(arch, 1, "int4", 128, 0, g)
        tok = torch.randint(0, arch.vocab_size, (1,), generator=g,
                            device=dev)
        x0 = (dec["tok_emb"][tok].float()
              + dec["pos_emb"][0][None].float()).contiguous()
        errs = testing.decode_step_errors(qparams, arch, x0, 0, cache,
                                          tuple(heads))
        div = testing.fresh_column_divergence(qparams, arch, x0, 0, cache)
        line = (f"phase 2 decode_step position-0 scan, seed {100 + seed}: "
                + ", ".join(f"{k} err {e:.3g} (band {b:.3g})"
                            for k, (e, b) in errs.items() if k != "logits"))
        if div["first"] is None:
            line += "; fresh columns equal"
        else:
            live = [i for i, n in enumerate(div["cells"]) if n]
            line += (f"; {sum(div['cells'])} fresh values differ in layers "
                     f"{live[0]}-{live[-1]} ({len(live)} layers), bf16 "
                     f"scales in {sum(div['scales'])}; first V layer "
                     f"{div['first_v']}, first scale layer "
                     f"{div['first_scale']}")
        for li, at in div["at"].items():
            parts = [f"{h} head {hd} dim {dm}: kernel {kq}, plain {pq}, "
                     f"plain unrounded {u:.6f} ({m:.3g} steps from the "
                     f"boundary; {uk:.6f} on the kernel's residual)"
                     for h, hd, dm, kq, pq, u, m, uk in at["flips"][:4]]
            parts += [f"{h} scale head {hd}: kernel {ks:.6g}, plain "
                      f"{ps:.6g}, plain f32 {u:.9g} ({m:.3g} bf16 steps "
                      f"from the boundary; {uk:.9g} on the kernel's "
                      f"residual)"
                      for h, hd, ks, ps, u, m, uk in at["scale_flips"][:4]]
            line += (f"; layer {li}: residual {at['hid_in']:.3g} of its "
                     f"largest apart, moving values up to "
                     f"{at['shift']:.3g} steps, bf16 scales apart "
                     f"{div['scales'][li]}; " + "; ".join(parts))
        print(line, flush=True)
        for name, (err, band) in errs.items():
            _require(err <= band, f"decode step position-0 scan, seed "
                                  f"{100 + seed}: {name} max err {err} > "
                                  f"{band}")
    del cache

    # --- the verify-block (multi) mode: 5 tokens of one stream at 60
    cache = testing.random_step_cache(arch, 1, "int4", 128, 60, gen)
    tok = torch.randint(0, arch.vocab_size, (5,), generator=gen, device=dev)
    x0 = (dec["tok_emb"][tok].float()
          + dec["pos_emb"][60:65].float()).contiguous()
    errs = testing.decode_step_errors(qparams, arch, x0, 60, cache,
                                      tuple(heads), multi=True)
    errs["ties"] = (testing.tie_column_error(qparams, arch, x0, 60, cache,
                                             multi=True), 0)
    for name, (err, band) in errs.items():
        _require(err <= band, f"decode step multi M=5: {name} max err "
                              f"{err} > {band}")
    work = testing.clone_cache(cache)
    ms = _time_ms(lambda: ds.whole_step(qparams, arch, x0, 60, work,
                                        tuple(heads), multi=True), 20)
    plain_ms = _time_ms(lambda: ds.whole_step_plain(
        qparams, arch, x0, 60, work, tuple(heads), multi=True), 3)
    bound, by = _bound(*_step_work(qparams, arch, cache, 60, 5, True,
                                   len(heads)), "f32")
    _print_phases("multi M=5", *testing.decode_step_phases(
        qparams, arch, x0, 60, cache, tuple(heads), multi=True))
    print("phase 2 decode_step multi: M=5 int4 cross, ring 128 at 60: "
          + ", ".join(f"{k} err {e:.3g} (band {b:.3g})"
                      for k, (e, b) in errs.items())
          + f"; kernel {ms:.3f} ms (b1 {b1_ms:.3f} ms) vs plain "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by})", flush=True)
    # one row: the multi mode runs the b1 arithmetic, bit for bit
    one = x0[:1].contiguous()
    a, c = testing.clone_cache(cache), testing.clone_cache(cache)
    hid1, al1 = ds.whole_step(qparams, arch, one, 60, a, tuple(heads))
    hidm, alm = ds.whole_step(qparams, arch, one, 60, c, tuple(heads),
                              multi=True)
    same = (torch.equal(hid1, hidm) and torch.equal(al1, alm)
            and all(torch.equal(getattr(a, n), getattr(c, n))
                    for n in ("self_k", "self_v", "self_k_scale",
                              "self_v_scale")))
    _require(same, "decode step multi at M=1 differs from the b1 mode")
    print("phase 2 decode_step multi: M=1 equals the b1 mode bit for bit",
          flush=True)
    del work, cache, a, c

    # --- the beams mode: 5 beams of one item at 60, per-row rings, one
    # int4 cross cache
    cache = testing.random_step_cache(arch, 5, "int4", 128, 60, gen,
                                      shared_cross=True)
    tok = torch.randint(0, arch.vocab_size, (5,), generator=gen, device=dev)
    x0 = (dec["tok_emb"][tok].float()
          + dec["pos_emb"][60][None].float()).contiguous()
    errs = testing.decode_step_errors(qparams, arch, x0, 60, cache,
                                      tuple(heads), beams=True)
    errs["ties"] = (testing.tie_column_error(qparams, arch, x0, 60, cache,
                                             beams=True), 0)
    for name, (err, band) in errs.items():
        _require(err <= band, f"decode step beams R=5: {name} max err "
                              f"{err} > {band}")
    differ = testing.beams_rows_mismatch(qparams, arch, x0, 60, cache,
                                         tuple(heads))
    _require(not differ, f"decode step beams R=5 differs from the rows mode "
                         f"on the repeated cross cache in {differ}")
    work = testing.clone_cache(cache)
    ms = _time_ms(lambda: ds.whole_step(qparams, arch, x0, 60, work,
                                        tuple(heads), beams=True), 20)
    plain_ms = _time_ms(lambda: ds.whole_step_plain(
        qparams, arch, x0, 60, work, tuple(heads), beams=True), 3)
    bound, by = _bound(*_step_work(qparams, arch, cache, 60, 5, False,
                                   len(heads)), "f32")
    _print_phases("beams R=5", *testing.decode_step_phases(
        qparams, arch, x0, 60, cache, tuple(heads), beams=True))
    print("phase 2 decode_step beams: R=5, int4 cross of batch 1, rings 128 "
          "at 60: " + ", ".join(f"{k} err {e:.3g} (band {b:.3g})"
                                for k, (e, b) in errs.items())
          + f"; equals the rows mode on the repeated cross cache bit for "
          f"bit; kernel {ms:.3f} ms (b1 {b1_ms:.3f} ms, rows M=4 "
          f"{rows_ms:.3f} ms) vs plain {plain_ms:.3f} ms, bound "
          f"{bound:.4f} ms ({by})", flush=True)
    del work, cache

    # --- kernel 6: the per-row ring writes of a verify block, batch 16
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rows = []
    ring = 448 + 5                      # max_target_positions + spec_len
    for kind in ("bf16", "int8", "int4"):
        pairs, pos = testing.ring_write_inputs(arch, 16, 5, ring, kind, gen)
        err = testing.ring_write_error(pairs, 7, pos)
        _require(err == 0, f"ring_write {kind}: {err} bytes differ")
        plan = rw.ring_plan([ring for ring, _ in pairs])
        ms = _time_ms(   # as models/whisper.py calls it: the plan at hand
            lambda: rw.write_block_columns_group(pairs, 7, pos, plan), 200)
        lookup_ms = _time_ms(
            lambda: rw.write_block_columns_group(pairs, 7, pos), 200)
        device_ms = _graph_ms(
            lambda: rw.write_block_columns_group(pairs, 7, pos, plan), 200)
        pos_h = pos.cpu()
        plain_ms = _time_ms(lambda: rw.write_block_columns_plain(
            pairs, 7, pos_h), 20)
        lib_ms = _time_ms(lambda: testing.ring_write_library(pairs, 7, pos),
                          200)
        bound, by = _bound(2 * _nbytes(*(blk for _, blk in pairs)), 0.0,
                           "f32")
        rows.append(f"{kind} bit-identical, {ms:.4f} ms a call "
                    f"({lookup_ms:.4f} ms looking the plan up; "
                    f"{device_ms:.4f} ms on the device, from a CUDA graph) "
                    f"vs plain {plain_ms:.4f} ms, index_put_ {lib_ms:.4f} "
                    f"ms, bound {bound:.5f} ms ({by})")
        if kind == "bf16":              # the default path's ring
            entries.append({
                "name": "ring_write", "route": "cuda",
                "source": "crisperwhisper_tpu_torch/csrc/ring_write.cu",
                "replaces": "crisperwhisper_tpu/ops/ring_scatter.py:116",
                "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
        del pairs
    print("phase 2 ring_write: large-v3 [32, 16, 20, 453] rings, 5 columns "
          "a row: " + "; ".join(rows), flush=True)
    return entries


def phase2_remaining(large) -> list[dict]:
    """The kernels of the remaining entry points against their plain
    versions on the card: the fused log-mel at the CLI's batch of 16
    windows x 128 mels, the v1 and v2 cross attention at B = 16, the
    stacked-cache attention at the reference microbench's shape for int4,
    int8 and bf16 caches and at the plain decode step's shapes, and the
    probe."""
    import torch
    from crisperwhisper_tpu_torch import probe, testing
    from crisperwhisper_tpu_torch.audio import fused_mel as fm
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    from crisperwhisper_tpu_torch.config import FeatureConfig
    from crisperwhisper_tpu_torch.ops import decode_attention as da

    arch, _ = large
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    entries = []

    # --- the fused log-mel: 16 windows of a tone in noise, 128 mels
    cfg = FeatureConfig(feature_size=arch.num_mel_bins)
    t = torch.arange(cfg.n_samples, device=dev) / testing.SR
    wave = (0.2 * torch.sin(2 * torch.pi * 300 * t)[None]
            + 0.1 * torch.randn((16, cfg.n_samples), generator=gen,
                                device=dev)).contiguous()
    errs, _ = testing.mel_errors(wave, cfg)
    for name, (err, band) in errs.items():
        _require(err <= band, f"log_mel against {name}: max err {err} > "
                              f"{band}")
    ms = _time_ms(lambda: fm.fused_log_mel(wave, cfg), 20)
    plain_ms = _time_ms(lambda: fm.log_mel_plain(wave, cfg), 5)
    lib_ms = _time_ms(lambda: extract_features(wave, cfg), 20)
    lib_ms_2 = _time_ms(lambda: extract_features(wave, cfg), 20)
    ms_2 = _time_ms(lambda: fm.fused_log_mel(wave, cfg), 20)
    split = [testing.log_mel_phases(wave, cfg) for _ in range(3)]
    n_bytes, ops = _log_mel_work(cfg, wave)
    bound, by = _bound(n_bytes, ops, "f32")
    print(f"phase 2 log_mel: [16, {cfg.n_samples}] -> [16, "
          f"{cfg.feature_size}, {cfg.nb_max_frames}] err against the plain "
          f"twin {errs['plain'][0]:.3g}, against extract_features "
          f"{errs['stft'][0]:.3g} (band {testing.MEL_BAND}); "
          f"{ms:.4f} / {ms_2:.4f} ms a call (kernel, extract_features, "
          f"extract_features, kernel: {lib_ms:.4f} / {lib_ms_2:.4f} ms), "
          "on the device (globaltimer stamps of 3 calls: start to end, FFT "
          "launch, clip launch) " + "; ".join(
              f"{a:.4f}, {f:.4f}, {c:.4f} ms" for a, f, c in split)
          + f"; plain {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}: "
          f"{n_bytes / 1e6:.1f} MB; {ops / 1e9:.3f} GFLOP with an FFT)",
          flush=True)
    entries.append({
        "name": "log_mel", "route": "cuda",
        "source": "crisperwhisper_tpu_torch/csrc/log_mel.cu",
        "replaces": "crisperwhisper_tpu/audio/pallas_mel.py:59",
        "max_abs_err": max(errs["plain"][0], errs["stft"][0]), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": lib_ms})
    del wave

    # --- v1 and v2: one f32 query per (row, head) over an int8 cache
    q, k, ks, v, vs = testing.decode_attention_inputs(
        (16, 20, 1500, 64), "int8", gen, torch.float32)
    args = (q[:, :, None], k, ks[..., None], v, vs[..., None])
    out_b, probs_b = 4 * q.numel(), 4 * 16 * 20 * 1500
    bound, by = _bound(_nbytes(*args) + out_b + probs_b,
                       4 * k.numel(), "f32")
    for name, fn, v2, replaces in (
            ("cross_attention_int8", da.cross_attention_int8, False,
             "experiments/decode_attention_v1.py:26"),
            ("cross_attention_int8_v2", da.cross_attention_int8_v2, True,
             "experiments/decode_attention_v2.py:21")):
        errs = testing.cross_attention_errors(*args, v2=v2)
        for key, (err, band) in errs.items():
            _require(err <= band, f"{name}: {key} max err {err} > {band}")
        ms = _time_ms(lambda: fn(*args), 20)
        device_ms = _graph_ms(lambda: fn(*args), 20)
        plain_ms = _time_ms(lambda: da.cross_attention_int8_plain(
            *args, q_bf16=v2), 20)
        cluster, _ = da._plan_for(q, 16 * 20, 1500, torch.int8)
        print(f"phase 2 {name}: q f32 [16, 20, 1, 64], int8 K/V [16, 20, "
              f"1500, 64]: " + ", ".join(f"{key} err {e:.3g} (band "
                                         f"{b:.3g})"
                                         for key, (e, b) in errs.items())
              + f"; {ms:.4f} ms a call ({device_ms:.4f} ms on the device, "
              f"from a CUDA graph) vs plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), clusters of {cluster}, no single "
              "library call", flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "crisperwhisper_tpu_torch/csrc/decode_attention.cu",
            "replaces": replaces, "max_abs_err": errs["out"][0], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    del q, k, ks, v, vs, args

    # --- v3 at the reference microbench's shape (decode_gemv_v3.py:274)
    # and at phase 8 (c)'s rows (the 4 windows of the 60 s WAV, K = 1500)
    sel = torch.zeros((20, testing.LARGE_V3_ALIGN_HEADS), device=dev)
    for a in range(testing.LARGE_V3_ALIGN_HEADS):
        sel[a % 20, a] = 1.0
    for label, shape, kinds in (
            ("microbench", (2, 64, 20, 1536, 64), ("int8", "int4", "bf16")),
            ("phase 8 (c) rows", (2, 4, 20, 1500, 64), ("int8", "int4"))):
        rows = []
        for kind in kinds:
            q, k, ks, v, vs = testing.decode_attention_inputs(
                shape, kind, gen, torch.bfloat16)
            kw = dict(sel=sel) if kind == "bf16" else dict(
                k_scale=ks, v_scale=vs, sel=sel)
            errs = testing.decode_gemv_errors(q, k, v, 1, **kw)
            for key, (err, band) in errs.items():
                _require(err <= band, f"decode_gemv_attention {label} "
                                      f"{kind}: {key} max err {err} > "
                                      f"{band}")
            ms = _time_ms(lambda: da.decode_gemv_attention(q, k, v, 1, **kw),
                          20)
            device_ms = _graph_ms(
                lambda: da.decode_gemv_attention(q, k, v, 1, **kw), 20)
            plain_ms = _time_ms(lambda: da.decode_gemv_plain(q, k, v, 1,
                                                             **kw), 5)
            layer = [x[1] for x in (k, v) + ((ks, vs) if kind != "bf16"
                                             else ())]
            n_b, t = shape[1], shape[3]
            bound, by = _bound(_nbytes(q, sel, *layer) + 4 * q.numel()
                               + 4 * n_b * sel.shape[1] * t,
                               4 * 64 * 20 * t * n_b, "f32")
            cluster, piece = da._plan_for(q, n_b * 20, t, k.dtype)
            rows.append(f"{kind} " + ", ".join(
                f"{key} err {e:.3g} (band {b:.3g})"
                for key, (e, b) in errs.items())
                + f"; {ms:.4f} ms a call ({device_ms:.4f} ms on the device), "
                f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"clusters of {cluster}, pieces of {piece} keys")
            if kind == "int8" and label == "microbench":
                entries.append({
                    "name": "decode_gemv_attention", "route": "cuda",
                    "source": "crisperwhisper_tpu_torch/csrc/"
                              "decode_attention.cu",
                    "replaces": "experiments/decode_gemv_v3.py:74",
                    "max_abs_err": errs["out"][0], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None})
            del q, k, ks, v, vs
        print(f"phase 2 decode_gemv_attention {label}: q bf16 [{shape[1]}, "
              f"20, 64], layer 1 of {list(shape)} caches, sel of 15 heads: "
              + "; ".join(rows) + "; no single library call", flush=True)

    # --- v3 at the plain decode step's shapes (large-v3, bulk batch 64,
    # the last layer of the stacked caches), as models/whisper.py calls it
    # through bind_decode_gemv: the bf16 cross cache with a one-slot sel
    # (a layer with one alignment head), the bf16 self ring of 100 slots at
    # position 60; a generator of their own keeps the probe's draw as it
    # was; the bound counts the keys the call attends to
    own = torch.Generator(device=dev).manual_seed(9)
    one_slot = torch.zeros((20, 1), device=dev)
    one_slot[3, 0] = 1.0
    for label, shape, kw in (
            ("main path cross", (32, 64, 20, 1500, 64),
             dict(sel=one_slot)),
            ("main path self", (32, 64, 20, 100, 64), dict(position=60))):
        li, n_b, t = shape[0] - 1, shape[1], shape[3]
        q = (torch.randn(shape[1:3] + (64,), generator=own, device=dev)
             / 8).to(torch.bfloat16)
        k, v = (torch.empty(shape, dtype=torch.bfloat16, device=dev)
                for _ in range(2))
        for x in (k, v):
            x[li] = torch.randn(shape[1:], generator=own, device=dev)
        errs = testing.decode_gemv_errors(q, k, v, li, **kw)
        for key, (err, band) in errs.items():
            _require(err <= band, f"decode_gemv_attention {label}: {key} "
                                  f"max err {err} > {band}")
        ms = _time_ms(lambda: da.decode_gemv_attention(q, k, v, li, **kw),
                      20)
        attend = da.bind_decode_gemv(torch.bfloat16, k, v)
        bound_ms = _time_ms(lambda: attend(q, li, **kw), 20)
        device_ms = _graph_ms(lambda: attend(q, li, **kw), 20)
        plain_ms = _time_ms(lambda: da.decode_gemv_plain(q, k, v, li, **kw),
                            5)
        live = min(kw.get("position", t - 1) + 1, t)
        n_align = kw["sel"].shape[1] if "sel" in kw else 0
        bound, by = _bound(2 * 2 * n_b * 20 * live * 64 + _nbytes(q)
                           + 4 * q.numel() + 4 * n_b * n_align * t,
                           4 * 64 * 20 * live * n_b, "f32")
        cluster, piece = da._plan_for(q, n_b * 20, t, k.dtype)
        print(f"phase 2 decode_gemv_attention {label}: q bf16 [{n_b}, 20, "
              f"64], layer {li} of {list(shape)} bf16 caches, "
              + ", ".join(f"{key} err {e:.3g} (band {b:.3g})"
                          for key, (e, b) in errs.items())
              + f"; {ms:.4f} ms a call ({bound_ms:.4f} ms bound once by "
              f"bind_decode_gemv, {device_ms:.4f} ms on the device), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, {live} keys "
              f"attended), clusters of {cluster}, pieces of {piece} keys",
              flush=True)
        del q, k, v, attend

    # --- the graphed one-token step's position on the device
    # (decoding/greedy.py), at the bulk shapes: large-v3, 16 and 64 rows,
    # the self ring of a 3-token prompt + 96 new tokens. Kernel 9 reads a
    # 0-d int32 position; the ring write (kernel 6) takes it copied to
    # every row. Each eager against its plain version, then captured once
    # in a CUDA graph and replayed with the position moved in place.
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    ring = 3 + 96
    at = torch.zeros((), dtype=torch.int32, device=dev)
    for n_b in (16, 64):
        shape = (arch.decoder_layers, n_b, 20, ring, 64)
        li = shape[0] - 1
        q = (torch.randn((n_b, 20, 64), generator=own, device=dev)
             / 8).to(torch.bfloat16)
        k, v = (torch.randn(shape, generator=own, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        positions = (-1, 0, 61, ring - 1)
        worst = {}
        for pos in positions:
            at.fill_(pos)
            for key, (err, band) in testing.decode_gemv_errors(
                    q, k, v, li, position=at).items():
                _require(err <= band, f"decode_gemv_attention at a device "
                         f"position {pos}, {n_b} rows: {key} max err {err} "
                         f"> {band}")
                worst[key] = max(worst.get(key, 0.0),
                                 err / band if band else 0.0)
        attend = da.bind_decode_gemv(torch.bfloat16, k, v)
        wants = [attend(q, li, pos) for pos in positions]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = attend(q, li, at)
        for pos, want in reversed(list(zip(positions, wants))):
            at.fill_(pos)
            graph.replay()
            torch.cuda.synchronize()
            _require(torch.equal(captured, want), f"decode_gemv_attention "
                     f"replayed at position {pos}, {n_b} rows: not the "
                     "integer form's bytes")
        device_ms = _graph_ms(lambda: attend(q, li, at), 20)
        del q, k, v, attend, graph, captured, wants

        pairs, _ = testing.ring_write_inputs(arch, n_b, 1, ring, "bf16", own)
        for pos in positions[1:]:
            at.fill_(pos)
            err = testing.ring_write_error(pairs, li,
                                           at.expand(n_b).contiguous())
            _require(err == 0, f"ring_write at a device position {pos}, "
                     f"{n_b} rows: {err} bytes differ")
        plan = rw.ring_plan([r for r, _ in pairs])

        def write():
            rw.write_block_columns_group(pairs, li,
                                         at.expand(n_b).contiguous(), plan)
        write()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            write()
        for pos in reversed(positions[1:]):
            want = [(r.clone(), blk) for r, blk in pairs]
            rw.write_block_columns_plain(
                want, li, torch.full((n_b,), pos, dtype=torch.int32))
            at.fill_(pos)
            graph.replay()
            torch.cuda.synchronize()
            err = sum(int((g.view(torch.uint8) != w.view(torch.uint8)).sum())
                      for (g, _), (w, _) in zip(pairs, want))
            _require(err == 0, f"ring_write replayed at position {pos}, "
                     f"{n_b} rows: {err} bytes differ")
        write_ms = _graph_ms(write, 20)
        del pairs, graph, want
        print(f"phase 2 graphed step's device position, {n_b} rows, self "
              f"ring [{', '.join(map(str, shape))}] bf16, layer {li}: "
              f"decode_gemv_attention at positions {list(positions)} "
              "within its bands (worst " + ", ".join(
                  f"{key} {r:.3g} of its band" for key, r in worst.items())
              + "), replayed from a CUDA graph with the position moved in "
              f"place: the integer form's bytes, {device_ms:.4f} ms on the "
              f"device; ring_write (one column a row) at {list(positions[1:])}"
              " bit-identical to its plain version, eager and replayed, "
              f"{write_ms:.4f} ms on the device", flush=True)

    # --- the probe: x * 2 on one (8, 128) f32 tile, exact
    x = torch.randn((8, 128), generator=gen, device=dev)
    err = int((probe.probe_add(x) != x * 2.0).sum())
    _require(err == 0, f"probe_add: {err} values differ from x * 2")
    ms = _time_ms(lambda: probe.probe_add(x), 200)
    device_ms = _graph_ms(lambda: probe.probe_add(x), 200)
    plain_ms = _time_ms(lambda: x * 2.0, 200)
    lib_ms = _time_ms(lambda: torch.mul(x, 2.0), 200)
    bound, by = _bound(2 * _nbytes(x), x.numel(), "f32")
    print(f"phase 2 probe_add: [8, 128] f32 exact; {ms:.4f} ms a call "
          f"({device_ms:.4f} ms on the device, from a CUDA graph) vs plain "
          f"{plain_ms:.4f} ms, torch.mul {lib_ms:.4f} ms, bound "
          f"{bound:.7f} ms ({by})", flush=True)
    entries.append({
        "name": "probe_add", "route": "cuda",
        "source": "crisperwhisper_tpu_torch/csrc/probe.cu",
        "replaces": "scripts/probe_pallas_compile.py:51",
        "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
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

    # speculative decoding: equal to greedy on the card and to the CPU
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    for seconds, quantize, assistant in ((12.0, False, "prompt_lookup"),
                                         (5.0, "serving", "self:1")):
        clip = testing.tone_audio(seconds, 0)
        cpu = testing.tiny_slice(ckpt, params, "cpu", clip, quantize,
                                 assistant)
        greedy = testing.tiny_slice(ckpt, params, "cuda", clip, quantize)
        before = (rw.write_block_columns_group.launches,
                  ds.whole_step.mode_launches["multi"])
        gpu = testing.tiny_slice(ckpt, params, "cuda", clip, quantize,
                                 assistant)
        launched = (rw.write_block_columns_group.launches - before[0],
                    ds.whole_step.mode_launches["multi"] - before[1])
        _require(launched[1 if quantize else 0] > 0,
                 f"tiny speculative {assistant}: its kernel did not launch")
        try:
            gap = max(testing.slice_timestamp_gap(cpu, gpu),
                      testing.slice_timestamp_gap(greedy, gpu))
        except AssertionError as e:
            raise SmokeError(f"tiny speculative {assistant}: {e}") from e
        _require(gap <= testing.TS_BAND,
                 f"tiny speculative {assistant}: timestamps differ by {gap}")
        print(f"phase 3 ok: tiny speculative slice ({assistant}, "
              f"{'serving' if quantize else 'f32'}, {seconds:.0f} s), CUDA "
              f"== CPU == greedy on CUDA, ring-write launches "
              f"{launched[0]}, decode-step multi launches {launched[1]}, "
              f"max timestamp diff {gap:.4f} s", flush=True)

    # beam search and the prompting paths
    clip = testing.tone_audio(12.0, 0)
    for label, kw in (("beam (num_beams=4)", dict(num_beams=4)),
                      ("prompting (prompt=, condition_on_prev_tokens)",
                       dict(prompt="hello world"))):
        cpu = testing.tiny_slice(ckpt, params, "cpu", clip, **kw)
        gpu = testing.tiny_slice(ckpt, params, "cuda", clip, **kw)
        try:
            gap = testing.slice_timestamp_gap(cpu, gpu)
        except AssertionError as e:
            raise SmokeError(f"tiny {label} slice, CUDA against CPU: {e}"
                             ) from e
        _require(gap <= testing.TS_BAND,
                 f"tiny {label} slice: timestamps differ by {gap}")
        print(f"phase 3 ok: tiny {label} slice, CUDA == CPU over "
              f"{len(cpu[1])} chunks ({sum(t.shape[1] for t in cpu[1])} "
              f"tokens), max timestamp diff {gap:.4f} s", flush=True)
    clip = testing.tone_audio(5.0, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", clip, "serving",
                             num_beams=4)
    before = ds.whole_step.mode_launches["beams"]
    gpu = testing.tiny_slice(ckpt, params, "cuda", clip, "serving",
                             num_beams=4)
    launched = ds.whole_step.mode_launches["beams"] - before
    _require(launched > 0, "tiny serving beams: no beams-mode launch")
    agree = testing.token_agreement(cpu[1], gpu[1])
    _require(agree >= 0.9, f"tiny serving beams: token agreement with the "
                           f"CPU {agree}")
    print(f"phase 3 ok: tiny serving beam slice (num_beams=4, 5 s, batch "
          f"1), {launched} decode-step beams launches, token agreement with "
          f"the CPU {agree:.3f}", flush=True)

    # serving: a batcher whose worker thread runs the device batches, and
    # a live session fed in ragged blocks, on the card and on the CPU
    clip = testing.tone_audio(12.0, 0)
    gpu = testing.serving_slice(ckpt, params, "cuda", clip)
    cpu = testing.serving_slice(ckpt, params, "cpu", clip)
    try:
        gap = testing.serving_gap(gpu)
        cpu_gap = max(testing.result_gap(c, g) for c, g in zip(
            [cpu["pipe"], cpu["live"], *cpu["streams"]],
            [gpu["pipe"], gpu["live"], *gpu["streams"]]))
    except AssertionError as e:
        raise SmokeError(f"tiny serving slice: {e}") from e
    _require(gpu["batcher_launches"] > 0,
             "tiny serving slice: the batcher's worker launched no kernel")
    _require(max(gap, cpu_gap) <= testing.TS_BAND,
             f"tiny serving slice: timestamps differ by {gap} (card "
             f"pipeline) and {cpu_gap} (CPU)")
    print(f"phase 3 ok: tiny serving slice (StreamingBatcher, "
          f"{len(gpu['streams'])} streams, batch 4, "
          f"{gpu['batcher_launches']} encoder-attention launches from its "
          f"worker thread, {sum(map(len, gpu['stream_partials']))} "
          f"partials; LiveSession in ragged blocks, "
          f"{len(gpu['live_partials'])} partials): streams == the card's "
          f"pipe(), finish() == pipe(whole, adjust_pauses_threshold=0.12), "
          f"max timestamp diff {gap:.4f} s, against the CPU "
          f"{cpu_gap:.4f} s", flush=True)


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


def _replayed_step_ms(params, arch) -> dict[int, float]:
    """Device milliseconds of the plain one-token step (all decoder
    layers, the final LayerNorm, the tied LM head, the alignment heads'
    rows) captured once as a CUDA graph at a position held on the device,
    as the greedy loop replays it: CUDA events around 20 back-to-back
    replays, at 16 and 64 rows, a random encoder output of 1500 frames
    and a ring of 99 at position 60."""
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.models.whisper import (alignment_selector,
                                                         decode_step,
                                                         init_cache)
    own = torch.Generator(device="cuda").manual_seed(13)
    sel = alignment_selector(arch, testing.large_v3_align_heads(arch))
    at = torch.full((), 60, dtype=torch.int32, device="cuda")
    out = {}
    for rows in (16, 64):
        enc = torch.randn((rows, arch.max_source_positions, arch.d_model),
                          generator=own, device="cuda").to(torch.bfloat16)
        cache = init_cache(params, arch, enc, cache_len=99)
        toks = torch.randint(0, arch.vocab_size, (rows,), generator=own,
                             device="cuda")

        def step():
            decode_step(params, arch, toks, at, cache, align_sel=sel)
        step()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        out[rows] = start.elapsed_time(stop) / 20
        del enc, cache, graph
    torch.cuda.empty_cache()
    return out


def phase4_large(tmp: str, large) -> tuple[dict[str, int], list]:
    import numpy as np
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models.whisper import (decode_step, encode,
                                                         init_cache)
    from crisperwhisper_tpu_torch.utils import tracing

    arch, params = large
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en")
    # random weights rarely close a segment: one seek pass per window and
    # 96 new tokens bound the time; the temperature ladder stays default
    pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=96,
                            force_unique_generate_call=True)
    requests = _large_requests(tmp)

    # the alignment tail (align prep + DTW) of each decode pass, between
    # CUDA events on the stream
    from crisperwhisper_tpu_torch.decoding import longform
    real_tail = longform.attention_to_jump_times
    marks = []

    def timed_tail(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return real_tail(*args, **kwargs)
        finally:
            stop.record()
            marks.append((start, stop))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    results, walls, tails, cpu = [], [], [], []
    longform.attention_to_jump_times = timed_tail
    # the device trace counts the kernels of the step's CUDA graph at every
    # replay; the program's records say which steps were replays
    cuda = torch.profiler.ProfilerActivity.CUDA
    try:
        with torch.profiler.profile(activities=[cuda]) as prof, \
                tracing.recording() as recs:
            for req, _ in requests:
                marks.clear()
                t0, c0 = time.perf_counter(), time.process_time()
                results.append(pipe(req, return_timestamps="word",
                                    adjust_pauses_threshold=0.12))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                cpu.append(time.process_time() - c0)
                tails.append((sum(a.elapsed_time(b) for a, b in marks)
                              / 1e3, len(marks)))
    finally:
        longform.attention_to_jump_times = real_tail
    counts = _counts()
    ran = testing.device_kernel_counts(prof, testing.STEP_KERNELS)
    launches = {**{k: counts[k] for k in ("encoder_attention", "align_prep",
                                          "dtw")}, **ran}
    peak = torch.cuda.max_memory_allocated()
    steps = [r.counts["graph"] for r in recs if r.name == "cw.decode.step"]
    capture_ms = [(r.end_ns - r.start_ns) / 1e6 for r in recs
                  if r.name == "cw.decode.capture"]
    captures = len(capture_ms)
    decodes = sum(r.name == "cw.decode.cache" for r in recs)

    _check_results(requests, results)
    for name, n in launches.items():
        _require(n > 0, f"kernel {name} was not launched on the main path")
    # every decode captures its step once after one eager step and replays
    # it; each step, eager or replayed, runs kernel 9 for both attention
    # halves of every layer and the ring write once a layer
    n_layers = arch.decoder_layers
    _require(decodes > 0 and captures == decodes
             and len(steps) - sum(steps) == captures,
             f"step graph: {captures} captures, {decodes} decodes, "
             f"{len(steps) - sum(steps)} of {len(steps)} steps eager")
    _require(ran == {"decode_gemv_attention": 2 * n_layers * len(steps),
                     "ring_write": n_layers * len(steps)},
             f"device kernels {ran} over {len(steps)} steps of "
             f"{n_layers} layers")
    _require(counts["encoder_attention_tensor_cores"]
             == launches["encoder_attention"]
             and counts["encoder_attention_cuda_cores"] == 0,
             "encoder attention left the tensor-core route: "
             f"{counts['encoder_attention_tensor_cores']} of "
             f"{launches['encoder_attention']} launches on it")

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
    del cache, logits
    step_ms = _replayed_step_ms(pipe.params, arch)

    print(f"phase 4 ok: large-v3 bf16 random weights; requests 60 s file "
          f"{walls[0]:.2f} s wall ({len(results[0]['chunks'])} words), "
          f"12 s array {walls[1]:.2f} s wall "
          f"({len(results[1]['chunks'])} words), the process's CPU "
          f"seconds in them {cpu[0]:.2f} and {cpu[1]:.2f} (under the "
          f"profiler); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches} (kernel 9 and the "
          f"ring write counted on the device), {len(steps)} steps in "
          f"{decodes} decodes, {sum(steps)} of them replays of "
          f"{captures} captured graphs (capture {min(capture_ms):.2f}-"
          f"{max(capture_ms):.2f} ms of host a decode, cw.decode.capture "
          "records under the profiler); the plain step replayed from a "
          "CUDA graph at a ring of 99, " + ", ".join(
              f"{rows} rows {ms:.4f} ms on the device" for rows, ms in
              step_ms.items()) + "; encoder "
          f"attention all {counts['encoder_attention_tensor_cores']} on "
          "the tensor-core route; alignment tail (CUDA events around "
          "attention_to_jump_times) " + ", ".join(
              f"{label} {sec:.4f} s over {calls} calls ({100 * sec / wall:.3f}"
              "% of the wall)" for label, (sec, calls), wall in zip(
                  ("60 s file", "12 s array"), tails, walls)), flush=True)
    return launches, results


def _wrappers() -> dict:
    """Every kernel wrapper by the kernel's name in the JSON line."""
    from crisperwhisper_tpu_torch import probe
    from crisperwhisper_tpu_torch.audio import fused_mel as fm
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    from crisperwhisper_tpu_torch.ops import decode_step as ds
    from crisperwhisper_tpu_torch.ops import dtw as dt
    from crisperwhisper_tpu_torch.ops import fused_attention as fa
    from crisperwhisper_tpu_torch.ops import moe
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    return {"encoder_attention": fa.fused_attention,
            "align_prep": ap.align_prep, "dtw": dt.dtw,
            "decode_step": ds.whole_step,
            "ring_write": rw.write_block_columns_group,
            "log_mel": fm.fused_log_mel,
            "cross_attention_int8": da.cross_attention_int8,
            "cross_attention_int8_v2": da.cross_attention_int8_v2,
            "decode_gemv_attention": da.decode_gemv_attention,
            "grouped_swiglu": moe.grouped_swiglu,
            "probe_add": probe.probe_add}


def _reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from crisperwhisper_tpu_torch.ops import decode_step as ds
    from crisperwhisper_tpu_torch.ops import fused_attention as fa
    for wrapper in _wrappers().values():
        wrapper.launches = 0
    ds.whole_step.mode_launches = dict.fromkeys(ds.MODES, 0)
    fa.fused_attention.route_launches = dict.fromkeys(fa.ROUTES, 0)


def _counts() -> dict[str, int]:
    """Launches by kernel, the decode step also by mode and the encoder
    attention by route."""
    from crisperwhisper_tpu_torch.ops import decode_step as ds
    from crisperwhisper_tpu_torch.ops import fused_attention as fa
    return {**{name: w.launches for name, w in _wrappers().items()},
            **{f"decode_step_{m}": n
               for m, n in ds.whole_step.mode_launches.items()},
            **{f"encoder_attention_{r}": n
               for r, n in fa.fused_attention.route_launches.items()}}


def phase5_serving(tmp: str, large) -> int:
    """Quantized serving with the whole-step decode kernel. Returns the
    decode-step kernel's launches over both requests."""
    import torch
    from crisperwhisper_tpu_torch.hub import load_pipeline

    arch, params = large
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en", quantize="serving")
    pipe.gen_opts = replace(pipe.gen_opts, b1_decode_kernel=True,
                            temperatures=(0.0,), max_new_tokens=96,
                            force_unique_generate_call=True)
    wav, arr = _large_requests(tmp)
    total, lines = 0, []
    for (req, dur), mode in ((arr, "b1"), (wav, "rows")):
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = pipe(req, return_timestamps="word",
                   adjust_pauses_threshold=0.12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        _check_results([(req, dur)], [res])
        for name in ("encoder_attention", "align_prep", "dtw", "decode_step"):
            _require(launches[name] > 0, f"serving {dur:.0f} s request: "
                                         f"kernel {name} was not launched")
        _require(launches["decode_step"] == launches[f"decode_step_{mode}"],
                 f"serving {dur:.0f} s request: steps by mode {launches}, "
                 f"expected {mode} only")
        total += launches["decode_step"]
        lines.append(f"{dur:.0f} s decode_step_{mode}: {wall:.2f} s wall "
                     f"({len(res['chunks'])} words), peak device memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
                     f"GiB, launches {launches}")
    print("phase 5 ok: large-v3 quantize='serving', b1_decode_kernel; "
          + "; ".join(lines), flush=True)
    return total


def phase6_speculative(tmp: str, large) -> dict[str, int]:
    """Speculative decoding at large-v3 geometry, three requests, each
    after a greedy run of the same request. Returns the launches of the
    speculative runs: ring_write of (a), decode_step of (b) and (c)."""
    from crisperwhisper_tpu_torch import _build, testing
    from crisperwhisper_tpu_torch.decoding import assisted
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models import whisper

    arch, params = large
    wav, arr = _large_requests(tmp)
    real_write, real_launcher = (whisper.write_block_columns_group,
                                 _build.launcher)
    inside = [0.0, 0.0]          # host seconds in the ring-write wrapper,
                                 # and in its launch (ctypes + cuLaunchKernel)

    def timed(fn, i):            # a host clock, no sync
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                inside[i] += time.perf_counter() - t0
        return call

    def timed_launcher(entry):
        launch = real_launcher(entry)
        return timed(launch, 1) if entry == "cw_ring_write" else launch
    cases = (("a", False, "prompt_lookup", wav, ("ring_write",)),
             ("b", "serving", "prompt_lookup", arr, ("decode_step_multi",)),
             ("c", "serving", "self:4", arr,
              ("decode_step_multi", "decode_step_b1")))
    real = assisted.assisted_decode
    totals = {"ring_write": 0, "decode_step": 0}
    lines = []
    whisper.write_block_columns_group = timed(real_write, 0)
    _build.launcher = timed_launcher
    try:
        for label, quantize, assistant, (req, dur), needs in cases:
            pipe = load_pipeline(_large_ckpt(tmp, arch), params=params,
                                 device="cuda", language="en",
                                 quantize=quantize, assistant=assistant)
            pipe.gen_opts = replace(pipe.gen_opts, temperatures=(0.0,),
                                    max_new_tokens=96,
                                    force_unique_generate_call=True,
                                    b1_decode_kernel=bool(quantize))
            spec = pipe.assistant
            runs = {}
            for name in ("greedy", "assisted"):
                pipe.assistant = spec if name == "assisted" else None
                counts: dict = {}
                assisted.assisted_decode = (
                    lambda *a, _c=counts, **kw: real(*a, counts=_c, **kw))
                inside[:] = [0.0, 0.0]
                wall, toks, launches, res = _request(pipe, req)
                runs[name] = (wall, toks, launches, counts, res)
            wall, toks, launches, counts, res = runs["assisted"]
            _check_results([(req, dur)], [res])
            for name in ("encoder_attention", "align_prep", "dtw", *needs):
                _require(launches[name] > 0,
                         f"speculative ({label}) {assistant}: kernel "
                         f"{name} was not launched")
            agree = testing.token_agreement(runs["greedy"][1], toks)
            _require(agree >= 0.9, f"speculative ({label}) {assistant}: "
                                   f"token agreement with greedy {agree}")
            rate = counts.get("accepted", 0) / max(counts.get("drafts", 0), 1)
            totals["ring_write"] += launches["ring_write"] \
                if label == "a" else 0
            totals["decode_step"] += launches["decode_step"]
            n_writes = launches["ring_write"]
            per_call = 1e3 / max(n_writes, 1)
            wrapper = (f", ring-write wrapper {inside[0]:.4f} s on the host "
                       f"over {n_writes} launches "
                       f"({per_call * inside[0]:.4f} ms a call, of which "
                       f"{per_call * inside[1]:.4f} ms in its launch; "
                       f"{100 * inside[0] / wall:.2f}% of the wall)"
                       if label == "a" else "")
            lines.append(
                f"({label}) {'serving' if quantize else 'bf16'} {assistant} "
                f"{dur:.0f} s: {wall:.2f} s wall (greedy "
                f"{runs['greedy'][0]:.2f} s), {counts.get('blocks', 0)} "
                f"verify blocks, acceptance {rate:.3f}, agreement with "
                f"greedy {agree:.3f}{wrapper}, launches {launches}")
    finally:
        assisted.assisted_decode = real
        whisper.write_block_columns_group = real_write
        _build.launcher = real_launcher
    print("phase 6 ok: large-v3 speculative decoding; " + "; ".join(lines),
          flush=True)
    return totals


def _request(pipe, req, prompt=None):
    """One timed request with every launch count reset just before: (wall
    seconds, each chunk's tokens, launches by kernel, the result)."""
    import torch
    toks = []
    inner = pipe._run_chunks

    def spy(*a, **kw):
        out = inner(*a, **kw)
        toks.extend(o["tokens"] for o in out)
        return out
    pipe._run_chunks = spy
    try:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe(req, return_timestamps="word",
                   adjust_pauses_threshold=0.12, prompt=prompt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, toks, _counts(), res
    finally:
        del pipe._run_chunks


def phase7_beams_prompts(tmp: str, large) -> int:
    """Beam search and a text prompt at large-v3 geometry, each request
    after a greedy run of itself. Returns the decode-step kernel's
    launches in (b)'s timed request (the beams mode)."""
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.hub import load_pipeline

    arch, params = large
    wav, arr = _large_requests(tmp)
    prompt = "hello world, transcribe every um and uh"
    cases = (("a", False, 5, wav, None, ()),
             ("b", "serving", 5, arr, None, ("decode_step_beams",)),
             ("c", False, 1, arr, prompt, ()))
    total = 0
    for label, quantize, beams, (req, dur), text, needs in cases:
        pipe = load_pipeline(_large_ckpt(tmp, arch), params=params,
                             device="cuda", language="en", quantize=quantize)
        base = replace(pipe.gen_opts, temperatures=(0.0,), max_new_tokens=96,
                       force_unique_generate_call=True,
                       b1_decode_kernel=bool(quantize))
        pipe.gen_opts = base
        greedy_wall, greedy_toks, _, _ = _request(pipe, req)
        pipe.gen_opts = replace(base, num_beams=beams)
        wall, toks, launches, res = _request(pipe, req, text)
        _check_results([(req, dur)], [res])
        for name in ("encoder_attention", "align_prep", "dtw", *needs):
            _require(launches[name] > 0, f"beams/prompt ({label}): kernel "
                                         f"{name} was not launched")
        extra = ""
        if quantize:
            _require(launches["decode_step"] == launches["decode_step_beams"],
                     f"beams ({label}): steps by mode {launches}, expected "
                     "beams only")
            # the same requests on the plain step (bf16 activations, where
            # the kernel keeps an f32 residual stream): for the record
            pipe.gen_opts = replace(base, num_beams=beams,
                                    b1_decode_kernel=False)
            plain_wall, plain_toks, _, _ = _request(pipe, req)
            pipe.gen_opts = replace(base, b1_decode_kernel=False)
            greedy_plain = _request(pipe, req)[1]
            # the band: f32 activations on both sides, the kernel's own
            # arithmetic, as the reference holds it (test_b1_kernel.py:336)
            p32 = load_pipeline(_large_ckpt(tmp, arch),
                                params=testing.to_device(params,
                                                         torch.float32),
                                device="cuda", language="en",
                                quantize=quantize)
            p32.gen_opts = replace(base, num_beams=beams)
            _, k32, l32, _ = _request(p32, req)
            _require(l32["decode_step_beams"] > 0,
                     f"beams ({label}) f32: no beams-mode launch")
            p32.gen_opts = replace(base, num_beams=beams,
                                   b1_decode_kernel=False)
            n32 = _request(p32, req)[1]
            del p32
            torch.cuda.empty_cache()
            agree = testing.token_agreement(n32, k32)
            _require(agree >= 0.9, f"beams ({label}): token agreement with "
                                   f"the plain step at f32 {agree}")
            bf16 = testing.token_agreement(plain_toks, toks)
            bf16_greedy = testing.token_agreement(greedy_plain, greedy_toks)
            extra = (f", without b1_decode_kernel {plain_wall:.2f} s; token "
                     f"agreement with the plain step {agree:.3f} at f32 "
                     f"activations, at bf16 {bf16:.3f} (greedy at bf16 "
                     f"{bf16_greedy:.3f})")
        total += launches["decode_step"]
        what = (f"num_beams={beams}" if beams > 1 else f"prompt={text!r}")
        kind = "serving" if quantize else "bf16"
        print(f"phase 7 ({label}): large-v3 {kind} {what} {dur:.0f} s: "
              f"{wall:.2f} s wall (greedy "
              f"{greedy_wall:.2f} s{extra}), {len(res['chunks'])} words, "
              f"launches {launches}", flush=True)
    print("phase 7 ok: large-v3 beams and prompts", flush=True)
    return total


def _pipeline_windows(pipe, wav: str):
    """The first device batch that ``pipe`` cuts from ``wav``, as
    ASRPipeline._run_chunks forms it: chunk_iter's 30 s windows at the
    pipeline's strides, zero padded, in a batch rounded up to a power of
    2."""
    import numpy as np
    import torch
    from crisperwhisper_tpu_torch.audio.io import load_audio
    from crisperwhisper_tpu_torch.pipeline.asr import chunk_iter
    sr = pipe.feat_cfg.sampling_rate
    n_samples = int(round(pipe.pipe_opts.chunk_length_s * sr))
    left, right = (int(round(x * sr)) for x in pipe.pipe_opts.strides())
    chunks = list(chunk_iter(load_audio(wav, sr), 0, n_samples, left,
                             right))[:pipe.pipe_opts.batch_size]
    batch = np.zeros((min(1 << max(len(chunks) - 1, 0).bit_length(),
                          pipe.pipe_opts.batch_size), n_samples), np.float32)
    for i, c in enumerate(chunks):
        batch[i, :len(c.samples)] = c.samples
    return torch.from_numpy(batch).cuda(), len(chunks)


def phase8_remaining(tmp: str, large) -> dict[str, int]:
    """The remaining entry points at large-v3 width, on the data of the
    main path, each part with every launch count reset just before and
    read just after. Returns the launches of each new kernel."""
    import torch
    from crisperwhisper_tpu_torch import probe, testing
    from crisperwhisper_tpu_torch.audio import fused_mel as fm
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models.whisper import (alignment_selector,
                                                         encode, init_cache)

    arch, params = large
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en")
    (wav, _), _ = _large_requests(tmp)
    launches = {}

    def part(name: str, kernels: tuple[str, ...], fn):
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _counts()
        for k in kernels:
            _require(counts[k] > 0, f"phase 8 ({name}): kernel {k} was not "
                                    "launched")
            launches[k] = counts[k]
        return out

    # (a) the fused log-mel on the windows ASRPipeline cuts from the WAV
    batch, n_windows = _pipeline_windows(pipe, wav)
    cfg = pipe.feat_cfg
    feats = part("a", ("log_mel",), lambda: fm.fused_log_mel(batch, cfg))
    stft = extract_features(batch, cfg)
    err_stft = (feats - stft).abs().max().item()
    err_plain = (feats - fm.log_mel_plain(batch, cfg)).abs().max().item()
    _require(max(err_stft, err_plain) <= testing.MEL_BAND,
             f"phase 8 (a): log-mel err {err_stft} (stft), {err_plain} "
             f"(plain) > {testing.MEL_BAND}")
    enc = encode(params, arch, feats)
    enc_gap = (enc.float() - encode(params, arch, stft).float()).abs().max()
    print(f"phase 8 (a): fused_log_mel on the {n_windows} windows "
          f"ASRPipeline cuts from the 60 s WAV (batch "
          f"{list(batch.shape)}, {cfg.feature_size} mels): err against "
          f"extract_features {err_stft:.3g}, against the plain twin "
          f"{err_plain:.3g} (band {testing.MEL_BAND}); large-v3 encoder "
          f"states from the two feature batches differ by up to "
          f"{enc_gap.item():.4g} (bf16, informative); launches "
          f"{launches['log_mel']}", flush=True)

    # (b) v1 and v2 on every layer of the int8 cross cache of that output
    cache = init_cache(params, arch, enc, cross_dtype="int8", cache_len=1)
    b, h = enc.shape[0], arch.decoder_attention_heads

    def cross_layers():
        worst = {}
        for li in range(arch.decoder_layers):
            q = (torch.randn((b, h, 1, arch.head_dim), generator=gen,
                             device="cuda") / 8).to(torch.bfloat16)
            args = (q, cache.cross_k[li], cache.cross_k_scale[li][..., None],
                    cache.cross_v[li], cache.cross_v_scale[li][..., None])
            for v2 in (False, True):
                errs = testing.cross_attention_errors(*args, v2=v2)
                for key, (err, band) in errs.items():
                    _require(err <= band, f"phase 8 (b) layer {li} v2={v2}: "
                                          f"{key} max err {err} > {band}")
                    tag = f"{'v2' if v2 else 'v1'} {key}"
                    worst[tag] = max(worst.get(tag, 0.0), err / band)
        return worst
    worst = part("b", ("cross_attention_int8", "cross_attention_int8_v2"),
                 cross_layers)
    print(f"phase 8 (b): cross_attention_int8 / _v2 on all "
          f"{arch.decoder_layers} layers of the int8 cross cache "
          f"{list(cache.cross_k.shape)} of that encoder output, bf16 q: "
          f"worst err / band " + ", ".join(f"{k} {r:.3g}"
                                           for k, r in worst.items())
          + f"; launches {launches['cross_attention_int8']} + "
          f"{launches['cross_attention_int8_v2']}", flush=True)

    # (c) v3 on the stacked int8 and int4 cross caches (alignment heads of
    # each layer) and on an int8 self ring of 448 slots at position 60
    sel = torch.from_numpy(alignment_selector(
        arch, testing.large_v3_align_heads(arch))).cuda()
    caches = {"int8": cache, "int4": init_cache(params, arch, enc,
                                                cross_dtype="int4",
                                                cache_len=1)}
    ring = testing.random_step_cache(arch, b, "int8", 448, 61, gen, k_enc=1)
    pads = torch.arange(448, device="cuda")[None] \
        < 3 * torch.arange(b, device="cuda")[:, None]     # row r: 3r pads

    def gemv_layers():
        worst = {}
        for li in range(arch.decoder_layers):
            q = (torch.randn((b, h, arch.head_dim), generator=gen,
                             device="cuda") / 8).to(torch.bfloat16)
            runs = [(kind, (q, c.cross_k, c.cross_v, li),
                     dict(k_scale=c.cross_k_scale, v_scale=c.cross_v_scale,
                          sel=sel[li])) for kind, c in caches.items()]
            runs.append(("self ring", (q, ring.self_k, ring.self_v, li),
                         dict(k_scale=ring.self_k_scale,
                              v_scale=ring.self_v_scale, position=60,
                              key_mask=~pads)))
            for kind, args, kw in runs:
                for key, (err, band) in testing.decode_gemv_errors(
                        *args, **kw).items():
                    _require(err <= band, f"phase 8 (c) {kind} layer {li}: "
                                          f"{key} max err {err} > {band}")
                    tag = f"{kind} {key}"
                    worst[tag] = max(worst.get(tag, 0.0), err / band)
        return worst
    worst = part("c", ("decode_gemv_attention",), gemv_layers)
    print(f"phase 8 (c): decode_gemv_attention on all "
          f"{arch.decoder_layers} layers of the stacked int8 and int4 cross "
          f"caches (sel of each layer's alignment heads) and of an int8 "
          f"self ring of 448 slots at position 60 with left pads: worst "
          f"err / band " + ", ".join(f"{k} {r:.3g}" for k, r in worst.items())
          + f"; launches {launches['decode_gemv_attention']}", flush=True)
    del cache, caches, ring

    # (d) the probe ladder's card rungs, in this process (for the launch
    # count) and as the module's command line
    rc = part("d", ("probe_add",), lambda: probe.main(["plain,probe_add"]))
    _require(rc == 0, f"phase 8 (d): probe ladder exit code {rc}")
    cli = subprocess.run(
        [sys.executable, "-m", "crisperwhisper_tpu_torch.probe",
         "plain,probe_add"], capture_output=True, text=True, cwd=HERE,
        env={**os.environ, "PYTHONPATH": HERE}, timeout=300)
    _require(cli.returncode == 0 and "PROBE plain: OK" in cli.stdout
             and "PROBE probe_add: OK" in cli.stdout,
             f"phase 8 (d): python -m crisperwhisper_tpu_torch.probe exited "
             f"{cli.returncode}: {cli.stdout}{cli.stderr}")
    print("phase 8 (d): python -m crisperwhisper_tpu_torch.probe "
          "plain,probe_add: " + " | ".join(
              ln for ln in cli.stdout.splitlines() if ln.startswith("PROBE"))
          + f"; launches {launches['probe_add']} (in process)", flush=True)
    print(f"phase 8 ok: the remaining entry points at large-v3 width in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _spy_tokens(pipe) -> dict:
    """Replace ``pipe._run_chunks`` by a spy (undo: ``del pipe._run_chunks``)
    and return the dict it fills: for each audio array that windows are
    views of, in the order first seen, every window's tokens in order."""
    inner = pipe._run_chunks
    by_audio: dict = {}

    def spy(chunks, *a, **kw):
        out = inner(chunks, *a, **kw)
        for c, o in zip(chunks, out):
            base = c.samples if c.samples.base is None else c.samples.base
            by_audio.setdefault(id(base), []).append(o["tokens"])
        return out
    pipe._run_chunks = spy
    return by_audio


def _serve(pipe, batcher, streams) -> dict:
    """Submit ``streams`` [(request, seconds)] to ``batcher`` together,
    every launch count reset just before and read once every stream has
    its result: the results, each stream's seconds from its submit() to
    its result, the first partial's seconds after the first submit(),
    the wall from the first submit() to the last result, the partials,
    each stream's window tokens and the launches by kernel. A failure in
    the worker thread raises here, through result()."""
    partials = [[] for _ in streams]
    first: list[float] = []
    tokens = _spy_tokens(pipe)
    try:
        _reset_counts()
        t0 = time.perf_counter()

        def on_partial(i):
            def call(p):
                if not first:
                    first.append(time.perf_counter() - t0)
                partials[i].append(p)
            return call
        handles, submitted = [], []
        for i, (req, _) in enumerate(streams):
            submitted.append(time.perf_counter())
            handles.append(batcher.submit(req, on_partial=on_partial(i)))
        done = [None] * len(handles)
        while None in done:
            _require(time.perf_counter() - t0 < 600,
                     "serving: no result within 600 s")
            for i, h in enumerate(handles):
                if done[i] is None and h.done():
                    done[i] = time.perf_counter()
            time.sleep(0.001)
        results = [h.result(timeout=0) for h in handles]
        launches = _counts()
    finally:
        del pipe._run_chunks
    return {"results": results, "partials": partials,
            "latency": [d - s for d, s in zip(done, submitted)],
            "first_partial": first[0] if first else None,
            "wall": max(done) - t0, "tokens": list(tokens.values()),
            "launches": launches}


def _nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def _pipe_tokens(pipe, req) -> list:
    """Each window's tokens of ``pipe(req)``."""
    tokens = _spy_tokens(pipe)
    try:
        pipe(req, return_timestamps="word")
    finally:
        del pipe._run_chunks
    (toks,) = tokens.values()
    return toks


def _serving_line(label: str, streams, run: dict, refs: list) -> str:
    """Checks of one ``_serve`` run (results well formed, partials in order
    and prefix-stable, kernels 1-3 launched) and its line: latencies,
    first partial, audio-s / wall-s, token agreement with pipe() of the
    same audio (printed, not gated: bf16), launches."""
    from crisperwhisper_tpu_torch import testing
    _check_results(streams, run["results"])
    for partials, res in zip(run["partials"], run["results"]):
        try:
            testing.prefix_stable(partials, res)
        except AssertionError as e:
            raise SmokeError(f"phase 9 ({label}): {e}") from e
    for name in ("encoder_attention", "align_prep", "dtw"):
        _require(run["launches"][name] > 0,
                 f"phase 9 ({label}): kernel {name} was not launched")
    audio_s = sum(dur for _, dur in streams)
    agree = [testing.token_agreement(ref, got)
             for ref, got in zip(refs, run["tokens"])]
    first = run["first_partial"]
    return (f"streams {[f'{d:.0f} s' for _, d in streams]}: latency "
            f"submit->result " + ", ".join(f"{x:.3f}" for x in run["latency"])
            + " s; first partial " + (f"{first:.3f} s" if first is not None
                                      else "none (each stream in one batch)")
            + f" ({sum(map(len, run['partials']))} partials); "
            f"{audio_s:.0f} audio s in {run['wall']:.3f} s wall = "
            f"{audio_s / run['wall']:.1f} audio-s/wall-s; token agreement "
            f"with pipe() " + ", ".join(f"{a:.3f}" for a in agree)
            + f"; launches {_nonzero(run['launches'])}")


def phase9_serving(tmp: str, large, card: str) -> dict[str, int]:
    """Serving at large-v3 width (random bf16 weights, batch_size 8, one
    temperature, 96 new tokens, one seek pass a window): the 60 s WAV
    twice and the 12 s array submitted together with on_partial to (a)
    StreamingBatcher(pipe, warmup=True) on the default path, (b) a
    batcher over load_pipeline(quantize="serving") with b1_decode_kernel
    (the rows mode), then LiveSession on the 60 s WAV fed in 0.5 s blocks
    (the b1 mode). Returns the launches of the three runs by kernel."""
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.audio.io import load_audio
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.serving import LiveSession, StreamingBatcher

    t_phase = time.perf_counter()
    arch, params = large
    wav, arr = _large_requests(tmp)
    streams = [wav, wav, arr]
    totals: dict[str, int] = {}

    def add(launches):
        for name in ("encoder_attention", "align_prep", "dtw",
                     "decode_step"):
            totals[name] = totals.get(name, 0) + launches[name]

    def make(quantize):
        pipe = load_pipeline(_large_ckpt(tmp, arch), params=params,
                             device="cuda", language="en", quantize=quantize,
                             pipe_opts=PipelineOptions(
                                 batch_size=8, return_timestamps="word"))
        pipe.gen_opts = replace(pipe.gen_opts, temperatures=(0.0,),
                                max_new_tokens=96,
                                force_unique_generate_call=True,
                                b1_decode_kernel=bool(quantize))
        return pipe

    # (a) the default path, warmed before traffic
    pipe = make(False)
    sizes: list[int] = []
    real_warmup = pipe.warmup
    pipe.warmup = lambda *a, **kw: sizes.extend(real_warmup(*a, **kw))
    t0 = time.perf_counter()
    batcher = StreamingBatcher(pipe, warmup=True)
    warm_s = time.perf_counter() - t0
    del pipe.warmup
    _require(sizes == [1, 2, 4, 8], f"phase 9 (a): warmed sizes {sizes}")
    try:
        run = _serve(pipe, batcher, streams)
    finally:
        batcher.shutdown()
    add(run["launches"])
    refs = [_pipe_tokens(pipe, req) for req, _ in streams]
    print(f"phase 9 (a): default path bf16, StreamingBatcher(warmup=True) "
          f"warmed batch sizes {sizes} in {warm_s:.2f} s; "
          + _serving_line("a", streams, run, refs), flush=True)
    del pipe, batcher

    # (b) quantized serving: the rows mode through a batcher ...
    pipe = make("serving")
    batcher = StreamingBatcher(pipe)
    try:
        run = _serve(pipe, batcher, streams)
    finally:
        batcher.shutdown()
    add(run["launches"])
    _require(run["launches"]["decode_step_rows"] > 0,
             f"phase 9 (b): no rows-mode launch: {run['launches']}")
    refs = [_pipe_tokens(pipe, req) for req, _ in streams]
    print("phase 9 (b) rows: quantize='serving', b1_decode_kernel, "
          "StreamingBatcher; " + _serving_line("b rows", streams, run, refs),
          flush=True)

    # ... and the b1 mode through a live session fed in 0.5 s blocks
    audio = load_audio(wav[0], testing.SR)
    windows: list[float] = []
    live_toks: list = []
    inner = pipe._run_chunks

    def timed(*a, **kw):
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - t)
        live_toks.extend(o["tokens"] for o in out)
        return out
    partials: list[dict] = []
    first = None
    pipe._run_chunks = timed
    try:
        _reset_counts()
        sess = LiveSession(pipe, on_partial=partials.append)
        t0 = time.perf_counter()
        for i in range(0, len(audio), testing.SR // 2):
            t = time.perf_counter()
            if sess.feed(audio[i:i + testing.SR // 2]) is not None \
                    and first is None:
                first = time.perf_counter() - t
        final = sess.finish()
        live_wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        del pipe._run_chunks
    add(launches)
    _check_results([wav], [final])
    try:
        testing.prefix_stable(partials, final)
    except AssertionError as e:
        raise SmokeError(f"phase 9 (b) live: {e}") from e
    _require(partials and first is not None, "phase 9 (b) live: no partial")
    for name in ("encoder_attention", "align_prep", "dtw",
                 "decode_step_b1"):
        _require(launches[name] > 0,
                 f"phase 9 (b) live: kernel {name} was not launched")
    print(f"phase 9 (b) live: LiveSession on the 60 s WAV in 0.5 s blocks, "
          f"{len(windows)} windows at batch 1: "
          + ", ".join(f"{w:.3f}" for w in windows) + " s each (mean "
          f"{sum(windows) / len(windows):.3f} s); first partial "
          f"{first:.3f} s after the block that completed its window; "
          f"{len(partials)} partials; {60.0 / live_wall:.1f} audio-s/wall-s "
          f"fed as fast as it decodes; token agreement with pipe() "
          f"{testing.token_agreement(refs[0], live_toks):.3f}; launches "
          f"{_nonzero(launches)}", flush=True)
    print(f"phase 9 ok: serving at large-v3 width in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return totals


def phase10_entry_points(tmp: str, large, card: str) -> dict[str, int]:
    """The full-sequence, auxiliary, short-form, checkpoint and progress
    entry points at large-v3 width (random bf16 weights) on the 4 windows
    ASRPipeline cuts from the 60 s WAV, every count reset just before each
    part and read just after. Returns the launches of kernels 1-3."""
    import shutil

    import numpy as np
    import torch
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.audio.io import load_audio
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    from crisperwhisper_tpu_torch.decoding import longform
    from crisperwhisper_tpu_torch.decoding.generate import (
        build_prompt, generate_short_form)
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models import quantize as Q
    from crisperwhisper_tpu_torch.models.loader import (load_params,
                                                        save_hf_checkpoint)
    from crisperwhisper_tpu_torch.models.whisper import (
        audio_classification_forward, decode_step, encode, forward,
        init_cache, init_classification_head)
    from crisperwhisper_tpu_torch.utils.checkpoint import (load_saved_params,
                                                           save_params)

    t_phase = time.perf_counter()
    arch, params = large
    pipe = load_pipeline(_large_ckpt(tmp, arch), params=params, device="cuda",
                         language="en")
    opts = replace(pipe.gen_opts, max_new_tokens=96, temperatures=(0.0,),
                   force_unique_generate_call=True)
    specials = pipe.specials
    (wav, _), _ = _large_requests(tmp)
    batch, n_windows = _pipeline_windows(pipe, wav)
    feats = extract_features(batch, pipe.feat_cfg)
    rows = feats.shape[0]
    lang = pipe._language_token()
    prompt = build_prompt(specials, rows, language_token=lang,
                          return_timestamps=opts.return_timestamps,
                          forced_tokens=opts.forced_tokens)
    totals: dict[str, int] = {}
    main_path = ("encoder_attention", "align_prep", "dtw")

    def part(label: str, kernels: tuple[str, ...], fn):
        """fn() with every count reset just before and read just after:
        (its result, the counts, wall seconds, the process's CPU
        seconds)."""
        _reset_counts()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        out = fn()
        torch.cuda.synchronize()
        wall, cpu = time.perf_counter() - t0, time.process_time() - c0
        counts = _counts()
        for k in kernels:
            _require(counts[k] > 0, f"phase 10 ({label}): kernel {k} was "
                                    "not launched")
        for k in main_path:
            totals[k] = totals.get(k, 0) + counts[k]
        return out, counts, wall, cpu

    # (a) forward on 96 ids: the prompt and what the seek loop produced
    gen = longform.generate(params, arch, specials, opts, feats,
                            language_token=lang)
    ids = np.full((rows, 96), specials.eot, np.int64)
    for r in range(rows):
        row = np.concatenate([prompt[r], gen.sequences[r]])[:96]
        ids[r, :len(row)] = row
    ids = torch.from_numpy(ids).cuda()

    def stepwise(p):
        """decode_step fed the same ids one by one: logits [B, 96, V]."""
        cache = init_cache(p, arch, encode(p, arch, feats), cache_len=96)
        steps = []
        for t in range(96):
            logits, cache, _ = decode_step(p, arch, ids[:, t], t, cache)
            steps.append(logits)
        return torch.stack(steps, 1)

    logits, counts, wall_a, _ = part("a", ("encoder_attention",),
                                     lambda: forward(params, arch, feats, ids))
    _require(counts["encoder_attention_tensor_cores"]
             == counts["encoder_attention"],
             f"phase 10 (a): encoder attention left the tensor-core route: "
             f"{counts}")
    _require(tuple(logits.shape) == (rows, 96, arch.vocab_size)
             and bool(torch.isfinite(logits).all()),
             f"phase 10 (a): forward logits {tuple(logits.shape)} not finite")
    ref = stepwise(params)
    agree16 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    gap16 = (logits - ref).abs().max().item()
    del logits, ref
    p32 = testing.to_device(params, torch.float32)
    logits = forward(p32, arch, feats, ids)
    ref = stepwise(p32)
    agree32 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    gap32 = (logits - ref).abs().max().item()
    del logits, ref, p32
    torch.cuda.empty_cache()
    _require(agree32 >= 0.9, f"phase 10 (a): forward and decode_step agree "
                             f"on {agree32} of the top-1 tokens at f32")
    # Measured 8.151e-06 on an NVIDIA H100 80GB HBM3 at 700.00 W; the bound
    # leaves two orders of magnitude and catches a fault at a few positions.
    _require(gap32 <= 1e-3, f"phase 10 (a): forward and decode_step differ "
                            f"by {gap32} in a logit at f32 (bound 1e-3)")
    print(f"phase 10 (a): forward on the {n_windows} windows ASRPipeline "
          f"cuts from the 60 s WAV (batch {rows}) and 96 decoder ids (the "
          f"prompt and the seek loop's tokens): {wall_a:.3f} s wall at bf16; "
          f"top-1 agreement with decode_step fed the same ids {agree32:.4f} "
          f"at f32 (band 0.9), {agree16:.4f} at bf16 (informative); largest "
          f"logit difference {gap32:.4g} at f32 (bound 1e-3), {gap16:.4g} at "
          f"bf16; "
          f"launches encoder_attention {counts['encoder_attention']}, all on "
          "the tensor cores", flush=True)

    # (b) audio classification with a random 16-label head
    head = init_classification_head(
        arch, 16, torch.Generator(device="cuda").manual_seed(10),
        device="cuda")
    cls, counts, wall_b, _ = part(
        "b", ("encoder_attention",),
        lambda: audio_classification_forward(params, arch, feats, head))
    _require(tuple(cls.shape) == (rows, 16) and cls.dtype == torch.float32
             and bool(torch.isfinite(cls).all()),
             f"phase 10 (b): logits {tuple(cls.shape)} {cls.dtype}")
    print(f"phase 10 (b): audio_classification_forward, 16 labels: "
          f"{wall_b:.3f} s wall, logits {list(cls.shape)} finite; launches "
          f"encoder_attention {counts['encoder_attention']}", flush=True)

    # (c) short-form generation with word timestamps, (d) the same on
    # group-wise int4 weights (the decode-step kernel's gate refuses them)
    def short_form(p, o):
        return generate_short_form(p, arch, specials, o, feats, prompt=prompt)

    def monotone(out) -> bool:
        return all(bool(np.all(np.diff(out.token_timestamps[
            r, :prompt.shape[1] + int(out.num_generated[r])]) >= 0))
            for r in range(rows))

    sf, counts, wall_c, cpu_c = part("c", main_path,
                                     lambda: short_form(params, opts))
    _require(monotone(sf), "phase 10 (c): token timestamps decrease: "
                           f"{sf.token_timestamps}")
    print(f"phase 10 (c): generate_short_form with word timestamps: "
          f"{wall_c:.3f} s wall, the process's CPU seconds in it "
          f"{cpu_c:.3f}; tokens generated {sf.num_generated.tolist()}; "
          f"timestamps non-decreasing; launches "
          f"{_nonzero({k: counts[k] for k in main_path})}", flush=True)
    q4 = Q.quantize_decoder_weights(Q.fuse_decoder_qkv(params, arch.head_dim),
                                    bits=4)
    sf4, counts, wall_d, _ = part(
        "d", main_path,
        lambda: short_form(q4, replace(opts, b1_decode_kernel=True)))
    _require(counts["decode_step"] == 0,
             f"phase 10 (d): the decode-step kernel ran on int4 weights: "
             f"{counts['decode_step']}")
    _require(monotone(sf4), "phase 10 (d): token timestamps decrease")
    print(f"phase 10 (d): the same on fused group-wise int4 weights with "
          f"b1_decode_kernel: {wall_d:.3f} s wall; token agreement with (c) "
          f"{testing.token_agreement(list(sf.sequences), list(sf4.sequences)):.3f}"
          f" (random weights, informative); decode_step launches "
          f"{counts['decode_step']}; launches "
          f"{_nonzero({k: counts[k] for k in main_path})}", flush=True)
    del q4

    # (e) checkpoints of the first 4 layers of each stack at full width
    small = {stack: {**params[stack], "layers": params[stack]["layers"][:4]}
             for stack in ("encoder", "decoder")}
    arch4 = replace(arch, encoder_layers=len(small["encoder"]["layers"]),
                    decoder_layers=len(small["decoder"]["layers"]))
    lines = []

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def size(path: str) -> int:
        return sum(os.path.getsize(os.path.join(path, n))
                   for n in os.listdir(path))

    d = os.path.join(tmp, "export")
    _, save_s = timed(lambda: save_hf_checkpoint(d, small, arch4))
    (back, _), load_s = timed(lambda: load_params(d, dtype=torch.bfloat16,
                                                  device="cuda"))
    bad = testing.tree_mismatch(small, back, "cuda")
    _require(not bad, f"phase 10 (e): HF export round trip differs at {bad}")
    lines.append(f"save_hf_checkpoint -> load_params bf16: {size(d)} bytes, "
                 f"{save_s:.2f} s + {load_s:.2f} s")
    shutil.rmtree(d)
    for kind, tree in (("fused int8", lambda: Q.quantize_decoder_weights(
                            Q.fuse_decoder_qkv(small, arch.head_dim))),
                       ("int4", lambda: Q.quantize_decoder_weights(
                            small, bits=4))):
        tree = tree()
        d = os.path.join(tmp, "saved")
        _, save_s = timed(lambda: save_params(d, tree, {"kind": kind}))
        (back, meta), load_s = timed(lambda: load_saved_params(
            d, device="cuda"))
        bad = testing.tree_mismatch(tree, back, "cuda")
        _require(not bad and meta == {"kind": kind},
                 f"phase 10 (e): {kind} round trip differs at {bad}")
        lines.append(f"save_params -> load_saved_params {kind}: "
                     f"{size(d)} bytes, {save_s:.2f} s + {load_s:.2f} s")
        shutil.rmtree(d)
    del small, back, tree
    print(f"phase 10 (e): 4 layers a stack at large-v3 width, every leaf "
          f"back on the card bit-equal with its dtype: " + "; ".join(lines),
          flush=True)

    # (f) the seek loop's progress on the 60 s WAV's features
    audio = load_audio(wav, testing.SR)
    cfg60 = replace(pipe.feat_cfg,
                    chunk_length=len(audio) // testing.SR)
    feats60 = extract_features(
        torch.from_numpy(audio[None, :cfg60.n_samples]).cuda(), cfg60)
    seen: list[np.ndarray] = []
    passes = []
    real_window = longform._decode_window

    def counted(*a, **kw):
        passes.append(1)
        return real_window(*a, **kw)

    longform._decode_window = counted
    try:
        _, _, wall_f, _ = part("f", main_path, lambda: longform.generate(
            params, arch, specials, replace(opts,
                                            force_unique_generate_call=False),
            feats60, language_token=lang, monitor_progress=seen.append))
    finally:
        longform._decode_window = real_window
    seeks = [int(a[0, 0]) for a in seen]
    frames = feats60.shape[-1]
    _require(len(seen) == len(passes) > 1
             and all(a.shape == (1, 2) and int(a[0, 1]) == frames
                     for a in seen)
             and seeks == sorted(seeks) and seeks[-1] < frames,
             f"phase 10 (f): progress {seen} over {len(passes)} passes")
    print(f"phase 10 (f): generate(monitor_progress=...) on the 60 s WAV's "
          f"{frames} frames: {len(seen)} calls for {len(passes)} seek "
          f"passes, seek {seeks} of max_frames {frames} (the loop ends "
          f"when every row's seek reaches it), {wall_f:.2f} s wall",
          flush=True)
    print(f"phase 10 ok: the full-sequence, auxiliary, short-form, "
          f"checkpoint and progress entry points at large-v3 width in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return totals


def _phase11_one_rank(tmp: str, large, phase4_results) -> dict[str, int]:
    """(a): load_pipeline(mesh=) on a 1 x 1 mesh, a world of one over NCCL
    in this process, on phase 4's weights and request."""
    import torch
    import torch.distributed as dist
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.parallel import init_multihost, make_mesh

    arch, params = large
    (wav, _), _ = _large_requests(tmp)
    init_multihost(f"127.0.0.1:{testing.free_port()}", 1, 0,
                   backend="nccl", timeout=testing.COLLECTIVE_TIMEOUT_S)
    try:
        pipe = load_pipeline(_large_ckpt(tmp, arch), params=params,
                             mesh=make_mesh(1, 1), language="en")
        pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=96,
                                force_unique_generate_call=True)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe(wav, return_timestamps="word", adjust_pauses_threshold=0.12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        pipe.close()
        del pipe
    finally:
        dist.destroy_process_group()
    try:
        gap = testing.result_gap(phase4_results[0], res)
    except AssertionError as e:
        raise SmokeError(f"phase 11 (a): the 1 x 1 mesh differs from phase "
                         f"4: {e}") from e
    _require(gap <= testing.TS_BAND,
             f"phase 11 (a): word timestamps {gap} s from phase 4's")
    main = {k: counts[k] for k in ("encoder_attention", "align_prep", "dtw")}
    for name, n in main.items():
        _require(n > 0, f"phase 11 (a): kernel {name} was not launched")
    print(f"phase 11 (a): mesh 1 x 1 over NCCL (a world of one) on phase 4's "
          f"bf16 weights, the 60 s WAV: text and {len(res['chunks'])} words "
          f"equal to phase 4's, timestamps within {gap:.4g} s; {wall:.2f} s "
          f"wall; launches {main}", flush=True)
    return main


def _phase11_two_ranks(tmp: str, large) -> dict[str, int]:
    """(b): two ranks at model = 2 (NCCL on two cards, else gloo on this
    one) on the 12 s array, against the unsharded run in this process on
    the same seeded weights and request. Returns the launches of kernels
    1-3 over both ranks."""
    import torch
    from crisperwhisper_tpu_torch import testing

    arch, params = large
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    ckpt = _large_ckpt(tmp, arch)
    kw = {"max_new": 48, "language": "en"}
    ref32 = testing.unsharded_slice(ckpt, 12.0, "float32", **kw)
    torch.cuda.empty_cache()
    ref16 = testing.unsharded_slice(ckpt, 12.0, "bfloat16", **kw)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = testing.run_world(
        2, "crisperwhisper_tpu_torch.testing:mesh_slice",
        {"ckpt": ckpt, "seconds": 12.0, "dtypes": ["bfloat16", "float32"],
         "streams": 3, **kw}, backend=backend, device="cuda", timeout=600)
    world_s = time.perf_counter() - t0
    limit = 0.55 + 0.45 / 2
    totals: dict[str, int] = {}
    for r in ranks:
        for name, run in r["runs"].items():
            _require(run["param_share"] <= limit,
                     f"phase 11 (b) rank {r['rank']} {name}: "
                     f"{run['param_share']:.3f} of the replicated bytes")
            _require(run["heads"] == [arch.encoder_attention_heads // 2],
                     f"phase 11 (b) rank {r['rank']} {name}: encoder "
                     f"attention at heads {run['heads']}")
            for k in ("encoder_attention", "align_prep", "dtw"):
                _require(run["launches"][k] > 0,
                         f"phase 11 (b) rank {r['rank']} {name}: kernel {k} "
                         "was not launched")
                totals[k] = totals.get(k, 0) + run["launches"][k]
        bf16 = r["runs"]["bfloat16"]["launches"]
        _require(bf16["encoder_attention_tensor_cores"]
                 == bf16["encoder_attention"],
                 f"phase 11 (b) rank {r['rank']}: bf16 encoder attention "
                 f"left the tensor cores: {bf16}")
    r32, r16 = ranks[0]["runs"]["float32"], ranks[0]["runs"]["bfloat16"]
    agree32 = testing.token_agreement(ref32["tokens"], r32["tokens"])
    _require(agree32 >= 0.9, f"phase 11 (b): f32 token agreement with the "
                             f"unsharded run {agree32} (band 0.9)")
    _check_results([(None, 12.0)] * 2, [r32["direct"][0], r16["direct"][0]])
    streams = r32["streams"]
    _check_results([(None, 12.0)] * len(streams), streams)
    _require(len(streams) == 3, f"phase 11 (b): {len(streams)} batcher "
                                "streams came back, not 3")
    try:
        gap_s = [testing.result_gap(r32["direct"][0], s) for s in streams]
    except AssertionError as e:
        raise SmokeError(f"phase 11 (b): a batcher stream differs from the "
                         f"direct call: {e}") from e
    _require(max(gap_s) <= testing.TS_BAND,
             f"phase 11 (b): batcher stream word timestamps {gap_s} s from "
             f"the direct call's (band {testing.TS_BAND})")
    # the unsharded bf16 wall: a timed call after an untimed one
    pipe16 = testing._slice_pipeline(ckpt, params, kw["max_new"], "en")
    req = {"raw": testing.tone_audio(12.0, 2), "sampling_rate": testing.SR}
    pipe16(req, return_timestamps="word")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe16(req, return_timestamps="word")
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    del pipe16
    where = ("two cards over NCCL" if backend == "nccl" else
             "both ranks on this one card over gloo (not a speed "
             "comparison: two ranks share one card)")
    same = r32["direct"][0]["text"] == ref32["direct"][0]["text"]
    print(f"phase 11 (b): model = 2, {where}; {n_cards} card(s); the 12 s "
          f"array at large-v3 width, {kw['max_new']} new tokens: f32 token "
          f"agreement with the unsharded run {agree32:.3f} (band 0.9), text "
          f"{'equal' if same else 'differs'}; bf16 token agreement "
          f"{testing.token_agreement(ref16['tokens'], r16['tokens']):.3f} "
          f"(informative); parameter bytes per rank "
          + ", ".join(f"{r['runs']['float32']['param_share']:.3f}"
                      for r in ranks)
          + f" of the replicated (limit {limit:.3f}); encoder attention at "
          f"{r16['heads']} heads a rank, all "
          f"{r16['launches']['encoder_attention']} bf16 launches of rank 0 "
          f"on the tensor cores; bf16 wall rank 0 {r16['wall']:.2f} s, "
          f"unsharded {wall16:.2f} s; StreamingBatcher, 3 streams of the "
          f"f32 pipeline: text and words equal to the direct call, "
          f"timestamps within {max(gap_s):.4g} s; the world took {world_s:.1f} s", flush=True)
    return totals


def _phase11_dryrun() -> dict[str, int]:
    """(c): dryrun_multichip on every card where there are two or more.
    Returns the launches of kernels 1-3 over the ranks."""
    import torch
    from crisperwhisper_tpu_torch.parallel import dryrun

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"phase 11 (c): dryrun_multichip not run: {n_cards} card "
              "(it needs one card a rank)", flush=True)
        return {}
    t0 = time.perf_counter()
    results = dryrun.run_dryrun(n_cards, "cuda")
    launches = dryrun.rank_launches(results)
    print(f"phase 11 (c): {results[0]['line']} (NCCL, {n_cards} cards, "
          f"{time.perf_counter() - t0:.1f} s); launches {launches}",
          flush=True)
    return launches


def phase11_parallel(tmp: str, large, card: str,
                     phase4_results) -> dict[str, int]:
    """Tensor-parallel serving over torch.distributed at large-v3 width:
    (a) a 1 x 1 mesh in this process; (b) two ranks at model = 2; (c) the
    dry run on every card. Returns the launches of kernels 1-3 over every
    rank."""
    t_phase = time.perf_counter()
    totals: dict[str, int] = {}
    for part in (_phase11_one_rank(tmp, large, phase4_results),
                 _phase11_two_ranks(tmp, large), _phase11_dryrun()):
        for k, n in part.items():
            totals[k] = totals.get(k, 0) + n
    print(f"phase 11 ok: tensor-parallel serving in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return totals


# Uni-MoE-2.0-Omni's published keys that models/speech_moe reads (its
# config.json, HIT-TMG/Uni-MoE-2.0-Omni); phase 12 runs 2 of its 28
# language-model layers
UNI_MOE = {"model_type": "grin_qwen2_vl", "hidden_size": 3584,
           "num_hidden_layers": 2, "num_attention_heads": 28,
           "num_key_value_heads": 4, "rope_theta": 1000000,
           "rms_norm_eps": 1e-6, "vocab_size": 152064,
           "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
           "dynamic_intermediate_size": 18944, "mlp_dynamic_top_p": 0.7,
           "mlp_dynamic_top_k": 2, "mlp_fixed_expert_num": 2,
           "shared_intermediate_size": 2368,
           "max_position_embeddings": 128000, "whisper_hidden_size": 1280,
           "whisper_query_tokens_size": 200}


def _expert_work(arch, rows: int, active: int) -> tuple[float, float]:
    """(bytes, operations) of the grouped expert kernel's two launches
    (portbench/work_speech_moe.expert_work): each active expert's three
    matrices read once, each row's input, its silu(gate) * up written and
    read back and its f32 output; six operations a row and weight."""
    d, f = arch.hidden_size, arch.expert_dim
    return (active * 3 * d * f * 2 + rows * (d * 2 + 2 * f * 2 + d * 4),
            2 * 3 * d * f * rows)


def phase12_speech_moe(tmp: str) -> tuple[dict, int]:
    """The speech LM's grouped expert kernel at the benchmark cell's
    shapes, then on the main path (module docstring). Returns its kernel
    entry and its launches in (b)."""
    import numpy as np
    import torch

    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models import speech_moe
    from crisperwhisper_tpu_torch.ops import moe
    from crisperwhisper_tpu_torch.utils import tracing

    ck = testing.write_speech_moe_configs(os.path.join(tmp, "moe_ckpt"),
                                          UNI_MOE)
    arch = speech_moe.SpeechMoEArch.from_hf_config(UNI_MOE)
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = testing.speech_moe_params(arch, gen, "cuda", torch.bfloat16)
    lp = params["decoder"]["layers"][0]
    e, d = arch.num_experts, arch.hidden_size
    pipe = load_pipeline(ck, dtype=torch.bfloat16, device="cuda",
                         params=params,
                         pipe_opts=PipelineOptions(batch_size=64))
    prompt = len(pipe.specials.prompt)
    worst, rows_ms = 0.0, {}
    for tokens in (64, 64 * prompt):
        y = torch.randn((tokens, d), generator=gen, device="cuda")
        r = moe.route(y, lp["router"]["w"], e, arch.top_p, arch.top_k)
        x = y.to(torch.bfloat16)
        token, weight, offsets = moe.expert_pairs(r, e)
        got = moe.routed_experts(x, r, lp["experts"], e)
        want = moe._plain(x, token, weight, offsets, lp["experts"])
        gap = ((got - want).abs().max() / want.abs().max()).item()
        _require(gap <= testing.MOE_BAND,
                 f"grouped_swiglu: {tokens} tokens off the plain twin by "
                 f"{gap:.3g} of the largest output")
        worst = max(worst, gap)
        counts = torch.diff(offsets).tolist()
        routed, active = sum(counts), sum(c > 0 for c in counts)
        step = tokens <= moe.STEP_ROWS
        ms = _time_ms(lambda: moe.routed_experts(x, r, lp["experts"], e),
                      20 if step else 5)
        plain_ms = _time_ms(lambda: moe._plain(x, token, weight, offsets,
                                               lp["experts"]), 2)
        bound, by = _bound(*_expert_work(arch, routed, active), "bf16")
        rows_ms[tokens] = (ms, plain_ms, bound, by)
        print(f"phase 12 grouped_swiglu: {tokens} tokens, {routed} routed "
              f"rows over {active} experts ({'step' if step else 'block'} "
              f"tiles), rel err {gap:.3g}; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"{100 * bound / ms:.1f}%)", flush=True)
        del y, r, x, got, want

    # the main path: one batch of 64 windows, each decoding 96 tokens
    # (every id from <|endoftext|> on suppressed, so no row ends early)
    pipe.gen_opts = replace(
        pipe.gen_opts, max_new_tokens=96, temperatures=(0.0,),
        compression_ratio_threshold=None, logprob_threshold=None,
        no_speech_threshold=None, force_unique_generate_call=True,
        suppress_tokens=tuple(range(
            testing.SPEECH_LM_SPECIALS["<|endoftext|>"], arch.vocab_size)))
    rng = np.random.default_rng(12)
    audios = [testing.tone_audio(10.0, seed=i) * float(rng.uniform(0.3, 1))
              for i in range(64)]
    moe.grouped_swiglu.launches = 0
    with tracing.recording() as recs:
        out = pipe([{"raw": a, "sampling_rate": testing.SR} for a in audios],
                   return_timestamps=False)
        torch.cuda.synchronize()
    launches = moe.grouped_swiglu.launches
    decodes = [r for r in recs if r.name == "cw.decode"]
    steps = sum(r.counts["steps"] for r in decodes)
    want = 2 * arch.num_hidden_layers * (len(decodes) + steps)
    _require(len(out) == len(audios) and all(
        isinstance(o.get("text"), str) and o["text"] for o in out),
        "speech LM: a result without text")
    _require(launches == want > 0,
             f"grouped_swiglu: {launches} launches on the main path, "
             f"{want} expected")
    print(f"phase 12 speech LM main path: {len(audios)} recordings, "
          f"{len(decodes)} window batch(es), {steps} steps, {launches} "
          f"grouped_swiglu launches", flush=True)
    del pipe, params
    torch.cuda.empty_cache()
    ms, plain_ms, bound, by = rows_ms[64]
    return {"name": "grouped_swiglu", "route": "cuda",
            "source": "crisperwhisper_tpu_torch/csrc/moe.cu",
            "replaces": "none (the JAX package has no mixture of experts)",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "prefill_ms": rows_ms[64 * prompt][0],
            "prefill_bound_ms": rows_ms[64 * prompt][2]}, launches


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
        card = phase0_device()
        phase1_build()
        large = _large_params()
        entries = phase2_kernels(large) + phase2_remaining(large)
        with tempfile.TemporaryDirectory(prefix="cw_smoke_") as tmp:
            phase3_tiny(tmp)
            launches, phase4_results = phase4_large(tmp, large)
            launches["decode_step"] = phase5_serving(tmp, large)
            spec = phase6_speculative(tmp, large)
            launches["decode_step"] += phase7_beams_prompts(tmp, large)
            for name, n in phase8_remaining(tmp, large).items():
                launches[name] = launches.get(name, 0) + n
            for name, n in phase9_serving(tmp, large, card).items():
                launches[name] += n
            for name, n in phase10_entry_points(tmp, large, card).items():
                launches[name] += n
            for name, n in phase11_parallel(tmp, large, card,
                                            phase4_results).items():
                launches[name] += n
            moe_entry, launches["grouped_swiglu"] = phase12_speech_moe(tmp)
            entries.append(moe_entry)
        launches["decode_step"] += spec["decode_step"]
        launches["ring_write"] += spec["ring_write"]
        _require(not any(m.split(".")[0] in ("jax", "crisperwhisper_tpu")
                         for m in sys.modules),
                 "jax or the JAX package was imported")
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{**{k: (launches[e["name"]] if k == "launches" else e[k])
                   for k in keys},
                **{k: x for k, x in e.items() if k not in keys}}
               for e in entries]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
