"""PyTorch port on the card: each kernel against its plain version, and
the TINY slice (plain, quantized serving, speculative, beam search and
prompting) on CUDA against the same slice on the CPU.

The comparisons and their bands are crisperwhisper_tpu_torch.testing's,
which chip_smoke.py runs too. Every test carries the ``gpu`` marker and
skips without a CUDA card. The file imports no JAX, so it also runs where
JAX is absent (tests/conftest.py imports it, hence ``--noconftest``):

    PYTHONPATH=.:tests python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from crisperwhisper_tpu_torch import testing

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


_OWN_GENERATOR = {((4, 20, 1500, 64), torch.float16),
                  ((16, 20, 1500, 64), torch.bfloat16),
                  ((2, 4, 300, 64), torch.float16),
                  ((3, 4, 250, 16), torch.float16)}


@pytest.mark.parametrize("shape,dtype", [
    ((4, 20, 1500, 64), torch.float32),
    ((4, 20, 1500, 64), torch.bfloat16),
    ((4, 20, 1500, 64), torch.float16),
    ((16, 20, 1500, 64), torch.bfloat16),
    ((2, 4, 300, 64), torch.float32),
    ((2, 4, 300, 64), torch.float16),
    ((3, 4, 250, 16), torch.float32),
    ((3, 4, 250, 16), torch.float16),
    ((1, 2, 77, 32), torch.bfloat16)])
def test_attention_kernel_matches_plain(gen, shape, dtype):
    """Each case against the plain version, on its route. The f16 and
    batch-16 cases draw from a generator of their own, so the module's
    shared stream, and every later test's inputs, stay as they were before
    those cases existed."""
    from crisperwhisper_tpu_torch.ops.fused_attention import (fused_attention,
                                                              route)
    if (shape, dtype) in _OWN_GENERATOR:
        gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").mul(s)
               .to(dtype) for s in (0.3, 0.3, 1.0))
    before = fused_attention.launches
    by_route = dict(fused_attention.route_launches)
    assert fused_attention(q, k, v).dtype == dtype
    err, band = testing.attention_error(q, k, v)
    assert fused_attention.launches == before + 2
    path = route(dtype, shape[3])
    assert path == ("cuda_cores" if dtype == torch.float32
                    else "tensor_cores")
    assert fused_attention.route_launches[path] == by_route[path] + 2
    assert err <= band


def test_attention_kernel_rejects_what_it_does_not_take(gen):
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    q = torch.zeros((1, 2, 8, 128), device="cuda")
    with pytest.raises(ValueError):
        fused_attention(q, q, q)                    # head dim 128
    with pytest.raises(TypeError):
        h = q[..., :64].contiguous().double()
        fused_attention(h, h, h)                    # float64
    with pytest.raises(ValueError):
        x = torch.zeros((1, 2, 64, 8), device="cuda").transpose(2, 3)
        fused_attention(x, x, x)                    # not contiguous


def _prep_inputs(gen, b, a, t, m, crop):
    w = torch.softmax(torch.randn((b, a, t, m), generator=gen,
                                  device="cuda") * 3.0, dim=-1).contiguous()
    nt = torch.randint(0, t + 1, (b,), generator=gen, device="cuda",
                       dtype=torch.int32)
    nf = torch.full((b,), m, dtype=torch.int32, device="cuda")
    nf[-1] = crop
    return w, nt, nf


@pytest.mark.parametrize("b,a,t,m,crop", [(4, 15, 96, 1500, 1000),
                                          (3, 3, 25, 250, 2),
                                          (2, 4, 9, 130, 4)])
def test_align_prep_kernel_matches_plain(gen, b, a, t, m, crop):
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    w, nt, nf = _prep_inputs(gen, b, a, t, m, crop)
    before = align_prep.launches
    err, _ = testing.align_prep_error(w, nt, nf)
    assert align_prep.launches == before + 1
    assert err <= testing.PREP_BAND


@pytest.mark.parametrize("width", [1, 3, 5, 9])
def test_align_prep_kernel_any_width_matches_plain(gen, width):
    """Median widths other than 7 (the reference app runs 3) on the
    kernel, full rows and rows cropped at, just past and near the width
    (the plain chain's reflection for n_frames <= width // 2 included)."""
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    own = torch.Generator(device="cuda").manual_seed(width)  # gen untouched
    for b, a, t, m, crop in ((4, 15, 96, 1500, 1000),
                             (3, 3, 25, 250, width // 2),
                             (2, 4, 9, 130, width // 2 + 1),
                             (2, 3, 17, 200, width + 2)):
        w, nt, nf = _prep_inputs(own, b, a, t, m, crop)
        before = align_prep.launches
        err, _ = testing.align_prep_error(w, nt, nf, width)
        assert align_prep.launches == before + 1
        assert err <= testing.PREP_BAND, (width, b, a, t, m, crop, err)


@pytest.mark.parametrize("b,n,m", [(4, 96, 1500), (3, 25, 90), (2, 381, 1500),
                                   (1, 1, 5)])
def test_dtw_kernel_matches_plain_exactly(gen, b, n, m):
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    mat = torch.randn((b, n, m), generator=gen, device="cuda")
    nt = torch.randint(0, n + 1, (b,), generator=gen, device="cuda",
                       dtype=torch.int32)
    nf = torch.randint(1, m + 1, (b,), generator=gen, device="cuda",
                       dtype=torch.int32)
    mat = torch.where(testing.live_cells(nt, nf, n, m), mat,
                      torch.tensor(1e9, device="cuda")).contiguous()
    before = dtw.launches
    assert testing.dtw_error(mat, nt, nf) == 0
    assert dtw.launches == before + 1


def _dtw_case(own, b, n, m, kind):
    if kind == "ties":          # integer costs: ties on the tie-break
        return torch.randint(0, 3, (b, n, m), generator=own, device="cuda",
                             dtype=torch.int32).float()
    return torch.randn((b, n, m), generator=own, device="cuda")


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 96, 97, 381, 448])
def test_dtw_kernel_exact_at_lane_and_band_edges(gen, n, kind):
    """Token counts at the edges of a lane's run and of a warp's band,
    rows with n_tokens = 0, n_frames = 1 and n_tokens < N, the cells
    outside each row's live rectangle left random (never read): exact
    against the plain version, one launch a call."""
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    own = torch.Generator(device="cuda").manual_seed(n)   # gen untouched
    m = 1500 if n >= 96 else 257
    mat = _dtw_case(own, 4, n, m, kind)
    nt = torch.tensor([n, n // 2, 0, max(n - 3, 1)], dtype=torch.int32,
                      device="cuda")
    nf = torch.tensor([m, 1, m - 5, 37], dtype=torch.int32, device="cuda")
    before = dtw.launches
    assert testing.dtw_error(mat, nt, nf) == 0
    assert dtw.launches == before + 1


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_dtw_kernel_exact_at_batch_16(gen, kind):
    """The CLI's batch of 16 windows at [16, 96, 1500], random n_tokens and
    n_frames, random cells outside the rectangles; the stamps split one
    launch into its walk and its backtrace."""
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    own = torch.Generator(device="cuda").manual_seed(16)
    mat = _dtw_case(own, 16, 96, 1500, kind)
    nt = torch.randint(0, 97, (16,), generator=own, device="cuda",
                       dtype=torch.int32)
    nf = torch.randint(1, 1501, (16,), generator=own, device="cuda",
                       dtype=torch.int32)
    before = dtw.launches
    assert testing.dtw_error(mat, nt, nf) == 0
    assert dtw.launches == before + 1
    total, walk, back = testing.dtw_phases(mat, nt, nf)
    assert 0 < walk + back <= total * 1.001 + 1e-6


# Runs in a child process: a trap ends the process's CUDA context.
_TRAP_CHILD = r"""
import ctypes, sys
import torch
from crisperwhisper_tpu_torch.ops import dtw as dt
from crisperwhisper_tpu_torch.ops.alignment import dtw_jump_times
lib = ctypes.CDLL(sys.argv[1])
ptr, i32 = ctypes.c_void_p, ctypes.c_int
lib.cw_dtw.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
gen = torch.Generator(device="cuda").manual_seed(0)

def run(n, m):
    mat = torch.randn((1, n, m), generator=gen, device="cuda")
    nt = torch.tensor([n], dtype=torch.int32, device="cuda")
    nf = torch.tensor([m], dtype=torch.int32, device="cuda")
    out = torch.empty((1, n), dtype=torch.int32, device="cuda")
    warps, step = dt.plan(n, m)
    err = lib.cw_dtw(mat.data_ptr(), nt.data_ptr(), nf.data_ptr(),
                     out.data_ptr(), None, 1, n, m, warps, step,
                     torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    return out.cpu(), dtw_jump_times(mat.cpu(), nt.cpu(), nf.cpu())

got, want = run(32, 257)
assert torch.equal(got, want)
print("one warp exact", flush=True)
run(448, 1500)
print("no trap", flush=True)
"""


def test_dtw_kernel_traps_when_a_hand_off_never_comes(gen, tmp_path):
    """A build of csrc/dtw.cu whose hand-off waits give up at the first
    short observation (CW_DTW_SPIN_LIMIT=0) is exact with one warp, which
    never waits, and fails loudly at 14 warps, where a warp's first wait
    runs out: a wait that never ends is an error, not a wrong path."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from crisperwhisper_tpu_torch import _build
    obj, so = tmp_path / "dtw.o", tmp_path / "libdtw_trap.so"
    _build.compile_object(_build.CSRC / "dtw.cu", obj,
                          "-DCW_DTW_SPIN_LIMIT=0")
    _build.link([obj], so)
    root = str(Path(_build.__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD, str(so)],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert "one warp exact" in proc.stdout, proc.stderr
    assert "no trap" not in proc.stdout and proc.returncode != 0
    assert "CUDA error" in proc.stderr, proc.stderr


def _edge_frames(b, m, width):
    """n_frames at a 32-frame tile edge, one each side, at and under the
    median's half width, and full."""
    edges = [32, 31, 33, 64, width // 2, max(width // 2 - 1, 0), m]
    return torch.tensor([min(edges[i % len(edges)], m) for i in range(b)],
                        dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("b,a,t,m", [(16, 15, 96, 1500), (3, 15, 1, 1500),
                                     (2, 4, 97, 1500), (2, 15, 381, 1500),
                                     (3, 1, 40, 701)])
def test_align_prep_kernel_shapes_match_plain(gen, b, a, t, m):
    """The CLI's batch of 16, T = 1, 97 and 381, one head, and a frame
    count that is not a multiple of 4 (the 4-byte copy path): within the
    band on the live cells, one launch a call."""
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    own = torch.Generator(device="cuda").manual_seed(b * t + a)
    w = torch.softmax(torch.randn((b, a, t, m), generator=own,
                                  device="cuda") * 3.0, dim=-1).contiguous()
    nt = torch.randint(0, t + 1, (b,), generator=own, device="cuda",
                       dtype=torch.int32)
    nt[0] = t
    nf = torch.full((b,), m, dtype=torch.int32, device="cuda")
    nf[-1] = m - 37
    before = align_prep.launches
    err, got = testing.align_prep_error(w, nt, nf)
    assert align_prep.launches == before + 1
    assert err <= testing.PREP_BAND
    dead = ~testing.live_cells(nt, nf, t, m)
    assert bool((got[dead] == 0).all())


@pytest.mark.parametrize("width", [1, 3, 5, 7, 9, 17])
def test_align_prep_kernel_frames_at_tile_edges(gen, width):
    """n_frames at a tile edge, one each side of it, and at or under the
    median's half width (reflection folds back past 0), for the network
    widths and one the rank selection takes (17)."""
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    own = torch.Generator(device="cuda").manual_seed(100 + width)
    b, a, t, m = 7, 3, 25, 300
    w = torch.softmax(torch.randn((b, a, t, m), generator=own,
                                  device="cuda") * 3.0, dim=-1).contiguous()
    nt = torch.full((b,), t, dtype=torch.int32, device="cuda")
    nt[1] = 9
    before = align_prep.launches
    err, _ = testing.align_prep_error(w, nt, _edge_frames(b, m, width), width)
    assert align_prep.launches == before + 1
    assert err <= testing.PREP_BAND, (width, err)


def test_tiny_slice_on_card_matches_cpu(gen, tmp_path):
    """Same seeded TINY weights through the whole slice on CUDA (kernels)
    and on the CPU (plain versions): equal tokens and words, timestamps
    within one DTW frame."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(12.0, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", audio)
    before = fused_attention.launches
    gpu = testing.tiny_slice(ckpt, params, "cuda", audio)
    assert fused_attention.launches > before and len(gpu[0]["chunks"]) > 0
    assert testing.slice_timestamp_gap(cpu, gpu) <= testing.TS_BAND


def test_streaming_batcher_and_live_session_on_card(gen, tmp_path):
    """The TINY serving slice on the card (testing.serving_slice): a
    StreamingBatcher whose worker thread runs the device batches (and
    launches the encoder-attention kernel) gives each stream the card
    pipeline's own result, with ordered, prefix-stable partials;
    LiveSession.finish() equals pipe(whole, adjust_pauses_threshold=0.12)
    on the card; the card pipeline's result is the CPU's."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(12.0, 0)
    gpu = testing.serving_slice(ckpt, params, "cuda", audio)
    assert gpu["batcher_launches"] > 0
    assert testing.serving_gap(gpu) <= testing.TS_BAND
    cpu = testing.serving_slice(ckpt, params, "cpu", audio)
    assert testing.result_gap(cpu["pipe"], gpu["pipe"]) <= testing.TS_BAND
    assert testing.result_gap(cpu["live"], gpu["live"]) <= testing.TS_BAND


def test_tiny_float16_pipeline_on_card(gen, tmp_path):
    """load_pipeline(dtype=torch.float16) answers a request on the card
    with word timestamps, its encoder attention on the tensor-core route."""
    import math

    from crisperwhisper_tpu_torch.config import PipelineOptions, WhisperArch
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda", torch.float16)
    po = PipelineOptions(chunk_length_s=testing.CHUNK_S, batch_size=16,
                         return_timestamps="word")
    pipe = load_pipeline(ckpt, dtype=torch.float16, device="cuda",
                         params=params, pipe_opts=po)
    before = fused_attention.route_launches["tensor_cores"]
    res = pipe({"raw": testing.tone_audio(12.0, 0),
                "sampling_rate": testing.SR}, return_timestamps="word",
               adjust_pauses_threshold=0.12)
    assert fused_attention.route_launches["tensor_cores"] > before
    assert res["text"] and len(res["chunks"]) > 0
    for c in res["chunks"]:
        assert all(math.isfinite(x) and x >= 0 for x in c["timestamp"])


@pytest.fixture(scope="module")
def tiny_quant(gen):
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    arch = WhisperArch(**testing.TINY)
    params = init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    return arch, testing.quantized_decoder(params, arch)


@pytest.mark.parametrize("rows,cross,position", [
    (1, "int8", 0), (1, "int4", 30), (3, "int4", 17), (4, "int8", 95),
    (8, "int4", 5)])
def test_decode_step_kernel_matches_plain(gen, tiny_quant, rows, cross,
                                          position):
    """Both modes (one row, 2-8 rows), int8 and int4 cross caches: hid,
    logits, alignment and fresh columns within testing's bands, one
    launch per call."""
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, rows, cross, 96, position, gen)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    before = whole_step.launches
    errs = testing.decode_step_errors(params, arch, x0, position, cache,
                                      ((0, 1), (1, 3), (0, 2)))
    assert whole_step.launches == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


@pytest.mark.parametrize("rows,cross,position", [
    (1, "int8", 0), (3, "int4", 17), (8, "int8", 95)])
def test_decode_step_kernel_rounds_ties_half_to_even(gen, tiny_quant, rows,
                                                      cross, position):
    """Fresh K/V values placed exactly on the int8 rounding's ties come
    out half-to-even with the exact scale (testing.tie_params)."""
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, rows, cross, 96, position, gen)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    assert testing.tie_column_error(params, arch, x0, position, cache) == 0


def test_decode_step_kernel_rejects_what_it_does_not_take(gen, tiny_quant):
    from dataclasses import replace
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, 1, "int8", 32, 3, gen)
    x0 = torch.zeros((1, arch.d_model), device="cuda")
    strided = replace(cache, self_k=cache.self_k.transpose(3, 4)
                      .contiguous().transpose(3, 4))
    with pytest.raises(ValueError):
        whole_step(params, arch, x0, 3, strided, (None,))   # strided ring
    wide = replace(arch, d_model=512)                       # head dim 128
    with pytest.raises(ValueError):
        whole_step(params, wide, torch.zeros((1, 512), device="cuda"), 3,
                   cache, (None,))
    with pytest.raises(ValueError):
        whole_step(params, arch, x0, 32, cache, (None,))    # past the ring


# (mode, rows, cross keys, cross dtype, align_bf16): every mode at M = 1,
# 2, 5 and 8; K below one split of the kernel's cross attention (128
# keys), not a multiple of it (250, TINY's own) and large-v3's 1500; both
# cross dtypes and both alignment captures in each mode.
_SPLIT_CASES = [
    ("rows", 1, 77, "int8", False), ("rows", 2, 250, "int4", True),
    ("rows", 5, 1500, "int8", True), ("rows", 8, 1500, "int4", False),
    ("multi", 1, 1500, "int4", True), ("multi", 2, 77, "int8", False),
    ("multi", 5, 250, "int4", False), ("multi", 8, 1500, "int8", True),
    ("beams", 1, 250, "int8", False), ("beams", 2, 1500, "int4", False),
    ("beams", 5, 77, "int4", True), ("beams", 8, 250, "int8", True)]


@pytest.mark.parametrize("mode,rows,k_enc,cross,align_bf16", _SPLIT_CASES)
def test_decode_step_kernel_splits_cross_keys(gen, tiny_quant, mode, rows,
                                              k_enc, cross, align_bf16):
    """The cross attention split over keys and combined in the next phase:
    hid, logits, alignment (f32 or bf16) and fresh columns within
    testing's bands against the plain step, one launch in its mode."""
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    multi, beams = mode == "multi", mode == "beams"
    cache = testing.random_step_cache(arch, 1 if multi else rows, cross, 96,
                                      9, gen, k_enc=k_enc,
                                      shared_cross=beams)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    key = mode if multi or beams else "b1" if rows == 1 else "rows"
    before = whole_step.mode_launches[key]
    errs = testing.decode_step_errors(params, arch, x0, 9, cache,
                                      ((0, 1), (1, 3), (0, 2)), multi=multi,
                                      beams=beams, align_bf16=align_bf16)
    assert whole_step.mode_launches[key] == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


@pytest.mark.parametrize("seed", range(8))
def test_decode_step_kernel_at_position_zero_holds_fed_bands(tiny_quant,
                                                            seed):
    """At position 0 the fresh column is a head's only live slot: hid,
    align and the fresh columns against the plain step fed the kernel's
    own fresh columns, within testing's bands, for 8 draws of their
    own."""
    arch, params = tiny_quant
    g = torch.Generator(device="cuda").manual_seed(100 + seed)
    cache = testing.random_step_cache(arch, 1, "int4", 96, 0, g)
    x0 = torch.randn((1, arch.d_model), generator=g, device="cuda")
    errs = testing.decode_step_errors(params, arch, x0, 0, cache,
                                      ((0, 1), (1, 3)))
    assert {"hid_fed", "align_fed", "columns_fed"} <= set(errs)
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


@pytest.mark.parametrize("seconds", [5.0, 12.0])
def test_tiny_serving_slice_on_card_matches_cpu(gen, tmp_path, seconds):
    """quantize="serving" with the whole-step kernel: one window (the b1
    mode) and four (the rows mode) give the CPU's tokens and words."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(seconds, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", audio, "serving")
    before = whole_step.launches
    gpu = testing.tiny_slice(ckpt, params, "cuda", audio, "serving")
    assert whole_step.launches > before
    assert testing.slice_timestamp_gap(cpu, gpu) <= testing.TS_BAND


@pytest.mark.parametrize("kind,rows,s", [("bf16", 16, 5), ("int8", 3, 1),
                                         ("int4", 16, 5), ("int8", 1, 8)])
def test_ring_write_kernel_matches_plain_bitwise(gen, tiny_quant, kind, rows,
                                                 s):
    """One launch writes every pair (K, V and the scale rings of a
    quantized ring) for every row; the rings equal the plain version's
    byte for byte."""
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    arch, _ = tiny_quant
    pairs, pos = testing.ring_write_inputs(arch, rows, s, 40, kind, gen)
    before = write_block_columns_group.launches
    assert testing.ring_write_error(pairs, 1, pos) == 0
    assert write_block_columns_group.launches == before + 1


def _bytes_equal(got, want) -> bool:
    """Every ring of two lists of (ring, block) pairs equal byte for byte."""
    return all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
               for (g, _), (w, _) in zip(got, want))


def _fresh_blocks(pairs, gen) -> None:
    """New random bytes in every block, in place."""
    for _, blk in pairs:
        blk.view(torch.uint8).copy_(torch.randint(
            0, 256, blk.view(torch.uint8).shape, generator=gen,
            device="cuda", dtype=torch.uint8))


def test_ring_write_plan_follows_the_live_rings(gen, tiny_quant):
    """One plan a set of rings, reused over every layer of two caches in
    turn (two plans built, all later calls find theirs; the first cache's
    plan passed in, as models/whisper.py does); then a ring replaced by a
    clone, called with the stale plan: the writes land in the clone, byte
    for byte as the plain version's, and the replaced ring is left as it
    was."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    arch, _ = tiny_quant
    g = torch.Generator(device="cuda").manual_seed(3)
    caches = [testing.ring_write_inputs(arch, 3, 4, 40, kind, g)
              for kind in ("int8", "int4")]
    wants = [[(ring.clone(), blk) for ring, blk in pairs]
             for pairs, _ in caches]
    built = rw._plan.cache_info().misses
    stale = rw.ring_plan([ring for ring, _ in caches[0][0]])
    before = rw.write_block_columns_group.launches
    for li in range(arch.decoder_layers):
        for (pairs, pos), want, plan in zip(caches, wants, (stale, None)):
            rw.write_block_columns_group(pairs, li, pos, plan)
            rw.write_block_columns_plain(want, li, pos.cpu())
    assert rw._plan.cache_info().misses - built == 2
    assert rw.write_block_columns_group.launches \
        == before + 2 * arch.decoder_layers
    for (pairs, _), want in zip(caches, wants):
        assert _bytes_equal(pairs, want)
    pairs, _ = caches[0]
    old = pairs[1][0]
    kept = old.clone()
    pairs[1] = (old.clone(), pairs[1][1])
    wants[0][1] = (pairs[1][0].clone(), pairs[1][1])
    _fresh_blocks(pairs, g)
    pos = torch.tensor([30, 0, 17], dtype=torch.int32, device="cuda")
    for li in range(arch.decoder_layers):
        rw.write_block_columns_group(pairs, li, pos, stale)
        rw.write_block_columns_plain(wants[0], li, pos.cpu())
    assert _bytes_equal(pairs, wants[0])
    assert torch.equal(old.view(torch.uint8), kept.view(torch.uint8))
    assert not torch.equal(pairs[1][0].view(torch.uint8),
                           kept.view(torch.uint8))


def test_ring_write_takes_positions_in_any_int_form(gen, tiny_quant):
    """Positions as device int32 (taken as they are), device int64, host
    int32 and host int64 (converted): the same bytes."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    arch, _ = tiny_quant
    g = torch.Generator(device="cuda").manual_seed(4)
    pairs, pos = testing.ring_write_inputs(arch, 16, 5, 40, "bf16", g)
    want = [(ring.clone(), blk) for ring, blk in pairs]
    rw.write_block_columns_plain(want, 1, pos.cpu())
    before = rw.write_block_columns_group.launches
    for form in (pos, pos.long(), pos.cpu(), pos.cpu().long()):
        got = [(ring.clone(), blk) for ring, blk in pairs]
        rw.write_block_columns_group(got, 1, form)
        assert _bytes_equal(got, want), form.dtype
    assert rw.write_block_columns_group.launches == before + 4


def test_ring_write_replays_from_a_cuda_graph(gen, tiny_quant):
    """Every layer's writes captured in one CUDA graph, the positions then
    changed in place and the graph replayed: the bytes of the plain
    version at the new positions (the kernel reads them on the device)."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    arch, _ = tiny_quant
    g = torch.Generator(device="cuda").manual_seed(5)
    pairs, pos = testing.ring_write_inputs(arch, 4, 3, 40, "int4", g)
    got = [(ring.clone(), blk) for ring, blk in pairs]
    rw.write_block_columns_group([(ring.clone(), blk) for ring, blk in pairs],
                                 0, pos)           # loads the kernel
    torch.cuda.synchronize()
    live = pos.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for li in range(arch.decoder_layers):
            rw.write_block_columns_group(got, li, live)
    moved = torch.tensor([36, 2, 20, 9], dtype=torch.int32, device="cuda")
    live.copy_(moved)
    graph.replay()
    torch.cuda.synchronize()
    want = [(ring.clone(), blk) for ring, blk in pairs]
    for li in range(arch.decoder_layers):
        rw.write_block_columns_plain(want, li, moved.cpu())
    assert _bytes_equal(got, want)


def test_ring_write_refuses_what_it_does_not_take(gen, tiny_quant):
    """The wrapper's errors on the card, each with its message: a block
    that does not fit (or a layer out of range), pairs that differ,
    positions of the wrong shape, a ring that is not contiguous, a block
    on the host, too many pairs."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    arch, _ = tiny_quant
    g = torch.Generator(device="cuda").manual_seed(6)
    pairs, pos = testing.ring_write_inputs(arch, 3, 2, 40, "int8", g)
    (k, kb), (v, vb), (ks, ksb), _ = pairs
    cases = [
        ([(k, kb[:2])], 0, pos, "does not fit"),
        ([(k, kb.float())], 0, pos, "does not fit"),
        ([(k, kb)], arch.decoder_layers, pos, "does not fit"),
        ([(k, kb), (v, vb[:, :, :1])], 0, pos, "pairs differ"),
        ([(k, kb), (v[:, :, :, :30], vb)], 0, pos, "pairs differ"),
        ([(k, kb)], 0, pos[:2], "positions"),
        ([(k, kb), (torch.zeros(k.shape[:3] + k.shape[:2:-1], dtype=k.dtype,
                                device="cuda").transpose(3, 4), vb)], 0, pos,
         "rings must be contiguous"),
        ([(k, kb.cpu())], 0, pos, "must lie on the rings' device"),
        ([(k, kb)] * 5, 0, pos, r"5 pairs \(1 to 4\)"),
        ([(ks, ksb.view(torch.int16))], 0, pos, "does not fit")]
    before = rw.write_block_columns_group.launches
    for ring_pairs, li, p, msg in cases:
        with pytest.raises(ValueError, match=msg):
            rw.write_block_columns_group(ring_pairs, li, p)
    assert rw.write_block_columns_group.launches == before


def test_raw_stream_helper_is_the_current_stream(gen):
    """``_build.current_stream`` is ``current_stream().cuda_stream``: on
    the default stream, under ``torch.cuda.stream`` and during graph
    capture."""
    from crisperwhisper_tpu_torch import _build
    dev = torch.cuda.current_device()
    assert _build.current_stream(dev) \
        == torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.current_stream(dev) == side.cuda_stream \
            == torch.cuda.current_stream(dev).cuda_stream
    x = torch.zeros(8, device="cuda")
    seen = []
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        seen.append((_build.current_stream(dev),
                     torch.cuda.current_stream(dev).cuda_stream))
        x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert seen[0][0] == seen[0][1]
    assert seen[0][0] != torch.cuda.current_stream(dev).cuda_stream
    assert torch.equal(x, torch.ones(8, device="cuda"))


@pytest.mark.parametrize("s,cross,position", [(5, "int4", 30), (8, "int8", 0),
                                              (3, "int4", 93)])
def test_decode_step_multi_kernel_matches_plain(gen, tiny_quant, s, cross,
                                                position):
    """The verify-block mode (S rows of one stream): hid, logits,
    alignment and all S fresh columns within testing's bands, ties
    exact."""
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, 1, cross, 96, position, gen)
    x0 = torch.randn((s, arch.d_model), generator=gen, device="cuda")
    before = whole_step.mode_launches["multi"]
    errs = testing.decode_step_errors(params, arch, x0, position, cache,
                                      ((0, 1), (1, 3), (0, 2)), multi=True)
    assert whole_step.mode_launches["multi"] == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    assert testing.tie_column_error(params, arch, x0, position, cache,
                                    multi=True) == 0


def test_decode_step_multi_at_one_row_equals_b1(gen, tiny_quant):
    """A one-row verify block runs the b1 mode's arithmetic: equal hid,
    alignment and rings, bit for bit."""
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, 1, "int4", 96, 40, gen)
    x0 = torch.randn((1, arch.d_model), generator=gen, device="cuda")
    heads = ((0, 1), (1, 3))
    a, b = testing.clone_cache(cache), testing.clone_cache(cache)
    hid1, al1 = whole_step(params, arch, x0, 40, a, heads)
    hidm, alm = whole_step(params, arch, x0, 40, b, heads, multi=True)
    assert torch.equal(hid1, hidm) and torch.equal(al1, alm)
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("seconds,quantize,assistant", [
    (12.0, False, "prompt_lookup"), (5.0, "serving", "self:1")])
def test_tiny_assisted_slice_on_card(gen, tmp_path, seconds, quantize,
                                     assistant):
    """Speculative decoding on the card: at 4 windows (per-row positions,
    the ring-write kernel) and at one serving window (the verify-block
    kernel), the CPU's tokens and words, and greedy's on the card."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(seconds, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", audio, quantize, assistant)
    greedy = testing.tiny_slice(ckpt, params, "cuda", audio, quantize)
    before = (write_block_columns_group.launches,
              whole_step.mode_launches["multi"])
    gpu = testing.tiny_slice(ckpt, params, "cuda", audio, quantize, assistant)
    after = (write_block_columns_group.launches,
             whole_step.mode_launches["multi"])
    kernel = 1 if quantize else 0       # the kernel this request reaches
    assert after[kernel] > before[kernel]
    assert testing.slice_timestamp_gap(cpu, gpu) <= testing.TS_BAND
    assert testing.slice_timestamp_gap(greedy, gpu) <= testing.TS_BAND


@pytest.mark.parametrize("rows,cross,position", [
    (2, "int8", 0), (3, "int4", 17), (5, "int4", 60), (8, "int8", 95)])
def test_decode_step_beams_kernel_matches_plain(gen, tiny_quant, rows, cross,
                                                position):
    """The beams mode (R beams, per-row rings, one cross cache of batch
    1): hid, logits, alignment and fresh columns within testing's bands,
    one beams-mode launch per call."""
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, rows, cross, 96, position, gen,
                                      shared_cross=True)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    before = whole_step.mode_launches["beams"]
    errs = testing.decode_step_errors(params, arch, x0, position, cache,
                                      ((0, 1), (1, 3), (0, 2)), beams=True)
    assert whole_step.mode_launches["beams"] == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


@pytest.mark.parametrize("rows,cross,position", [
    (2, "int8", 0), (5, "int4", 40), (8, "int4", 95)])
def test_decode_step_beams_equals_rows_on_repeated_cross(gen, tiny_quant, rows,
                                                         cross, position):
    """The beams mode is the rows mode with the cross cache shared: on the
    cross cache repeated per row, the rows mode gives the same hid,
    alignment and rings, bit for bit."""
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, rows, cross, 96, position, gen,
                                      shared_cross=True)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    assert testing.beams_rows_mismatch(params, arch, x0, position, cache,
                                       ((0, 1), (1, 3))) == []


@pytest.mark.parametrize("rows,cross,position", [(3, "int8", 0),
                                                 (5, "int4", 33)])
def test_decode_step_beams_kernel_rounds_ties_half_to_even(gen, tiny_quant,
                                                           rows, cross,
                                                           position):
    arch, params = tiny_quant
    cache = testing.random_step_cache(arch, rows, cross, 96, position, gen,
                                      shared_cross=True)
    x0 = torch.randn((rows, arch.d_model), generator=gen, device="cuda")
    assert testing.tie_column_error(params, arch, x0, position, cache,
                                    beams=True) == 0


@pytest.mark.parametrize("seconds,quantize,kw", [
    (12.0, False, dict(num_beams=4)),
    (12.0, False, dict(prompt="hello world")),
    (5.0, "serving", dict(num_beams=4))])
def test_tiny_beam_and_prompt_slices_on_card(gen, tmp_path, seconds, quantize,
                                             kw):
    """Beam search (4 beams) and a text prompt with conditioning on the
    card give the CPU's tokens and words; one serving window with 4 beams
    runs the beams mode with token agreement with the CPU of at least 0.9
    (the kernel and its plain version agree within bands, not bit for
    bit)."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    audio = testing.tone_audio(seconds, 0)
    cpu = testing.tiny_slice(ckpt, params, "cpu", audio, quantize, **kw)
    before = whole_step.mode_launches["beams"]
    gpu = testing.tiny_slice(ckpt, params, "cuda", audio, quantize, **kw)
    if quantize:
        assert whole_step.mode_launches["beams"] > before
        assert testing.token_agreement(cpu[1], gpu[1]) >= 0.9
    else:
        assert testing.slice_timestamp_gap(cpu, gpu) <= testing.TS_BAND


# --- the remaining entry points: fused log-mel, decode attention, probe


@pytest.mark.parametrize("n_mels,seconds,batch", [(128, 30, 4), (80, 30, 1),
                                                  (80, 5, 3)])
def test_log_mel_kernel_matches_plain_and_stft(gen, n_mels, seconds, batch):
    """A tone in noise, an all-zero window (exactly -1.5 after the clip)
    and a clip cut short by zeros: within MEL_BAND of the plain twin and
    of extract_features, one launch a call."""
    import numpy as np
    from crisperwhisper_tpu_torch.audio.fused_mel import fused_log_mel
    from crisperwhisper_tpu_torch.config import FeatureConfig
    cfg = FeatureConfig(feature_size=n_mels, chunk_length=seconds)
    audio = np.zeros((batch, cfg.n_samples), np.float32)
    audio[0] = testing.tone_audio(seconds, 0)
    if batch > 1:
        cut = int(1.7 * testing.SR)
        audio[-1, :cut] = testing.tone_audio(1.7, 1)[:cut]
    before = fused_log_mel.launches
    errs, got = testing.mel_errors(torch.from_numpy(audio).cuda(), cfg)
    assert fused_log_mel.launches == before + 1
    assert got.shape == (batch, n_mels, cfg.nb_max_frames)
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    if batch > 2:
        assert bool((got[1] == -1.5).all())


def test_log_mel_kernel_rejects_what_it_does_not_take(gen):
    """A window of another length raises; an f64 or a transposed waveform
    is cast and copied, and gives the features of its contiguous f32
    copy."""
    from crisperwhisper_tpu_torch.audio.fused_mel import fused_log_mel
    from crisperwhisper_tpu_torch.config import FeatureConfig
    cfg = FeatureConfig(chunk_length=5)
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros((1, cfg.n_samples - 1), device="cuda"),
                      cfg)
    wave = torch.from_numpy(testing.tone_audio(5, 3)[None]).cuda()
    want = fused_log_mel(wave, cfg)
    assert torch.equal(fused_log_mel(wave.double(), cfg), want)
    assert torch.equal(fused_log_mel(wave.T.contiguous().T, cfg), want)


def test_log_mel_kernel_takes_any_waveform_layout_and_dtype(gen):
    """A bf16 waveform, a strided view, a view whose data does not start
    on 16 bytes and ``dtype=torch.bfloat16``: each runs the kernel (one
    count a call) on a cast copy, within MEL_BAND of the plain twin on
    the same input (a bf16 out within one bf16 epsilon more)."""
    from crisperwhisper_tpu_torch.audio.fused_mel import (fused_log_mel,
                                                          log_mel_plain)
    from crisperwhisper_tpu_torch.config import FeatureConfig
    cfg = FeatureConfig(feature_size=128)
    audio = torch.from_numpy(__import__("numpy").stack(
        [testing.tone_audio(30, s) for s in (4, 5)])).cuda()
    wide = torch.zeros((2, 2 * cfg.n_samples), device="cuda")
    wide[:, ::2] = audio
    flat = torch.zeros(2 * cfg.n_samples + 1, device="cuda")
    flat[1:] = audio.reshape(-1)
    offset = flat[1:].view(2, cfg.n_samples)
    assert offset.data_ptr() % 16 and not wide[:, ::2].is_contiguous()
    for wave in (audio.bfloat16(), wide[:, ::2], offset):
        before = fused_log_mel.launches
        errs, got = testing.mel_errors(wave, cfg)
        assert fused_log_mel.launches == before + 1
        assert got.dtype == torch.float32
        for name, (err, band) in errs.items():
            assert err <= band, (wave.dtype, name, err, band)
    got = fused_log_mel(audio, cfg, dtype=torch.bfloat16)
    ref = log_mel_plain(audio, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    eps = torch.finfo(torch.bfloat16).eps * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= testing.MEL_BAND + eps


@pytest.mark.parametrize("b,h,t,q_dtype", [
    (16, 20, 1500, torch.bfloat16), (16, 20, 1500, torch.float32),
    (2, 4, 40, torch.float32), (3, 5, 1, torch.bfloat16)])
@pytest.mark.parametrize("v2", [False, True])
def test_cross_attention_kernels_match_plain(gen, b, h, t, q_dtype, v2):
    """v1 and v2 at the decoder's cross width and at small shapes: out and
    all probabilities within testing's bands, one launch a call."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = testing.decode_attention_inputs((b, h, t, 64), "int8",
                                                      gen, q_dtype)
    fn = da.cross_attention_int8_v2 if v2 else da.cross_attention_int8
    before = fn.launches
    errs = testing.cross_attention_errors(q[:, :, None], k, ks[..., None], v,
                                          vs[..., None], v2)
    assert fn.launches == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


def test_cross_attention_kernels_keep_their_q_rounding(gen):
    """With an f32 q the two entries differ by more than the band (v2
    rounds q to bf16 first)."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = testing.decode_attention_inputs((4, 20, 1500, 64),
                                                      "int8", gen,
                                                      torch.float32)
    args = (q[:, :, None], k, ks[..., None], v, vs[..., None])
    o1, _ = da.cross_attention_int8(*args)
    o2, _ = da.cross_attention_int8_v2(*args)
    assert (o1 - o2).abs().max() > testing.DA_OUT_REL_BAND * o1.abs().max()


_GEMV = {   # name: (cache, q dtype, [L, B, H, T], scales, position, mask, sel)
    "microbench-int8": ("int8", torch.bfloat16, (2, 64, 20, 1536), True,
                        None, False, True),
    "microbench-int4": ("int4", torch.bfloat16, (2, 64, 20, 1536), True,
                        None, False, True),
    "microbench-bf16": ("bf16", torch.bfloat16, (2, 64, 20, 1536), False,
                        None, False, True),
    "int8-f32-all": ("int8", torch.float32, (2, 3, 4, 48), True, 30, True,
                     True),
    "int4-f32-position-past-T": ("int4", torch.float32, (2, 3, 4, 48), True,
                                 100, True, False),
    "bf16-f32-position-before-0": ("bf16", torch.float32, (2, 3, 4, 48),
                                   False, -1, False, True),
    "f32-bf16-ring": ("f32", torch.bfloat16, (3, 3, 4, 448), False, 60, True,
                      True),
    "f32-f32-one-key": ("f32", torch.float32, (1, 2, 3, 1), False, None,
                        False, False),
}


@pytest.mark.parametrize("case", list(_GEMV))
def test_decode_gemv_kernel_matches_plain(gen, case):
    """Every cache kind and q dtype, with and without each option, at the
    microbench's shape of the reference (experiments/decode_gemv_v3.py
    :274) and small; the key mask masks every key of row 1, which is then
    uniform over T; sel [H, 15] one-hot with columns no head selects."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    kind, q_dtype, (n, b, h, t), scales, position, mask, sel = _GEMV[case]
    q, k, ks, v, vs = testing.decode_attention_inputs((n, b, h, t, 64), kind,
                                                      gen, q_dtype)
    kw = dict(k_scale=ks, v_scale=vs) if scales else {}
    if position is not None:
        kw["position"] = position
    if mask:
        m = torch.rand((b, t), generator=gen, device="cuda") > 0.3
        m[1] = False
        kw["key_mask"] = m
    if sel:
        s = torch.zeros((h, 15), device="cuda")
        for a in range(0, 15, 2):
            s[a % h, a] = 1.0
        kw["sel"] = s
    before = da.decode_gemv_attention.launches
    errs = testing.decode_gemv_errors(q, k, v, n - 1, **kw)
    assert da.decode_gemv_attention.launches == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    if mask and sel:
        _, aligned = da.decode_gemv_attention(q, k, v, n - 1, **kw)
        assert torch.allclose(aligned[1, ::2], torch.full_like(
            aligned[1, ::2], 1.0 / t), rtol=0, atol=testing.DA_PROBS_BAND)
        assert not bool(aligned[:, 1::2].any())


def test_decode_gemv_kernel_sums_heads_sharing_a_sel_column(gen):
    """A sel column with two heads (weights 1 and 0.5) gets their weighted
    sum, as the plain twin does; the other columns as before."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = testing.decode_attention_inputs((2, 4, 20, 448, 64),
                                                      "int8", gen)
    s = torch.zeros((20, 3), device="cuda")
    s[0, 0], s[7, 0], s[3, 2] = 1.0, 0.5, 1.0
    errs = testing.decode_gemv_errors(q, k, v, 1, k_scale=ks, v_scale=vs,
                                      sel=s)
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    _, aligned = da.decode_gemv_attention(q, k, v, 1, k_scale=ks,
                                          v_scale=vs, sel=s)
    assert not bool(aligned[:, 1].any())


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_log_mel_kernel_on_silence_and_a_click(gen, n_mels, batch):
    """The FFT kernel at 30 s on windows that reach the clamp and the
    clip: all zeros (the 1e-10 clamp: exactly -1.5 after the clip), one
    loud click in zeros (flat spectra in its frames, -10 elsewhere: the
    max-8 clip holds 8 decades), and a tone in noise; within MEL_BAND of
    the plain twin and of extract_features, one count a call."""
    import numpy as np
    from crisperwhisper_tpu_torch.audio.fused_mel import fused_log_mel
    from crisperwhisper_tpu_torch.config import FeatureConfig
    cfg = FeatureConfig(feature_size=n_mels)
    rng = np.random.default_rng(batch)
    audio = np.zeros((batch, cfg.n_samples), np.float32)
    for i in range(batch):
        if i % 3 == 1:
            audio[i, rng.integers(0, cfg.n_samples)] = 4.0      # a click
        elif i % 3 == 2:
            audio[i] = testing.tone_audio(30, int(rng.integers(100)))
    if batch == 1:
        audio[0, cfg.n_samples // 3] = 4.0
    before = fused_log_mel.launches
    errs, got = testing.mel_errors(torch.from_numpy(audio).cuda(), cfg)
    assert fused_log_mel.launches == before + 1
    assert got.shape == (batch, n_mels, cfg.nb_max_frames)
    assert bool(torch.isfinite(got).all())
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    for i in range(0, batch, 3):
        if batch > 1:
            assert bool((got[i] == -1.5).all())
    for i in range(1 if batch > 1 else 0, batch, 3):
        peak = float(got[i].max())
        assert peak - 2.0 > -1.5                    # the clip binds
        assert float(got[i].min()) == pytest.approx(peak - 2.0, abs=1e-6)


def test_log_mel_kernel_stamps_split_its_two_launches(gen):
    """The stamps of one call: the FFT launch and the clip launch both
    take time on the device and add up to the call's span; the features
    are those of a call without stamps, bit for bit; bad stamps and a
    shape the kernel does not take raise."""
    import dataclasses
    from crisperwhisper_tpu_torch.audio.fused_mel import fused_log_mel
    from crisperwhisper_tpu_torch.config import FeatureConfig
    cfg = FeatureConfig(feature_size=80, chunk_length=5)
    wave = torch.from_numpy(testing.tone_audio(5, 2)[None]).cuda()
    total, fft, clip = testing.log_mel_phases(wave, cfg)
    assert fft > 0 and clip > 0
    assert total == pytest.approx(fft + clip, abs=1e-9)
    stamps = torch.tensor([-1, 0, 0], dtype=torch.int64, device="cuda")
    assert torch.equal(fused_log_mel(wave, cfg, stamps=stamps),
                       fused_log_mel(wave, cfg))
    with pytest.raises(ValueError, match="stamps"):
        fused_log_mel(wave, cfg, stamps=stamps.int())
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = dataclasses.replace(cfg, feature_size=81, hop_length=3200)
        fused_log_mel(torch.zeros((1, odd.n_samples), device="cuda"), odd)


_CROSS_KEYS = [(2, 3, 1), (2, 3, 31), (4, 20, 1500), (16, 20, 1536),
               (1, 2, 8192), (8, 20, 8192)]


@pytest.mark.parametrize("b,h,t", _CROSS_KEYS)
@pytest.mark.parametrize("v2", [False, True])
def test_cross_attention_kernels_split_keys_over_the_cluster(gen, b, h, t,
                                                            v2):
    """v1 and v2 at key counts the cluster does not divide evenly (T = 1
    leaves blocks empty; slices at 8192 stream through the slots) and at
    rows x heads below (6, 80 pairs) and above (320, 160 pairs x 8) the
    132 SMs, with a bf16 and an f32 q: out and all probabilities within
    the bands."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    own = torch.Generator(device="cuda").manual_seed(b * 7919 + t)
    for q_dtype in (torch.float32, torch.bfloat16):
        q, k, ks, v, vs = testing.decode_attention_inputs((b, h, t, 64),
                                                          "int8", own, q_dtype)
        fn = da.cross_attention_int8_v2 if v2 else da.cross_attention_int8
        before = fn.launches
        errs = testing.cross_attention_errors(q[:, :, None], k,
                                              ks[..., None], v,
                                              vs[..., None], v2)
        assert fn.launches == before + 1
        for name, (err, band) in errs.items():
            assert err <= band, (name, q_dtype, err, band)


_SPLIT = {  # name: (cache, q dtype, [L, B, H, T], position)
    "int8-T1": ("int8", torch.bfloat16, (2, 2, 3, 1), None),
    "int4-T31-position-0": ("int4", torch.float32, (2, 2, 3, 31), 0),
    "bf16-T1500": ("bf16", torch.bfloat16, (2, 4, 20, 1500), 700),
    "f32-T1536-bf16-q": ("f32", torch.bfloat16, (2, 3, 5, 1536), None),
    "int8-T8192": ("int8", torch.float32, (1, 2, 3, 8192), 5000),
    "int4-T8192": ("int4", torch.bfloat16, (1, 2, 3, 8192), None),
    "bf16-T8192-streamed": ("bf16", torch.float32, (1, 2, 3, 8192), 8191),
    "f32-T8192-streamed": ("f32", torch.float32, (1, 2, 3, 8192), None),
    "int8-above-132-pairs": ("int8", torch.bfloat16, (2, 16, 20, 1536), 900),
    "f32-above-132-pairs": ("f32", torch.float32, (2, 8, 20, 448), 60),
}


@pytest.mark.parametrize("case", list(_SPLIT))
def test_decode_gemv_kernel_splits_keys_over_the_cluster(gen, case):
    """v3 for every cache kind at T = 1, 31, 1500, 1536 and 8192 (the
    int8, bf16 and f32 slices at 8192 stream through the K/V slots),
    rows x heads below and above 132, with scales, a position (0 where
    given so: key 0 alone), a key mask that masks every key of row 1 (its
    probabilities uniform) and a sel whose column 0 two heads share
    (weights 1 and 0.5): out and the aligned rows within the bands."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    kind, q_dtype, (n, b, h, t), position = _SPLIT[case]
    own = torch.Generator(device="cuda").manual_seed(list(_SPLIT).index(case))
    q, k, ks, v, vs = testing.decode_attention_inputs((n, b, h, t, 64), kind,
                                                      own, q_dtype)
    kw = {} if kind in ("bf16", "f32") else dict(k_scale=ks, v_scale=vs)
    if position is not None:
        kw["position"] = position
    m = torch.rand((b, t), generator=own, device="cuda") > 0.2
    m[:, 0] = True
    m[1] = False
    s = torch.zeros((h, 4), device="cuda")
    s[0, 0], s[h - 1, 0], s[1 % h, 2], s[2 % h, 3] = 1.0, 0.5, 1.0, 1.0
    before = da.decode_gemv_attention.launches
    errs = testing.decode_gemv_errors(q, k, v, n - 1, key_mask=m, sel=s, **kw)
    assert da.decode_gemv_attention.launches == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)
    _, aligned = da.decode_gemv_attention(q, k, v, n - 1, key_mask=m, sel=s,
                                          **kw)
    assert not bool(aligned[:, 1].any())
    assert torch.allclose(aligned[1, 2], torch.full_like(
        aligned[1, 2], 1.0 / t), rtol=0, atol=testing.DA_PROBS_BAND)
    if position == 0:
        assert torch.equal(aligned[0, 2], torch.nn.functional.one_hot(
            torch.tensor(0), t).float().cuda())


def test_decode_attention_kernels_reject_what_they_do_not_take(gen):
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = testing.decode_attention_inputs((2, 2, 4, 40, 64),
                                                      "int8", gen)
    with pytest.raises(ValueError):               # layer out of range
        da.decode_gemv_attention(q, k, v, 2)
    with pytest.raises(ValueError):               # one scale without other
        da.decode_gemv_attention(q, k, v, 0, k_scale=ks)
    strided = k.transpose(3, 4).contiguous().transpose(3, 4)
    assert torch.equal(da.decode_gemv_attention(q, strided, v, 0),
                       da.decode_gemv_attention(q, k, v, 0))
    with pytest.raises(ValueError):               # head dim 32
        da.decode_gemv_attention(q[..., :32].contiguous(),
                                 k[..., :32].contiguous(),
                                 v[..., :32].contiguous(), 0)
    with pytest.raises(ValueError):               # a bf16 cache for v1
        da.cross_attention_int8(q[:, :, None], k[0].bfloat16(),
                                ks[0, ..., None], v[0], vs[0, ..., None])
    with pytest.raises(ValueError, match="on cuda"):  # K on the host
        da.decode_gemv_attention(q, k.cpu(), v, 0)


def _offset(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in a view whose data starts one element past a
    16-byte boundary (a slice of a larger tensor)."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    out = flat[1:].view(x.shape)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernels_take_offset_and_strided_inputs(gen,
                                                                q_dtype):
    """An offset q (a slice of a larger tensor, not on 16 bytes) and K/V
    caches that are not contiguous, through each of the three entries:
    each runs its kernel once (on copies) and stays within the bands of
    its plain twin."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    q, k, ks, v, vs = testing.decode_attention_inputs((2, 4, 20, 1500, 64),
                                                      "int8", gen, q_dtype)

    def strided(x):
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)
    k_s, v_s = strided(k), strided(v)
    assert not k_s.is_contiguous() and not v_s.is_contiguous()
    for v2, fn in ((False, da.cross_attention_int8),
                   (True, da.cross_attention_int8_v2)):
        before = fn.launches
        errs = testing.cross_attention_errors(
            _offset(q[:, :, None]), k_s[1], ks[1, ..., None], v_s[1],
            vs[1, ..., None], v2)
        assert fn.launches == before + 1
        for name, (err, band) in errs.items():
            assert err <= band, (v2, name, err, band)
    sel = torch.zeros((20, 15), device="cuda")
    for a in range(15):
        sel[a % 20, a] = 1.0
    before = da.decode_gemv_attention.launches
    errs = testing.decode_gemv_errors(_offset(q), k_s, v_s, 1, k_scale=ks,
                                      v_scale=vs, sel=sel, position=900)
    assert da.decode_gemv_attention.launches == before + 1
    for name, (err, band) in errs.items():
        assert err <= band, (name, err, band)


def test_probe_ladder_on_card(gen, capsys):
    """Every rung passes: a bf16 matmul, the probe kernel (equal to x * 2
    bit for bit, one launch) and every CUDA source compiled alone."""
    from crisperwhisper_tpu_torch import _build, probe
    before = probe.probe_add.launches
    assert probe.main([]) == 0
    assert probe.probe_add.launches == before + 1
    out = capsys.readouterr().out
    for rung in ("plain", "probe_add", *_build.SOURCES):
        assert f"PROBE {rung}: OK" in out, out


@pytest.mark.parametrize("shape", [(1,), (255,), (257,), (3, 333),
                                   (8, 128), (5, 1000, 7)])
def test_probe_add_matches_x_times_two_at_any_size(gen, shape):
    """The probe kernel at sizes that are not a multiple of its 256-thread
    block (and at its own (8, 128) tile): x * 2 bit for bit, one launch a
    call."""
    from crisperwhisper_tpu_torch import probe
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(shape, generator=g, device="cuda")
    before = probe.probe_add.launches
    got = probe.probe_add(x)
    assert probe.probe_add.launches == before + 1
    assert got.shape == x.shape and torch.equal(got, x * 2.0)
    with pytest.raises(ValueError, match="non-empty contiguous float32"):
        probe.probe_add(x.double())
    assert probe.probe_add.launches == before + 1


def test_build_names_a_source_nvcc_refuses(gen, tmp_path):
    from crisperwhisper_tpu_torch import _build
    bad = tmp_path / "broken.cu"
    bad.write_text("__global__ void k() { undeclared = 1; }\n")
    with pytest.raises(RuntimeError, match=r"nvcc failed on broken\.cu"):
        _build.compile_object(bad, tmp_path / "broken.o")


def _short_form(ckpt: str, params, device: str, mel, num_frames):
    """The TINY f32 model on ``device``: generate_short_form of the log-mel
    batch ``mel`` with word timestamps, and ``forward`` over the
    sequences it returns -> (ShortFormOutput, logits on the CPU)."""
    from dataclasses import replace
    from crisperwhisper_tpu_torch.decoding import generate_short_form
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models import forward
    pipe = load_pipeline(ckpt, dtype=torch.float32, device=device,
                         params=testing.to_device(params, device))
    feats = torch.from_numpy(mel).to(device)
    out = generate_short_form(pipe.params, pipe.arch, pipe.specials,
                              replace(pipe.gen_opts, max_new_tokens=32),
                              feats, num_frames=num_frames)
    logits = forward(pipe.params, pipe.arch, feats,
                     torch.from_numpy(out.sequences).to(device))
    return out, logits.cpu()


def test_forward_and_short_form_on_card_match_cpu(gen, tmp_path):
    """The TINY f32 model (seeded init_params) on the card and on the CPU:
    generate_short_form launches the encoder-attention, align-prep and
    DTW kernels and gives the CPU's tokens, timestamps within one DTW
    frame, on full rows and a row cropped to 322 frames; forward over
    those sequences gives the CPU's top-1 token at every position."""
    import numpy as np
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    mel = np.random.default_rng(11).standard_normal((2, 80, 500)).astype(
        np.float32)
    for num_frames in (None, np.array([500, 322])):
        cpu, cpu_logits = _short_form(ckpt, params, "cpu", mel, num_frames)
        before = [w.launches for w in (fused_attention, align_prep, dtw)]
        gpu, gpu_logits = _short_form(ckpt, params, "cuda", mel, num_frames)
        after = [w.launches for w in (fused_attention, align_prep, dtw)]
        assert all(a > b for a, b in zip(after, before)), (before, after)
        np.testing.assert_array_equal(gpu.sequences, cpu.sequences)
        np.testing.assert_array_equal(gpu.num_generated, cpu.num_generated)
        assert np.abs(gpu.token_timestamps
                      - cpu.token_timestamps).max() <= testing.TS_BAND
        assert torch.equal(gpu_logits.argmax(-1), cpu_logits.argmax(-1))


def test_checkpoint_round_trips_onto_the_card(gen, tmp_path):
    """save_params -> load_saved_params(device="cuda") for a fused int8
    and a group-wise int4 tree, and save_hf_checkpoint -> load_params(
    device="cuda") for the plain one: every leaf on the card, bit-equal,
    with its dtype."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models import quantize as Q
    from crisperwhisper_tpu_torch.models.loader import (load_params,
                                                        save_hf_checkpoint)
    from crisperwhisper_tpu_torch.models.whisper import init_params
    from crisperwhisper_tpu_torch.utils.checkpoint import (load_saved_params,
                                                           save_params)
    arch = WhisperArch(**testing.TINY)
    params = testing.random_affine(
        init_params(arch, torch.Generator().manual_seed(0)), 1)
    for i, tree in enumerate((
            Q.quantize_decoder_weights(Q.fuse_decoder_qkv(params,
                                                          arch.head_dim)),
            Q.quantize_decoder_weights(params, bits=4))):
        save_params(str(tmp_path / f"p{i}"), tree, metadata={"i": i})
        back, meta = load_saved_params(str(tmp_path / f"p{i}"),
                                       device="cuda")
        assert meta == {"i": i}
        assert testing.tree_mismatch(tree, back, "cuda") == []
    save_hf_checkpoint(str(tmp_path / "hf"), params, arch)
    back, _ = load_params(str(tmp_path / "hf"), dtype=torch.float32,
                          device="cuda")
    assert testing.tree_mismatch(params, back, "cuda") == []


def _same_slice(ref: dict, got: dict, band: float) -> None:
    """Equal chunk tokens, text and words; word timestamps within band."""
    assert got["tokens"] == ref["tokens"]
    r, g = ref["direct"][0], got["direct"][0]
    assert g["chunks"] and g["text"] == r["text"]
    assert [c["text"] for c in g["chunks"]] == [c["text"]
                                                for c in r["chunks"]]
    assert max(abs(x - y) for a, b in zip(r["chunks"], g["chunks"])
               for x, y in zip(a["timestamp"], b["timestamp"])) <= band


def test_mesh_pipeline_of_one_nccl_rank_equals_unsharded(gen, tmp_path):
    """load_pipeline(mesh=) on a 1 x 1 mesh, a world of one over NCCL: the
    TINY f32 slice equal to the same slice off any mesh."""
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    (got,) = testing.run_world(
        1, "crisperwhisper_tpu_torch.testing:mesh_slice",
        {"ckpt": ckpt, "seconds": 12.0, "dtypes": ["float32"],
         "streams": 0}, backend="nccl", device="cuda", timeout=300)
    run = got["runs"]["float32"]
    _same_slice(testing.unsharded_slice(ckpt, 12.0, "float32"), run, 1e-4)
    assert run["launches"]["encoder_attention"] > 0
    assert run["launches"]["dtw"] > 0 and run["launches"]["align_prep"] > 0


def test_mesh_pipeline_two_ranks_on_card_matches_unsharded(gen, tmp_path):
    """Two ranks at model=2 (gloo on one card, NCCL on two): the TINY f32
    slice's tokens equal to the unsharded run's, each rank's encoder
    attention at 2 of the 4 heads and under 0.775 of the replicated
    parameter bytes, three streams through a StreamingBatcher on rank 0
    equal to the direct call, and prompt lookup on the mesh (the
    ring-write kernel on local-head rings) equal to its greedy result."""
    ckpt = testing.write_tiny_configs(str(tmp_path / "ckpt"))
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ranks = testing.run_world(
        2, "crisperwhisper_tpu_torch.testing:mesh_slice",
        {"ckpt": ckpt, "seconds": 12.0, "dtypes": ["float32"],
         "streams": 3, "assistants": ["prompt_lookup"]}, backend=backend,
        device="cuda", timeout=300)
    run = ranks[0]["runs"]["float32"]
    _same_slice(testing.unsharded_slice(ckpt, 12.0, "float32"), run,
                testing.TS_BAND)
    for r in ranks:
        assert r["runs"]["float32"]["heads"] == [2]
        assert r["runs"]["float32"]["param_share"] < 0.55 + 0.45 / 2
        assert r["assistants"]["prompt_lookup"]["launches"]["ring_write"] > 0
    direct = run["direct"][0]
    assert len(run["streams"]) == 3
    for s in run["streams"]:
        assert testing.result_gap(direct, s) <= testing.TS_BAND
    _same_slice(run, ranks[0]["assistants"]["prompt_lookup"],
                testing.TS_BAND)


def test_one_token_step_routes_through_kernel_9(gen, monkeypatch):
    """At the bulk cell's shapes (64 rows, 20 heads, 1500 encoder frames,
    bf16, large-v3 width; four decoder layers, alignment heads on layers 1
    and 3, a ring of 100 at position 60): one decode_step, which takes
    kernel 9 for both attentions of every layer, against the same step on
    the plain path (bind_decode_gemv declining). Logits within a bf16 band
    of the plain step's; each aligned row within f32 rounding of the
    softmax that the plain path computes from the routed step's own cross
    query; two launches a layer; and no host-to-device copy inside the
    step, where the plain path makes some (its alignment rows' list
    indices). A generator of its own keeps the module's draws as they
    were."""
    from dataclasses import replace
    from torch.profiler import ProfilerActivity, profile
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models import whisper as W
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    own = torch.Generator(device="cuda").manual_seed(17)
    arch = replace(WhisperArch.large_v3(), encoder_layers=1, decoder_layers=4)
    params = testing.random_affine(
        W.init_params(arch, own, "cuda", torch.bfloat16), 17)
    enc = torch.randn((64, 1500, arch.d_model), generator=own,
                      device="cuda").to(torch.bfloat16)
    cache = W.init_cache(params, arch, enc, cache_len=100)
    with torch.inference_mode():
        for ring in (cache.self_k, cache.self_v):
            ring.copy_(torch.randn(ring.shape, generator=own, device="cuda"))
    heads = ((1, 3), (1, 7), (3, 0))
    sel = W.alignment_selector(arch, heads)
    tokens = torch.randint(0, arch.vocab_size, (64,), generator=own,
                           device="cuda")

    def step(c):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = W.decode_step(params, arch, tokens, 60, c, align_sel=sel)
            torch.cuda.synchronize()
        return out, sum("HtoD" in e.name for e in prof.events())

    # the first step builds the kernels and the selector's device tensors
    W.decode_step(params, arch, tokens, 60, testing.clone_cache(cache),
                  align_sel=sel)
    routed, plain = testing.clone_cache(cache), testing.clone_cache(cache)
    queries, bind = {}, W.bind_decode_gemv

    def spy_bind(dtype, k_stack, *a, **kw):
        attend = bind(dtype, k_stack, *a, **kw)
        if k_stack is not routed.cross_k:
            return attend

        def spy(q, layer, *a2, **kw2):
            queries[layer] = q
            return attend(q, layer, *a2, **kw2)
        return spy
    monkeypatch.setattr(W, "bind_decode_gemv", spy_bind)
    before = da.decode_gemv_attention.launches
    (logits, _, aligned), h2d = step(routed)
    assert da.decode_gemv_attention.launches == before + 2 * 4
    assert h2d == 0
    monkeypatch.setattr(W, "bind_decode_gemv", lambda *a, **kw: None)
    (ref_logits, _, _), ref_h2d = step(plain)
    assert da.decode_gemv_attention.launches == before + 2 * 4
    assert ref_h2d > 0                  # the profiler sees such copies
    def rel_gap(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
    for name in ("self_k", "self_v"):
        a, b = getattr(routed, name), getattr(plain, name)
        # the other slots as they were; layer 0's fresh column comes before
        # any attention, the later layers' from activations a bf16 rounding
        # apart where the two attentions sum in other orders
        assert torch.equal(a[:, :, :, :60], b[:, :, :, :60])
        assert torch.equal(a[:, :, :, 61:], b[:, :, :, 61:])
        assert torch.equal(a[0, :, :, 60], b[0, :, :, 60])
        assert rel_gap(a[1:, :, :, 60], b[1:, :, :, 60]) <= 2 ** -6, name
    gap = rel_gap(logits, ref_logits)
    assert gap <= 2 ** -6, gap
    for slot, (layer, head) in enumerate(heads):
        scores = queries[layer][:, head, None, :].float() \
            @ cache.cross_k[layer][:, head].float().transpose(-1, -2)
        want = torch.softmax(scores[:, 0], dim=-1)
        err = (aligned[:, slot] - want).abs().max().item()
        assert err <= testing.DA_PROBS_BAND, (slot, err)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_decode_gemv_kernel_reads_its_position_on_the_device(gen, kind):
    """Kernel 9 bound to a ring of 100 (layer 1 of 2, 16 rows, 20 heads,
    a one-hot sel) at a 0-d int32 position on the device: the bytes of
    the integer form at positions -1, 0, 61 and T - 1; then the launch
    captured once in a CUDA graph, the position moved in place before
    each replay, and the same bytes again."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    own = torch.Generator(device="cuda").manual_seed(31)
    t = 100
    q, k, ks, v, vs = testing.decode_attention_inputs((2, 16, 20, t, 64),
                                                      kind, own)
    if kind == "bf16":
        ks = vs = None
    sel = torch.zeros((20, 3), device="cuda")
    sel[4, 0], sel[9, 1], sel[17, 2] = 1.0, 1.0, 1.0
    attend = da.bind_decode_gemv(torch.bfloat16, k, v, ks, vs)
    at = torch.zeros((), dtype=torch.int32, device="cuda")
    positions = (-1, 0, 61, t - 1)
    wants = [attend(q, 1, pos, sel) for pos in positions]
    before = da.decode_gemv_attention.launches
    for pos, want in zip(positions, wants):
        at.fill_(pos)
        got = attend(q, 1, at, sel)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), pos
    assert da.decode_gemv_attention.launches == before + len(positions)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attend(q, 1, at, sel)
    for pos, want in reversed(list(zip(positions, wants))):
        at.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, want)), pos
    with pytest.raises(ValueError, match="0-d int32"):
        attend(q, 1, at.long(), sel)


# (width, rows, quantize="serving"'s weights and caches)
_GRAPHED = {"tiny-b16-bf16": ("tiny", 16, False),
            "tiny-b64-bf16": ("tiny", 64, False),
            "tiny-b16-serving": ("tiny", 16, True),
            "large-v3-b16-bf16": ("large-v3", 16, False),
            "large-v3-b64-bf16": ("large-v3", 64, False),
            "large-v3-b16-serving": ("large-v3", 16, True)}


@pytest.mark.parametrize("case", list(_GRAPHED))
def test_greedy_decode_replays_one_graph_equal_to_the_eager_loop(
        gen, monkeypatch, case):
    """greedy_decode with its step captured as one CUDA graph against the
    same decode with the gate closed (today's eager step at an int
    position): the same tokens, and sum_logprobs, no-speech probabilities,
    alignment rows and the final cache equal bit for bit (the graph holds
    the eager step's kernels in their order; the ring write and kernel 9
    read the position on the device). bf16 weights and caches, or int8
    weights with an int4 cross cache and an int8 ring; TINY widths with
    one head, and large-v3 widths with four decoder layers; a three-token
    prompt,
    alignment heads, eot suppressed so every row runs all 24 steps. The
    step records: the first eager, every later one a replay, one capture;
    the device trace (torch.profiler) holds kernel 9 as often as the
    eager loop launches it, and the ring write once a layer a step."""
    from dataclasses import replace
    from crisperwhisper_tpu_torch.config import (GenerationOptions,
                                                 SpecialTokens, WhisperArch)
    from crisperwhisper_tpu_torch.decoding import greedy
    from crisperwhisper_tpu_torch.models import whisper as W
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    from crisperwhisper_tpu_torch.utils import tracing
    width, rows, serving = _GRAPHED[case]
    own = torch.Generator(device="cuda").manual_seed(29)
    if width == "tiny":
        # one head of 64 (kernel 9's head dim; TINY's four heads of 16
        # keep the eager step on the card)
        arch = replace(WhisperArch(**testing.TINY),
                       encoder_attention_heads=1, decoder_attention_heads=1)
        specials, heads = testing.TINY_SPECIALS, [(0, 0), (1, 0)]
    else:
        arch = replace(WhisperArch.large_v3(), encoder_layers=1,
                       decoder_layers=4)
        specials, heads = SpecialTokens(), testing.large_v3_align_heads(arch)
    params = testing.random_affine(
        W.init_params(arch, own, "cuda", torch.bfloat16), 29)
    if serving:
        params = testing.quantized_decoder(params, arch)
    enc = torch.randn((rows, arch.max_source_positions, arch.d_model),
                      generator=own, device="cuda").to(torch.bfloat16)
    prompt = torch.tensor([[specials.sot, specials.language_begin,
                            specials.transcribe]] * rows)
    suppress = torch.zeros(arch.vocab_size, dtype=torch.bool, device="cuda")
    suppress[specials.eot] = True
    n_new, n_layers = 24, arch.decoder_layers

    def decode(graphed: bool):
        caches = []
        with monkeypatch.context() as m:
            init = greedy.init_cache
            m.setattr(greedy, "init_cache", lambda *a, **kw: caches.append(
                init(*a, **kw)) or caches[-1])
            if not graphed:
                m.setattr(greedy, "step_graph_refusal", lambda *a: "off")
            before = (da.decode_gemv_attention.launches,
                      rw.write_block_columns_group.launches)
            cuda = torch.profiler.ProfilerActivity.CUDA
            with torch.profiler.profile(activities=[cuda]) as prof, \
                    tracing.recording() as recs:
                res = greedy.greedy_decode(
                    params, arch, specials, GenerationOptions(), enc, prompt,
                    max_new_tokens=n_new, suppress_mask=suppress,
                    align_sel=W.alignment_selector(arch, heads),
                    return_timestamps=False,
                    cross_cache_dtype="int4" if serving else None,
                    self_cache_dtype="int8" if serving else None)
                torch.cuda.synchronize()
            calls = (da.decode_gemv_attention.launches - before[0],
                     rw.write_block_columns_group.launches - before[1])
        ran = testing.device_kernel_counts(prof, testing.STEP_KERNELS)
        steps = [r.counts["graph"] for r in recs
                 if r.name == "cw.decode.step"]
        captures = sum(r.name == "cw.decode.capture" for r in recs)
        return (res, caches[0], steps, captures, calls,
                (ran["decode_gemv_attention"], ran["ring_write"]))

    eager, eager_cache, eager_steps, eager_captures, eager_n, eager_ran = \
        decode(False)
    res, cache, steps, captures, calls, ran = decode(True)
    assert res.steps == eager.steps == n_new
    assert eager_steps == [0] * n_new and eager_captures == 0
    assert steps == [0] + [1] * (n_new - 1) and captures == 1
    # the eager loop: a launch a call, the ring written by a slice
    assert eager_n == eager_ran == (2 * n_layers * n_new, 0)
    # graphed: the wrappers are called at the warm-up step and once more
    # in the capture; the device runs the kernels at every step
    assert calls == (2 * n_layers * 2, n_layers * 2)
    assert ran == (2 * n_layers * n_new, n_layers * n_new)
    assert torch.equal(res.sequences, eager.sequences)
    for name in ("num_generated", "sum_logprobs", "no_speech_probs",
                 "align_probs"):
        assert torch.equal(getattr(res, name), getattr(eager, name)), name
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale",
                 "cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
        a, b = getattr(cache, name), getattr(eager_cache, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(
            a, b)), name


@pytest.mark.parametrize("rows", [64, 4096])
def test_grouped_expert_kernel_matches_plain(gen, rows):
    """One layer of Uni-MoE-2.0-Omni's routed experts at published widths
    (4 experts of 18944 over 3584, a null expert, top-p 0.7 capped at
    2): the kernel against the plain path on the same routing; the null
    expert's rows never reach either."""
    from crisperwhisper_tpu_torch.ops import moe
    d, f, e = 3584, 18944, 4
    g = torch.Generator(device="cuda").manual_seed(rows)

    def draw(*shape, std):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(
            torch.bfloat16)

    experts = {"gate": draw(e, f, d, std=d ** -0.5),
               "up": draw(e, f, d, std=d ** -0.5),
               "down": draw(e, d, f, std=f ** -0.5)}
    x = draw(rows, d, std=1.0)
    router = torch.randn((e + 1, d), generator=g, device="cuda") * 2 / d ** .5
    r = moe.route(x, router, e, 0.7, 2)
    assert r.kept[:, e].any() and (r.kept.sum(-1) == 1).any()
    token, weight, offsets = moe.expert_pairs(r, e)
    assert int(offsets[-1]) == int(r.kept[:, :e].sum())
    before = moe.grouped_swiglu.launches
    got = moe.routed_experts(x, r, experts, e)
    torch.cuda.synchronize()
    assert moe.grouped_swiglu.launches == before + 2
    want = moe._plain(x, token, weight, offsets, experts)
    gap = ((got - want).abs().max() / want.abs().max()).item()
    assert gap <= testing.MOE_BAND, gap
