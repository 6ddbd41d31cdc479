"""PyTorch port, kernels 2 and 3: alignment prep (ops/align_prep.py) and
DTW (ops/dtw.py), with the plain chain (ops/alignment.py), against the
JAX package: its Pallas kernels interpreted and its XLA chain."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def cases():
    """Seeded inputs: attention stacks with full and cropped rows, and
    masked DTW cost matrices."""
    rng = np.random.default_rng(4)
    b, a, t, m = 3, 3, 25, 256
    w = np.exp(rng.standard_normal((b, a, t, m))).astype(np.float32)
    nt = np.array([25, 17, 0], np.int32)
    nf = np.array([256, 256, 130], np.int32)
    bd, n, md = 3, 25, 90
    mat = rng.standard_normal((bd, n, md)).astype(np.float32)
    dnt = np.array([25, 20, 10], np.int32)
    dnf = np.array([90, 70, 50], np.int32)
    for i in range(bd):
        mat[i, dnt[i]:, :] = 1e9
        mat[i, :, dnf[i]:] = 1e9
    return {"w": w, "nt": nt, "nf": nf, "mat": mat, "dnt": dnt, "dnf": dnf}


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


@pytest.mark.parametrize("length", [None, 256, 130, 2])
def test_median_filter_matches_jax(cases, length):
    from crisperwhisper_tpu.ops.alignment import median_filter as jmed
    from crisperwhisper_tpu_torch.ops.alignment import median_filter
    x = cases["w"][0]
    ref = np.asarray(jmed(jnp.asarray(x), 7, length))
    got = median_filter(torch.from_numpy(x), 7, length).numpy()
    np.testing.assert_array_equal(got, ref)     # order statistic: exact


def test_znorm_tokens_matches_jax(cases):
    from crisperwhisper_tpu.ops.alignment import znorm_tokens as jz
    from crisperwhisper_tpu_torch.ops.alignment import znorm_tokens
    x = cases["w"][1]
    mask = np.arange(x.shape[1])[None, :] < np.full((x.shape[0], 1), 17)
    # f32 sums in another order: a few ulps of the normalized values
    np.testing.assert_allclose(
        znorm_tokens(*_t(x, mask)).numpy(),
        np.asarray(jz(jnp.asarray(x), jnp.asarray(mask))), atol=1e-5)
    np.testing.assert_allclose(znorm_tokens(torch.from_numpy(x)).numpy(),
                               np.asarray(jz(jnp.asarray(x))), atol=1e-5)


def test_dtw_matches_jax_kernel_and_scan_exactly(cases):
    from crisperwhisper_tpu.ops.alignment import dtw_jump_times as jdtw
    from crisperwhisper_tpu.ops.pallas_dtw import pallas_dtw_jump_times
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    mat, nt, nf = cases["mat"], cases["dnt"], cases["dnf"]
    ref_kernel = np.asarray(pallas_dtw_jump_times(
        jnp.asarray(mat), jnp.asarray(nt), jnp.asarray(nf), interpret=True))
    ref_scan = np.stack([np.asarray(jdtw(jnp.asarray(mat[i]), int(nt[i]),
                                         int(nf[i])))
                         for i in range(len(mat))])
    before = dtw.launches
    got = dtw(*_t(mat, nt, nf)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_kernel)         # exact
    np.testing.assert_array_equal(got, ref_scan)
    assert dtw.launches == before                  # CPU: the plain version


def test_align_prep_full_rows_match_jax_kernel(cases):
    from crisperwhisper_tpu.ops.pallas_align import fused_align_prep
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    w, nt = cases["w"][:2], cases["nt"][:2]
    nf = np.full((2,), w.shape[-1], np.int32)
    ref = np.asarray(fused_align_prep(jnp.asarray(w), jnp.asarray(nt), 7,
                                      interpret=True))
    before = align_prep.launches
    got = align_prep(*_t(w, nt, nf), 7).numpy()
    for i in range(2):
        # band of the reference's kernel test (test_pallas_kernels.py:107)
        np.testing.assert_allclose(got[i][:nt[i]], ref[i][:nt[i]],
                                   atol=1e-5)
    assert align_prep.launches == before


def test_align_prep_cropped_rows_match_jax_xla_chain(cases):
    from crisperwhisper_tpu.ops.alignment import median_filter, znorm_tokens
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    w, nt, nf = cases["w"], cases["nt"], cases["nf"]
    got = align_prep(*_t(w, nt, nf), 7).numpy()
    t, m = w.shape[2], w.shape[3]
    for i in range(len(w)):
        fmask = np.arange(m) < nf[i]
        tmask = np.arange(t) < nt[i]
        wi = jnp.where(jnp.asarray(fmask)[None, None, :], jnp.asarray(w[i]),
                       0.0)
        z = znorm_tokens(wi, jnp.broadcast_to(jnp.asarray(tmask),
                                              (w.shape[1], t)))
        ref = np.asarray(-jnp.mean(median_filter(z, 7, int(nf[i])), axis=0))
        live = tmask[:, None] & fmask[None, :]
        np.testing.assert_allclose(got[i][live], ref[live], atol=1e-5)


def test_attention_to_jump_times_matches_jax(cases):
    """The whole alignment pass, mixed full and cropped rows in one batch,
    equals the JAX XLA chain exactly (frame indices)."""
    from crisperwhisper_tpu.ops.alignment import attention_to_jump_times as j
    from crisperwhisper_tpu_torch.ops.alignment import attention_to_jump_times
    w, nt, nf = cases["w"], cases["nt"], cases["nf"]
    ref = np.asarray(j(jnp.asarray(w), 7, jnp.asarray(nt), jnp.asarray(nf)))
    got = attention_to_jump_times(*_t(w), 7, *_t(nt, nf)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wrapper", ["align_prep", "dtw"])
def test_wrappers_reject_unsupported_device(cases, wrapper):
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep
    from crisperwhisper_tpu_torch.ops.dtw import dtw
    with pytest.raises(ValueError):
        if wrapper == "align_prep":
            align_prep(*(x.to("meta") for x in _t(cases["w"], cases["nt"],
                                                  cases["nf"])))
        else:
            dtw(*(x.to("meta") for x in _t(cases["mat"], cases["dnt"],
                                           cases["dnf"])))


@pytest.mark.parametrize("width", [1, 3, 5, 9])
def test_align_prep_plain_any_width_matches_jax(cases, width):
    """Median widths other than 7 (the reference app runs 3): full rows
    against the JAX kernel run interpreted at that width, cropped rows
    (n_frames at, just past and near the width, and 130) against the JAX
    XLA chain. Band of the reference's kernel test (1e-5)."""
    from crisperwhisper_tpu.ops.alignment import median_filter, znorm_tokens
    from crisperwhisper_tpu.ops.pallas_align import fused_align_prep
    from crisperwhisper_tpu_torch.ops.align_prep import align_prep_plain
    w, nt = cases["w"], cases["nt"]
    full = np.full((2,), w.shape[-1], np.int32)
    ref = np.asarray(fused_align_prep(jnp.asarray(w[:2]), jnp.asarray(nt[:2]),
                                      width, interpret=True))
    got = align_prep_plain(*_t(w[:2], nt[:2], full), width).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i][:nt[i]], ref[i][:nt[i]], atol=1e-5)

    nts = np.array([25, 17, 25, 9], np.int32)
    nfs = np.array([width // 2, width // 2 + 1, width + 1, 130], np.int32)
    ws = w[np.arange(4) % len(w)]
    got = align_prep_plain(*_t(ws, nts, nfs), width).numpy()
    t, m = ws.shape[2], ws.shape[3]
    for i in range(len(ws)):
        fmask = np.arange(m) < nfs[i]
        tmask = np.arange(t) < nts[i]
        wi = jnp.where(jnp.asarray(fmask)[None, None, :],
                       jnp.asarray(ws[i]), 0.0)
        z = znorm_tokens(wi, jnp.broadcast_to(jnp.asarray(tmask),
                                              (ws.shape[1], t)))
        ref = np.asarray(-jnp.mean(median_filter(z, width, int(nfs[i])),
                                   axis=0))
        live = tmask[:, None] & fmask[None, :]
        np.testing.assert_allclose(got[i][live], ref[live], atol=1e-5)


def test_tiny_pipeline_median_width_5_matches_jax(tmp_path):
    """The whole TINY slice with load_pipeline(median_filter_width=5) on
    both packages (f32, one temperature): equal tokens, token timestamps
    within one DTW frame. On the card the same width reaches the
    align-prep kernel (tests/test_torch_gpu.py)."""
    from dataclasses import replace

    from crisperwhisper_tpu.config import PipelineOptions
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.pipeline.asr import chunk_iter
    from torch_port_fixtures import (CHUNK_S, SR, TS_BAND, tone_audio,
                                     write_tiny_checkpoint)
    ckpt = write_tiny_checkpoint(str(tmp_path / "ckpt"))
    po = PipelineOptions(chunk_length_s=CHUNK_S, batch_size=16,
                         return_timestamps="word")
    jp = jax_load(ckpt, dtype=jnp.float32, pipe_opts=po,
                  median_filter_width=5)
    jp.gen_opts = replace(jp.gen_opts, temperatures=(0.0,),
                          staged_ring_quantum=0)
    tp = load_pipeline(ckpt, dtype=torch.float32, device="cpu", pipe_opts=po,
                       median_filter_width=5)
    tp.gen_opts = replace(tp.gen_opts, temperatures=(0.0,))
    assert jp.gen_opts.median_filter_width == 5
    assert tp.gen_opts.median_filter_width == 5
    audio = tone_audio(12.0, 0)
    step = round(CHUNK_S / 6 * SR)
    chunks = list(chunk_iter(audio, 0, CHUNK_S * SR, step, step))
    ref = jp._run_chunks(chunks, CHUNK_S * SR, "word")
    got = tp._run_chunks(chunks, CHUNK_S * SR, "word")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
        np.testing.assert_allclose(g["token_timestamps"],
                                   r["token_timestamps"], atol=TS_BAND)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_dtw_ignores_cells_outside_the_live_rectangle(kind):
    """The DTW reads no cell outside [0, n_tokens] x [0, n_frames]: the
    port's plain DTW on a matrix with fresh random values there equals,
    exactly, the JAX scan and the JAX kernel (interpreted) on the same
    matrix masked with 1e9. Integer costs in {0, 1, 2} put ties on the
    tie-break."""
    from crisperwhisper_tpu.ops.alignment import dtw_jump_times as jdtw
    from crisperwhisper_tpu.ops.pallas_dtw import pallas_dtw_jump_times
    from crisperwhisper_tpu_torch.ops.alignment import dtw_jump_times
    rng = np.random.default_rng(11 if kind == "normal" else 12)
    b, n, m = 4, 21, 60

    def draw():
        if kind == "normal":
            return rng.standard_normal((b, n, m)).astype(np.float32)
        return rng.integers(0, 3, (b, n, m)).astype(np.float32)

    nt = np.array([21, 13, 1, 0], np.int32)
    nf = np.array([60, 41, 7, 60], np.int32)
    live = ((np.arange(n)[None, :, None] < nt[:, None, None])
            & (np.arange(m)[None, None, :] < nf[:, None, None]))
    mat = draw()
    masked = np.where(live, mat, np.float32(1e9))
    garbage = np.where(live, mat, draw() * 7)
    ref_kernel = np.asarray(pallas_dtw_jump_times(
        jnp.asarray(masked), jnp.asarray(nt), jnp.asarray(nf),
        interpret=True))
    ref_scan = np.stack([np.asarray(jdtw(jnp.asarray(masked[i]), int(nt[i]),
                                         int(nf[i])))
                         for i in range(b)])
    got = dtw_jump_times(*_t(garbage, nt, nf)).numpy()
    np.testing.assert_array_equal(got, ref_kernel)
    np.testing.assert_array_equal(got, ref_scan)


def test_attention_to_jump_times_unmasked_matches_jax(monkeypatch):
    """The alignment pass hands the prep's output to the DTW as it is (no
    mask between them: what lies outside the live rectangle is the prep's
    own z values), and the result equals the JAX package's pass on full
    and cropped rows."""
    from crisperwhisper_tpu.ops.alignment import attention_to_jump_times as j
    from crisperwhisper_tpu_torch.ops import dtw as dtw_module
    from crisperwhisper_tpu_torch.ops.alignment import attention_to_jump_times
    rng = np.random.default_rng(13)
    w = np.exp(rng.standard_normal((4, 2, 19, 130))).astype(np.float32)
    nt = np.array([19, 11, 19, 4], np.int32)
    nf = np.array([130, 130, 77, 30], np.int32)
    seen = []
    real = dtw_module.dtw

    def spy(matrix, *args, **kwargs):
        seen.append(matrix.clone())
        return real(matrix, *args, **kwargs)

    monkeypatch.setattr(dtw_module, "dtw", spy)
    got = attention_to_jump_times(*_t(w), 7, *_t(nt, nf)).numpy()
    ref = np.asarray(j(jnp.asarray(w), 7, jnp.asarray(nt), jnp.asarray(nf)))
    np.testing.assert_array_equal(got, ref)
    (cost,) = seen
    live = ((np.arange(19)[None, :, None] < nt[:, None, None])
            & (np.arange(130)[None, None, :] < nf[:, None, None]))
    outside = cost.numpy()[~live]
    assert outside.size and np.abs(outside).max() < 1e3   # not 1e9


def _constants(source: str) -> dict:
    """``constexpr int kName = expr;`` of a kernel source."""
    import re
    from pathlib import Path
    from crisperwhisper_tpu_torch import _build
    src = (Path(_build.CSRC) / source).read_text()
    k = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        k[name] = eval(expr.split("//")[0].replace("/", "//"), {}, dict(k))
    return k


def test_wrapper_constants_match_the_kernel_source():
    """The wrappers' copies of csrc/dtw.cu's and csrc/align_prep.cu's
    constants, which their shared-memory gates are computed from, equal
    the sources'; both sources are built."""
    from crisperwhisper_tpu_torch import _build
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import dtw as dt
    k = _constants("dtw.cu")
    assert (dt.RING_CHUNKS, dt.QUEUE_STEPS, dt.MAX_WARPS, dt.SMEM_LIMIT) == (
        k["kRingChunks"], k["kQueueSteps"], k["kMaxWarps"], k["kMaxSmem"])
    k = _constants("align_prep.cu")
    assert (ap.TILE, ap.THREADS, ap.ROWS_PER_THREAD, ap.SMEM_LIMIT) == (
        k["kTile"], k["kThreads"], k["kRowsPerThread"], k["kMaxSmem"])
    assert ap.MAX_TOKENS == 512
    assert {"dtw.cu", "align_prep.cu"} <= set(_build.SOURCES)


def test_every_whisper_geometry_fits_the_kernels():
    """Every token count up to max_target_positions at every frame count
    up to max_source_positions (448 x 1500, the largest Whisper window)
    fits the DTW's 2-bit trace and rings in shared memory, and the
    alignment prep's strips at the median widths up to 15."""
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import dtw as dt
    arch = WhisperArch()
    n_max, m_max = arch.max_target_positions, arch.max_source_positions
    assert (n_max, m_max) == (448, 1500)
    for n in range(1, n_max + 1):
        for m in (1, 7, 250, 1000, m_max):
            warps, step = dt.plan(n, m)
            assert warps * 32 >= n > (warps - 1) * 32
            assert warps <= dt.MAX_WARPS and step in dt.STEPS
            assert dt.smem_bytes(n, m, warps, step) <= dt.SMEM_LIMIT
        for width in range(1, 16, 2):
            assert ap.plan(n, m_max, width) <= ap.SMEM_LIMIT
    # the trace alone at 448 x 1500: 448 rows of 94 words
    assert dt.smem_bytes(448, 1500, 1, 8) - 32 * 3 * 8 * 4 - 8 == 448 * 94 * 4


@pytest.mark.parametrize("case", ["dtw_frames", "dtw_rows", "prep_rows",
                                  "prep_width"])
def test_shapes_over_the_budget_raise(case):
    """A shape the kernels cannot hold is refused with a ValueError that
    names the limit, not routed anywhere else."""
    from crisperwhisper_tpu_torch.ops import align_prep as ap
    from crisperwhisper_tpu_torch.ops import dtw as dt
    with pytest.raises(ValueError, match="232448|at most|exceed"):
        if case == "dtw_frames":
            dt.plan(448, 3000)          # trace 448 x 188 words
        elif case == "dtw_rows":
            dt.plan(16 * 32 + 1, 100)
        elif case == "prep_rows":
            ap.plan(513, 1500, 7)
        else:
            ap.plan(512, 1500, 31)      # two strips of 512 x 68 floats
