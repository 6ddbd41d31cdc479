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
