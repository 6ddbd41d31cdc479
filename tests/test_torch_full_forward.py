"""PyTorch port: the full-sequence and auxiliary model functions, group-wise
int4 weights, short-form generation, the seek loop's progress callback,
dtw_trace, the host audio helpers and the packages' public names, each
against the JAX package on the same seed-pinned TINY weights and seeded
numpy inputs, at f32.

Bands: logits within the port's decode-step band, atol=2e-4, rtol=1e-4
(tests/test_torch_model.py): both sides sum the same f32 products in
other orders. Integer results (int4 codes, tokens, DTW traces, progress
arrays) and bf16 scales are exact. Token timestamps within 0.021 s (one
20 ms DTW frame, tests/test_generate.py:68); sum_logprobs and no-speech
probabilities within 1e-4.
"""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import port_config, tiny_state_dict, to_torch

LOGIT_BAND = dict(atol=2e-4, rtol=1e-4)
ALIGN_HEADS = ((0, 1), (1, 3), (0, 2))


@pytest.fixture(scope="module")
def weights():
    """The TINY HF weights in both packages' layouts (f32), and the
    encoder states of a seeded batch of 2 (the JAX package's, fed to both
    decoders)."""
    from crisperwhisper_tpu.models import encode
    from crisperwhisper_tpu.models import params_from_state_dict as jload
    from crisperwhisper_tpu_torch.models.loader import params_from_state_dict
    sd = tiny_state_dict()
    arch = tiny_arch()
    jp = jload(sd, arch, dtype=jnp.float32)
    mel = rand_mel(batch=2, seed=5)
    return {"arch": arch, "jax": jp,
            "torch": params_from_state_dict(sd, arch, torch.float32),
            "mel": mel, "enc": np.array(encode(jp, arch, jnp.asarray(mel))),
            "ids": np.random.default_rng(3).integers(
                0, 900, (2, 12)).astype(np.int32)}


def _trees(w, kind):
    """(JAX tree, port tree) of one kind, each built by its own package."""
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu_torch.models import quantize as TQ
    jp, tp, hd = w["jax"], w["torch"], w["arch"].head_dim
    if kind in ("fused", "int8"):
        jp, tp = JQ.fuse_decoder_qkv(jp, hd), TQ.fuse_decoder_qkv(tp, hd)
    if kind == "int8":
        jp, tp = JQ.quantize_decoder_weights(jp), TQ.quantize_decoder_weights(tp)
    if kind == "int4":
        jp = JQ.quantize_decoder_weights(jp, bits=4)
        tp = TQ.quantize_decoder_weights(tp, bits=4)
    return jp, tp


@pytest.mark.parametrize("kind", ["plain", "fused", "int8", "int4"])
def test_decoder_forward_matches_jax(weights, kind):
    """Teacher-forced logits of the plain, fused-q/k/v, fused int8 and
    group-wise int4 trees (the int4 tree against JAX's bits=4 tree)."""
    from crisperwhisper_tpu.models import decoder_forward as jdf
    from crisperwhisper_tpu_torch.models import decoder_forward
    jp, tp = _trees(weights, kind)
    arch, enc, ids = weights["arch"], weights["enc"], weights["ids"]
    ref = np.asarray(jdf(jp, arch, jnp.asarray(ids), jnp.asarray(enc)))
    got = decoder_forward(tp, arch, torch.from_numpy(ids),
                          torch.from_numpy(enc))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 1000)
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_BAND)


def test_forward_matches_jax(weights):
    from crisperwhisper_tpu.models import forward as jforward
    from crisperwhisper_tpu_torch.models import forward
    arch, mel, ids = weights["arch"], weights["mel"], weights["ids"]
    ref = np.asarray(jforward(weights["jax"], arch, jnp.asarray(mel),
                              jnp.asarray(ids)))
    got = forward(weights["torch"], arch, torch.from_numpy(mel),
                  torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_BAND)


@pytest.mark.parametrize("with_encoder", [False, True])
def test_causal_lm_forward_matches_jax(weights, with_encoder):
    """With the encoder states it is decoder_forward; without them the
    cross sublayer is skipped."""
    from crisperwhisper_tpu.models.whisper import causal_lm_forward as jclm
    from crisperwhisper_tpu_torch.models.whisper import causal_lm_forward
    arch, ids = weights["arch"], weights["ids"]
    enc = weights["enc"] if with_encoder else None
    ref = np.asarray(jclm(weights["jax"], arch, jnp.asarray(ids),
                          None if enc is None else jnp.asarray(enc)))
    got = causal_lm_forward(weights["torch"], arch, torch.from_numpy(ids),
                            None if enc is None else torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_BAND)


def test_audio_classification_forward_matches_jax(weights):
    """A JAX head (init_classification_head) carried across with
    classification_head_from_jax gives the JAX package's logits."""
    from crisperwhisper_tpu.models.whisper import (
        audio_classification_forward as jacf, init_classification_head as jh)
    from crisperwhisper_tpu_torch.models.loader import (
        classification_head_from_jax)
    from crisperwhisper_tpu_torch.models.whisper import (
        audio_classification_forward)
    arch, mel = weights["arch"], weights["mel"]
    jhead = jh(arch, 7, jax.random.PRNGKey(1))
    head = classification_head_from_jax(jax.device_get(jhead))
    assert head["projector"]["w"].shape == (256, 64)
    assert torch.equal(head["classifier"]["w"],
                       to_torch(jhead["classifier"]["w"]).T)
    ref = np.asarray(jacf(weights["jax"], arch, jnp.asarray(mel), jhead))
    got = audio_classification_forward(weights["torch"], arch,
                                       torch.from_numpy(mel), head)
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_BAND)


def test_init_classification_head_shapes_and_std():
    from crisperwhisper_tpu_torch.models.whisper import (
        init_classification_head)
    head = init_classification_head(
        tiny_arch(), 7, torch.Generator().manual_seed(0),
        classifier_proj_size=512, dtype=torch.bfloat16, device="cpu")
    assert head["projector"]["w"].shape == (512, 64)
    assert head["classifier"]["w"].shape == (7, 512)
    for p in head.values():
        assert p["w"].dtype == p["b"].dtype == torch.bfloat16
        assert not p["b"].any()
    # 32768 draws of N(0, 0.02): the std within 2% of 0.02
    std = head["projector"]["w"].float().std().item()
    assert abs(std - 0.02) < 4e-4, std


@pytest.mark.parametrize("call", ["init_classification_head",
                                  "classification_head_from_state_dict",
                                  "load_saved_params"])
def test_new_entry_points_default_to_the_card(call, monkeypatch, tmp_path):
    """With no device named they run on "cuda"; with no card they raise
    and say to pass device="cpu"."""
    from crisperwhisper_tpu_torch.models import loader, whisper
    from crisperwhisper_tpu_torch.utils import checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"init_classification_head": lambda: whisper.init_classification_head(
              tiny_arch(), 3, torch.Generator()),
          "classification_head_from_state_dict":
              lambda: loader.classification_head_from_state_dict(
                  {"projector.weight": np.zeros((4, 64), np.float32),
                   "classifier.weight": np.zeros((3, 4), np.float32)}),
          "load_saved_params":
              lambda: checkpoint.load_saved_params(str(tmp_path))}[call]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()


@pytest.mark.parametrize("shape,n", [((1000,), 600), ((1000,), 1500),
                                     ((2, 700), 700), ((3, 400), 512)])
def test_pad_or_trim_matches_jax(shape, n):
    from crisperwhisper_tpu.audio.mel import pad_or_trim as jpt
    from crisperwhisper_tpu_torch.audio import pad_or_trim
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, ref = pad_or_trim(x, n), jpt(x, n)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("length", [None, 80, 100])
def test_zero_mean_unit_var_norm_matches_jax(length):
    """As tests/test_aux_models.py:83: the true region normalized, the
    padding set to padding_value."""
    from crisperwhisper_tpu.audio.mel import zero_mean_unit_var_norm as jz
    from crisperwhisper_tpu_torch.audio.mel import zero_mean_unit_var_norm
    x = np.random.default_rng(0).standard_normal((2, 100)).astype(
        np.float32) * 3 + 1
    x[:, 80:] = 0.0
    got = zero_mean_unit_var_norm(x.copy(), length=length, padding_value=-1)
    np.testing.assert_allclose(got, jz(x.copy(), length=length,
                                       padding_value=-1), atol=1e-6)
    if length == 80:
        np.testing.assert_allclose(got[:, :80].mean(-1), 0.0, atol=1e-5)
        assert (got[:, 80:] == -1).all()


def test_int4_weights_match_jax_exactly(weights):
    """Group-wise int4: the codes and bf16 scales of every dense equal
    JAX's; the JAX tree carried across equals the port's own, byte for
    byte; dequantize_dense is exact; quantization_error equals JAX's."""
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    jp, tp = _trees(weights, "int4")
    jl = jp["decoder"]["layers"]
    names = [("self", n) for n in "qkvo"] + [("cross", n) for n in "qkvo"] \
        + [("mlp", "fc1"), ("mlp", "fc2")]
    for li, lp in enumerate(tp["decoder"]["layers"]):
        for group, name in names:
            got, ref = lp[group][name], jl[group][name]
            assert got["w_q4"].dtype == torch.uint8
            assert got["w_gscale"].dtype == torch.bfloat16
            codes = TQ.unpack_int4_weights(got["w_q4"])       # [o, G, gsz]
            assert int(codes.abs().max()) <= 7
            jcodes = to_torch(JQ.unpack_int4(ref["w_q4"][li]))  # [G, gsz, o]
            assert torch.equal(codes, jcodes.permute(2, 0, 1)), (group, name)
            assert torch.equal(got["w_gscale"],
                               to_torch(ref["w_gscale"][li]).T), (group, name)
            assert torch.equal(TQ.dequantize_dense(got).T,
                               to_torch(JQ.dequantize_dense(
                                   jax.tree.map(lambda x: x[li], ref))))
            assert ("b" in got) == ("b" in ref)
            if "b" in got:
                assert torch.equal(got["b"], to_torch(ref["b"][li]))
    carried = params_from_jax(jax.device_get(jp), weights["arch"])
    for a, b in zip(carried["decoder"]["layers"], tp["decoder"]["layers"]):
        for group, name in names:
            assert a[group][name].keys() == b[group][name].keys()
            for k in a[group][name]:
                assert torch.equal(a[group][name][k], b[group][name][k])
    ref = JQ.quantization_error(weights["jax"], jp)
    got = TQ.quantization_error(weights["torch"], tp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


def test_int4_weights_pack_round_trip():
    """The packing holds every code in [-7, 7] at every place of a group."""
    from crisperwhisper_tpu_torch.models import quantize as TQ
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        -7, 8, (5, 3, 128)).astype(np.int8))
    packed = TQ.pack_int4_weights(codes)
    assert packed.shape == (5, 3, 64) and packed.dtype == torch.uint8
    assert torch.equal(TQ.unpack_int4_weights(packed), codes)


def test_decode_step_kernel_gate_refuses_int4_weights(weights):
    """Kernel 5 takes int8 weights only: the gate passes the fused int8
    tree and refuses the same tree with group-wise int4 weights, which
    then takes the plain step (the reference's supported(),
    pallas_decode_b1.py:710-726)."""
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.models.whisper import init_cache
    from crisperwhisper_tpu_torch.ops import decode_step as step_kernel
    arch, tp = weights["arch"], weights["torch"]
    fused = TQ.fuse_decoder_qkv(tp, arch.head_dim)
    cache = init_cache(tp, arch, torch.from_numpy(weights["enc"][:1]),
                       cache_len=32, cross_dtype="int4", self_dtype="int8")
    tok = torch.tensor([TINY_SPECIALS.sot])
    for bits, passes in ((8, True), (4, False)):
        tree = TQ.quantize_decoder_weights(fused, bits=bits)
        assert step_kernel.supported(tree, arch, cache, None, 1, 0,
                                     tok) is passes, bits


@pytest.mark.parametrize("n,m,kind", [(1, 7, "normal"), (9, 1, "normal"),
                                      (13, 40, "normal"), (13, 40, "ties"),
                                      (25, 25, "ties")])
def test_dtw_trace_matches_jax(n, m, kind):
    """Every code and boundary cell equal, on random matrices and on
    matrices of a few integer values (ties at every step)."""
    from crisperwhisper_tpu.ops import dtw_trace as jtrace
    from crisperwhisper_tpu_torch.ops import dtw_trace
    rng = np.random.default_rng(n * 100 + m)
    x = (rng.integers(0, 3, (n, m)) if kind == "ties"
         else rng.standard_normal((n, m))).astype(np.float32)
    got = dtw_trace(torch.from_numpy(x))
    assert got.dtype == torch.int8 and got.shape == (n + 1, m + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtrace(
        jnp.asarray(x))))


@pytest.fixture(scope="module")
def short_form_setup(weights):
    from crisperwhisper_tpu.config import GenerationOptions
    opts = GenerationOptions(alignment_heads=ALIGN_HEADS,
                             median_filter_width=7,
                             max_initial_timestamp_index=50,
                             compression_ratio_threshold=None,
                             logprob_threshold=None,
                             no_speech_threshold=None,
                             temperatures=(0.0,), max_new_tokens=32)
    return opts, port_config(opts), port_config(TINY_SPECIALS)


@pytest.mark.parametrize("num_frames", [None, (500, 322)])
def test_generate_short_form_matches_jax(weights, short_form_setup,
                                         num_frames):
    """Temperature 0, batch 2, full windows and a row cropped below the
    window's 500 frames."""
    from crisperwhisper_tpu.decoding.generate import generate_short_form as J
    from crisperwhisper_tpu_torch.decoding import generate_short_form
    jopts, opts, specials = short_form_setup
    arch = weights["arch"]
    mel = rand_mel(batch=2, seed=11)
    nf = None if num_frames is None else np.asarray(num_frames)
    ref = J(weights["jax"], arch, TINY_SPECIALS, jopts, jnp.asarray(mel),
            num_frames=nf)
    got = generate_short_form(weights["torch"], arch, specials, opts,
                              torch.from_numpy(mel), num_frames=nf)
    np.testing.assert_array_equal(got.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(got.num_generated,
                                  np.asarray(ref.num_generated))
    assert int(got.num_generated.min()) > 1
    np.testing.assert_allclose(got.token_timestamps, ref.token_timestamps,
                               atol=0.021)
    np.testing.assert_allclose(got.sum_logprobs, ref.sum_logprobs,
                               atol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs, ref.no_speech_probs,
                               atol=1e-4)


def test_monitor_progress_matches_jax(weights, short_form_setup):
    """The seek loop's (seek, max_frames) arrays, pass by pass, on the
    1250-frame 2-row input of tests/test_generate.py:89."""
    from crisperwhisper_tpu.decoding import generate as jgen
    from crisperwhisper_tpu_torch.decoding import generate
    jopts, opts, specials = short_form_setup
    frames = 1250
    mel = rand_mel(batch=2, seed=21, frames=frames)
    bounds = np.array([frames, frames - 400])
    ref, got = [], []
    jgen(weights["jax"], weights["arch"], TINY_SPECIALS,
         replace(jopts, return_token_timestamps=False), jnp.asarray(mel),
         num_frames=bounds, max_frames=bounds, monitor_progress=ref.append)
    generate(weights["torch"], weights["arch"], specials,
             replace(opts, return_token_timestamps=False),
             torch.from_numpy(mel), num_frames=bounds, max_frames=bounds,
             monitor_progress=got.append)
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert a.shape == (2, 2) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("package", ["audio", "decoding", "models", "ops",
                                     "parallel"])
def test_package_public_names_match_jax(package):
    """Each package exports the JAX package's public names but for the
    JAX-only ones (jitted entries, the Pallas probe, the int8 test
    oracle), and every name imports."""
    import importlib
    jax_only = {"assisted_decode_jit", "beam_decode_jit",
                "greedy_decode_jit", "supports_pallas", "dequant_reference"}
    ref = importlib.import_module(f"crisperwhisper_tpu.{package}")
    mod = importlib.import_module(f"crisperwhisper_tpu_torch.{package}")
    assert mod.__all__ == [n for n in ref.__all__ if n not in jax_only]
    for name in mod.__all__:
        assert callable(getattr(mod, name)), name
