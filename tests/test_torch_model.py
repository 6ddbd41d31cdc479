"""PyTorch port: loader, mel frontend, encoder and decoder step against
the JAX package, from the same seed-pinned TINY weights."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import tiny_state_dict


@pytest.fixture(scope="module")
def weights():
    """The TINY state dict in both packages' layouts (f32)."""
    from crisperwhisper_tpu.models import params_from_state_dict as jax_load
    from crisperwhisper_tpu_torch.models.loader import params_from_state_dict
    sd = tiny_state_dict()
    arch = tiny_arch()
    return {"sd": sd, "arch": arch,
            "jax": jax_load(sd, arch, dtype=jnp.float32),
            "torch": params_from_state_dict(sd, arch, torch.float32)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_params(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def test_params_from_jax_equals_params_from_state_dict(weights):
    """Dense [in,out] -> [out,in], conv HIO -> [out,in,k] and stacked layers
    -> per-layer dicts give exactly the HF-named tensors."""
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    tree = jax.device_get(weights["jax"])
    _assert_same_params(params_from_jax(tree, weights["arch"]),
                        weights["torch"])


def test_load_params_reads_safetensors_files(weights, tmp_path):
    """The self-contained reader vs files written by safetensors.torch,
    f32 and bf16 (LayerNorms stay f32)."""
    from safetensors.torch import save_file
    from crisperwhisper_tpu_torch.models.loader import (load_params,
                                                        params_from_state_dict,
                                                        read_safetensors)
    arch = weights["arch"]
    sd = {k: torch.from_numpy(v).contiguous()
          for k, v in weights["sd"].items() if k != "proj_out.weight"}
    save_file(sd, os.path.join(tmp_path, "model.safetensors"))
    params, _ = load_params(str(tmp_path), arch, dtype=torch.float32,
                            device="cpu")
    _assert_same_params(params, weights["torch"])

    half = {k: v.bfloat16() for k, v in sd.items()}
    save_file(half, os.path.join(tmp_path, "half.safetensors"))
    got = read_safetensors(os.path.join(tmp_path, "half.safetensors"))
    assert got.keys() == half.keys()
    for k in half:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], half[k])
    p16 = params_from_state_dict(got, arch, torch.bfloat16)
    assert p16["decoder"]["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert p16["decoder"]["tok_emb"].dtype == torch.bfloat16



def test_load_params_runs_on_the_card_unless_asked(weights, tmp_path):
    """load_params names no device -> the card; without one that is a
    RuntimeError naming device="cpu", never a silent CPU load."""
    from safetensors.torch import save_file
    from crisperwhisper_tpu_torch.models.loader import load_params
    if torch.cuda.is_available():
        pytest.skip("the card is present: load_params loads onto it")
    save_file({k: torch.from_numpy(v).contiguous()
               for k, v in weights["sd"].items() if k != "proj_out.weight"},
              os.path.join(tmp_path, "model.safetensors"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_params(str(tmp_path), weights["arch"], dtype=torch.float32)

def test_init_params_mirrors_jax_init(weights):
    """Same tree, shapes and dtypes as the JAX init; the reference's
    distributions (std 0.02, zero biases, unit LayerNorms, sinusoids)."""
    from crisperwhisper_tpu.models import init_params as jax_init
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from crisperwhisper_tpu_torch.models.whisper import init_params, sinusoids
    arch = weights["arch"]
    ours = init_params(arch, torch.Generator().manual_seed(0))
    ref = params_from_jax(jax.device_get(jax_init(arch, jax.random.PRNGKey(0))),
                          arch)
    lo, lr = dict(_leaves(ours)), dict(_leaves(ref))
    assert lo.keys() == lr.keys()
    for k in lo:
        assert lo[k].shape == lr[k].shape and lo[k].dtype == lr[k].dtype, k
    tok = ours["decoder"]["tok_emb"]
    assert abs(tok.std().item() - 0.02) < 1e-3
    assert not ours["encoder"]["layers"][0]["attn"]["q"]["b"].any()
    assert "b" not in ours["encoder"]["layers"][0]["attn"]["k"]
    assert torch.equal(ours["encoder"]["pos"],
                       torch.from_numpy(sinusoids(250, arch.d_model)))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    from crisperwhisper_tpu.audio.mel import extract_features as jax_mel
    from crisperwhisper_tpu.config import FeatureConfig
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    cfg = FeatureConfig(feature_size=n_mels, chunk_length=5)
    rng = np.random.default_rng(3)
    t = np.arange(cfg.n_samples) / 16000.0
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * 440 * t)
        + 0.05 * rng.standard_normal(cfg.n_samples),
        np.concatenate([0.1 * rng.standard_normal(cfg.n_samples // 2),
                        np.zeros(cfg.n_samples - cfg.n_samples // 2)]),
    ]).astype(np.float32)
    ref = np.asarray(jax_mel(jnp.asarray(audio), cfg))
    got = extract_features(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == ref.shape == (2, n_mels, 500)
    # the band the JAX frontend holds against HF (test_mel.py:49)
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_encoder_matches_jax(weights):
    from crisperwhisper_tpu.models import encode as jax_encode
    from crisperwhisper_tpu_torch.models.whisper import encode
    mel = rand_mel(batch=2, seed=1)
    ref = np.asarray(jax_encode(weights["jax"], weights["arch"],
                                jnp.asarray(mel)))
    got = encode(weights["torch"], weights["arch"],
                 torch.from_numpy(mel)).numpy()
    # the encoder band of the JAX package against HF (test_model.py:36)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def test_decode_steps_and_alignment_heads_match_jax(weights):
    """Block prefill + incremental steps: logits within 2e-4 of the JAX
    step (test_model.py:72) and alignment-head probabilities within 2e-5
    (test_model.py:101); the JAX side reads its full ring (quantum 0)."""
    from crisperwhisper_tpu.models import (alignment_selector as jsel,
                                           decode_step as jstep,
                                           decode_step_multi as jmulti,
                                           encode as jenc,
                                           init_cache as jcache)
    from crisperwhisper_tpu_torch.models.whisper import (alignment_selector,
                                                         decode_step,
                                                         decode_step_multi,
                                                         encode, init_cache)
    arch = weights["arch"]
    heads = ((0, 1), (1, 3), (0, 2))
    mel = rand_mel(batch=2, seed=3)
    ids = np.array([[TINY_SPECIALS.sot, 11, 22, 33, 44, 55],
                    [TINY_SPECIALS.sot, 66, 77, 88, 99, 111]], np.int32)
    sel = alignment_selector(arch, heads)
    np.testing.assert_array_equal(sel, jsel(arch, heads))

    jenc_out = jenc(weights["jax"], arch, jnp.asarray(mel))
    jc = jcache(weights["jax"], arch, jenc_out, cache_len=16)
    enc_out = encode(weights["torch"], arch, torch.from_numpy(mel))
    tc = init_cache(weights["torch"], arch, enc_out, cache_len=16)

    jl, jc, ja = jmulti(weights["jax"], arch, jnp.asarray(ids[:, :3]),
                        jnp.int32(0), jc, align_sel=jnp.asarray(sel))
    tl, tc, ta = decode_step_multi(weights["torch"], arch,
                                   torch.from_numpy(ids[:, :3]).long(), 0,
                                   tc, align_sel=sel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5,
                               rtol=1e-4)
    for t in range(3, ids.shape[1]):
        jl, jc, ja = jstep(weights["jax"], arch, jnp.asarray(ids[:, t]),
                           jnp.int32(t), jc, align_sel=jnp.asarray(sel))
        tl, tc, ta = decode_step(weights["torch"], arch,
                                 torch.from_numpy(ids[:, t]).long(), t, tc,
                                 align_sel=sel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5,
                                   rtol=1e-4)


def test_detect_language_matches_jax(weights):
    from crisperwhisper_tpu.decoding.language import detect_language as jdl
    from crisperwhisper_tpu.models import encode as jax_encode
    from crisperwhisper_tpu_torch.decoding.language import detect_language
    from crisperwhisper_tpu_torch.models.whisper import encode
    arch = weights["arch"]
    mel = rand_mel(batch=3, seed=5)
    ref = np.asarray(jdl(weights["jax"], arch, TINY_SPECIALS,
                         jax_encode(weights["jax"], arch, jnp.asarray(mel)),
                         num_languages=60))
    got = detect_language(weights["torch"], arch, TINY_SPECIALS,
                          encode(weights["torch"], arch,
                                 torch.from_numpy(mel)),
                          num_languages=60).numpy()
    np.testing.assert_array_equal(got, ref)
