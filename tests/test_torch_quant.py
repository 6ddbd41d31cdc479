"""PyTorch port: quantized weights, quantized caches and the quantized
(non-kernel) decode step against the JAX package, from the same TINY
weights (the JAX package's init_params, carried across with
params_from_jax)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import rand_mel
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import cache_from_jax, quantized_tiny, to_torch

_DENSES = (("self", "qkv"), ("self", "o"), ("cross", "q"), ("cross", "k"),
           ("cross", "v"), ("cross", "o"), ("mlp", "fc1"), ("mlp", "fc2"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fused", [False, True])
def test_quantized_weights_match_jax_bit_for_bit(fused):
    """int8 values equal bit for bit, bf16 scales equal, for the plain and
    the fused-QKV trees; the JAX tree carried across equals the port's."""
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu_torch.models import quantize as TQ
    arch, jq, tq, carried = quantized_tiny(fused)
    names = [n for n in _DENSES if fused or n[1] != "qkv"]
    if not fused:
        names += [("self", "q"), ("self", "k"), ("self", "v")]
    jl = jq["decoder"]["layers"]
    for li, lp in enumerate(tq["decoder"]["layers"]):
        for group, name in names:
            got = lp[group][name]
            assert got["w_q"].dtype == torch.int8
            assert got["w_scale"].dtype == torch.bfloat16
            ref = jl[group][name]
            assert torch.equal(got["w_q"],
                               to_torch(ref["w_q"][li]).T), (group, name)
            assert torch.equal(got["w_scale"],
                               to_torch(ref["w_scale"][li, 0])), (group, name)
    a, b = dict(_leaves(tq)), dict(_leaves(carried))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # dequantization follows the reference's
    w = tq["decoder"]["layers"][1]["mlp"]["fc1"]
    np.testing.assert_array_equal(
        TQ.dequantize_dense(w).T.numpy(),
        np.asarray(JQ.dequantize_dense(
            jax.tree.map(lambda x: x[1], jl["mlp"]["fc1"]))))


def test_quantization_error_matches_jax():
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from helpers import tiny_arch
    arch = tiny_arch()
    jp = init_params(arch, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.device_get(jp), arch)
    for bits, limit in ((8, 1 / 127), (4, 1 / 7)):
        ref = JQ.quantization_error(jp, JQ.quantize_decoder_weights(jp, bits))
        got = TQ.quantization_error(tp, TQ.quantize_decoder_weights(tp, bits))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-6), (bits, k)
            assert 0 < got[k] < limit
    with pytest.raises(ValueError, match="use 8 or 4"):
        TQ.quantize_decoder_weights(tp, bits=2)


def _encoder_out(arch, jq, batch):
    from crisperwhisper_tpu.models import encode
    return np.array(encode(jq, arch, jnp.asarray(rand_mel(batch, 5))))


@pytest.mark.parametrize("cross", ["int8", "int4"])
def test_quantized_cache_matches_jax(cross):
    """init_cache from the same encoder states: values within one LSB (the
    f32 K/V projections are summed in another order), bf16 scales within
    one bf16 step and mostly equal; packed int4 unpacks to JAX's values;
    the ring starts as zeros with bf16 scales."""
    from crisperwhisper_tpu.models import init_cache as jinit
    from crisperwhisper_tpu_torch.models import whisper as W
    arch, jq, tq, _ = quantized_tiny()
    enc = _encoder_out(arch, jq, 2)
    jdt = {"int8": jnp.int8, "int4": jnp.int4}[cross]
    ref = cache_from_jax(jinit(jq, arch, jnp.asarray(enc), cross_dtype=jdt,
                               cache_len=32, self_dtype=jnp.int8))
    got = W.init_cache(tq, arch, torch.from_numpy(enc), cache_len=32,
                       cross_dtype=cross, self_dtype="int8")
    dh = arch.head_dim
    width = dh // 2 if cross == "int4" else dh
    assert got.cross_k.shape == (2, 2, 4, 250, width)
    assert got.cross_k.dtype == (torch.uint8 if cross == "int4"
                                 else torch.int8)
    for name in ("cross_k", "cross_v"):
        a = W.cache_values(getattr(got, name)).int()
        b = W.cache_values(getattr(ref, name)).int()
        assert (a - b).abs().max() <= 1, name
        assert (a == b).float().mean() > 0.99, name
        assert a.abs().max() <= (7 if cross == "int4" else 127)
    for name in ("cross_k_scale", "cross_v_scale"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=0)
        assert (a == b).float().mean() > 0.99, name
    assert got.self_k.shape == (2, 2, 4, 32, dh)
    assert got.self_k.dtype == torch.int8 and not got.self_k.any()
    assert got.self_k_scale.dtype == torch.bfloat16
    assert got.self_k_scale.shape == (2, 2, 4, 32)


def test_int4_packing_round_trips():
    from crisperwhisper_tpu_torch.models.whisper import pack_int4, unpack_int4
    q = torch.from_numpy(np.random.default_rng(0).integers(
        -7, 8, size=(3, 5, 16)).astype(np.int8))
    p = pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (3, 5, 8)
    assert torch.equal(unpack_int4(p), q)
    assert int(p[0, 0, 0]) == (int(q[0, 0, 0]) & 0xF) | \
        ((int(q[0, 0, 1]) & 0xF) << 4)           # low nibble = even index


@pytest.mark.parametrize("cross,self_", [("int8", None), ("int8", "int8"),
                                         ("int4", "int8"), ("int4", "int4")])
def test_quantized_step_matches_jax(cross, self_):
    """8 chained decode_step calls at f32 activations from the same cache:
    argmax equal every step, logits within 1e-4, alignment probabilities
    within 1e-5, ring values within one LSB."""
    from crisperwhisper_tpu.models import (alignment_selector,
                                           decode_step as jstep, init_cache)
    from crisperwhisper_tpu_torch.models import whisper as W
    arch, jq, tq, _ = quantized_tiny()
    enc = _encoder_out(arch, jq, 2)
    jdt = {"int8": jnp.int8, "int4": jnp.int4, None: None}
    jc = init_cache(jq, arch, jnp.asarray(enc), cross_dtype=jdt[cross],
                    cache_len=16, self_dtype=jdt[self_])
    pc = cache_from_jax(jc)
    sel = alignment_selector(arch, ((0, 1), (1, 3), (0, 2)))
    toks = np.asarray([7, 11], np.int32)
    for i in range(8):
        la, jc, aa = jstep(jq, arch, jnp.asarray(toks), jnp.int32(i), jc,
                           align_sel=jnp.asarray(sel))
        lb, pc, ab = W.decode_step(tq, arch, torch.from_numpy(toks), i, pc,
                                   align_sel=sel)
        la, lb = np.asarray(la), lb.numpy()
        assert (la.argmax(-1) == lb.argmax(-1)).all(), i
        np.testing.assert_allclose(lb, la, atol=1e-4)
        np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=1e-5)
        ref = cache_from_jax(jc)
        if self_ is not None:
            for name in ("self_k", "self_v"):
                assert (W.cache_values(getattr(ref, name)).int()
                        - W.cache_values(getattr(pc, name)).int()
                        ).abs().max() <= 1
        else:
            torch.testing.assert_close(pc.self_k, ref.self_k, atol=1e-5,
                                       rtol=1e-5)
        toks = la.argmax(-1).astype(np.int32)


def test_load_pipeline_quantize_options(tmp_path):
    """quantize=True / "serving" quantize the decoder (fused QKV, int8,
    bf16 scales) and set the reference's cache options; other strings are
    refused."""
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from torch_port_fixtures import write_tiny_checkpoint
    ckpt = write_tiny_checkpoint(str(tmp_path / "ckpt"))
    p8 = load_pipeline(ckpt, dtype=torch.float32, device="cpu",
                       quantize=True)
    ps = load_pipeline(ckpt, dtype=torch.float32, device="cpu",
                       quantize="serving")
    lay = ps.params["decoder"]["layers"][0]
    assert lay["self"]["qkv"]["w_q"].dtype == torch.int8
    assert lay["self"]["qkv"]["w_scale"].dtype == torch.bfloat16
    assert "w_q" in lay["mlp"]["fc2"] and "w" not in lay["cross"]["k"]
    assert (p8.gen_opts.kv_cache_int8, p8.gen_opts.kv_cache_int4,
            p8.gen_opts.self_kv_cache_int8) == (True, False, False)
    assert (ps.gen_opts.kv_cache_int8, ps.gen_opts.kv_cache_int4,
            ps.gen_opts.self_kv_cache_int8) == (False, True, True)
    with pytest.raises(ValueError):
        load_pipeline(ckpt, device="cpu", quantize="int4")
    # the quantize flag leaves a given parameter tree as it was
    base = load_pipeline(ckpt, dtype=torch.float32, device="cpu")
    load_pipeline(ckpt, device="cpu", params=base.params, quantize=True)
    assert "w" in base.params["decoder"]["layers"][0]["self"]["q"]
