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


# --- one-token steps through kernel 9 (ops/decode_attention.py) ----------
#
# A one-token step reads each layer's single-query attention through
# bind_decode_gemv (on the CPU, the plain twin decode_gemv_plain) against
# the stacked caches. The oracle is the step on the plain path with the
# bodies below, copies of models/whisper's ``attention`` and
# ``quantized_attention`` as the step called them before: the same rounding
# points, so at f32 with the ring full (the same keys on both sides) the
# step is equal bit for bit, and elsewhere within the bands below.

def _oracle_attention(q, k, v, mask=None):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v), probs


def _oracle_quantized_attention(q, k, v, k_scale, v_scale, mask=None):
    from crisperwhisper_tpu_torch.models.whisper import cache_values
    kv = cache_values(k).float()
    s = torch.matmul(q.float(), kv.transpose(-1, -2)) \
        * k_scale.float()[:, :, None, :]
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    p = torch.softmax(s, dim=-1)
    pv = (p * v_scale.float()[:, :, None, :]).to(q.dtype)
    out = torch.matmul(pv.float(), cache_values(v).float())
    return out.to(q.dtype), p


# kind: (activation dtype, cross cache, self ring)
_GEMV_KINDS = {"f32": (torch.float32, None, None),
               "bf16": (torch.bfloat16, None, None),
               "int8-cross": (torch.float32, "int8", None),
               "int4-cross-bf16": (torch.bfloat16, "int4", None),
               "int8-ring": (torch.float32, "int8", "int8"),
               "int4-ring-bf16": (torch.bfloat16, "int4", "int4")}
# variant: (alignment heads, key mask); "two" puts two heads of layer 0 on
# slots 0 and 2 and one of layer 1 on slot 1
_GEMV_VARIANTS = {"no-heads": ((), False),
                  "one-head": (((1, 2),), False),
                  "two-heads-key-mask": (((0, 3), (1, 2), (0, 1)), True)}
_RING, _ROWS, _K_ENC = 12, 3, 20
# (logits over their largest, alignment rows) where the two sides read
# rings of other lengths and may sum in other orders: f32 a few ulps; bf16
# one epsilon, where the step rounds its P.V product to bf16 after the sum
# (on the CPU both sides are in fact equal bit for bit in every case)
_GEMV_BANDS = {torch.float32: (1e-6, 1e-7), torch.bfloat16: (2 ** -8, 1e-3)}


def _fill_ring(ring, scales, g):
    """Random values in every slot of a ring (and its bf16 scales), so a
    key after the position that the step failed to mask would show."""
    from crisperwhisper_tpu_torch.models import whisper as W
    x = torch.randn(ring.shape[:4] + (16,), generator=g)
    with torch.inference_mode():          # init_cache's tensors
        if scales is None:
            ring.copy_(x.to(ring.dtype))
            return
        q, s = W._quantize(x, 7.0 if ring.dtype == torch.uint8 else 127.0)
        ring.copy_(W.pack_int4(q) if ring.dtype == torch.uint8 else q)
        scales.copy_(s)


def _gemv_case(kind, variant, position):
    """(params, arch, tokens, cache, align_sel, key_mask) of one step."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.models import whisper as W
    dtype, cross, ring = _GEMV_KINDS[kind]
    heads, masked = _GEMV_VARIANTS[variant]
    arch = tiny_arch()
    g = torch.Generator().manual_seed(position + 7)
    params = testing.random_affine(W.init_params(arch, g, dtype=dtype), 3)
    enc = torch.randn((_ROWS, _K_ENC, arch.d_model), generator=g).to(dtype)
    cache = W.init_cache(params, arch, enc, cache_len=_RING,
                         cross_dtype=cross, self_dtype=ring)
    _fill_ring(cache.self_k, cache.self_k_scale, g)
    _fill_ring(cache.self_v, cache.self_v_scale, g)
    key_mask = None
    if masked:
        key_mask = torch.rand((_ROWS, _RING), generator=g) > 0.3
        key_mask[:, position] = True
    tokens = torch.randint(0, arch.vocab_size, (_ROWS,), generator=g)
    sel = W.alignment_selector(arch, heads) if heads else None
    return params, arch, tokens, cache, sel, key_mask


@pytest.mark.parametrize("position", [0, _RING // 2, _RING - 1])
@pytest.mark.parametrize("variant", list(_GEMV_VARIANTS))
@pytest.mark.parametrize("kind", list(_GEMV_KINDS))
def test_one_token_step_through_kernel_9_matches_the_plain_step(
        monkeypatch, kind, variant, position):
    """decode_step routed through kernel 9's twin against the oracle step:
    logits and alignment rows equal at f32 with the ring full, within the
    dtype's band elsewhere; the written ring columns equal everywhere."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.models import whisper as W
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    params, arch, tokens, cache, sel, key_mask = _gemv_case(kind, variant,
                                                            position)
    ref_cache = testing.clone_cache(cache)
    calls = []
    plain = da.decode_gemv_plain
    monkeypatch.setattr(da, "decode_gemv_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    got = W.decode_step(params, arch, tokens, position, cache,
                        align_sel=sel, key_mask=key_mask)
    assert len(calls) == 2 * arch.decoder_layers
    with monkeypatch.context() as m:
        m.setattr(W, "bind_decode_gemv", lambda *a, **kw: None)
        m.setattr(W, "attention", _oracle_attention)
        m.setattr(W, "quantized_attention", _oracle_quantized_attention)
        ref = W.decode_step(params, arch, tokens, position, ref_cache,
                            align_sel=sel, key_mask=key_mask)
    assert len(calls) == 2 * arch.decoder_layers
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        a, b = getattr(cache, name), getattr(ref_cache, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(
            a, b)), name
    (lg, _, ag), (lr, _, ar) = got, ref
    assert lg.dtype == lr.dtype == ag.dtype == ar.dtype == torch.float32
    assert lg.shape == lr.shape and ag.shape == ar.shape
    if sel is None:
        assert not ag.any()
    dtype = _GEMV_KINDS[kind][0]
    if dtype == torch.float32 and position == _RING - 1:
        assert torch.equal(lg, lr) and torch.equal(ag, ar)
    rel, band = _GEMV_BANDS[dtype]
    assert (lg - lr).abs().max() <= rel * lr.abs().max()
    assert (ag - ar).abs().max() <= band
    assert da.decode_gemv_attention.launches == 0     # CPU: the plain twin


@pytest.mark.parametrize("path", ["step", "beams", "row-positions",
                                  "multi"])
def test_kernel_9_dispatch_by_tokens_positions_and_beams(monkeypatch, path):
    """Calls of kernel 9's entry a step, by half: both halves of every
    layer in a one-token step at a scalar position; the self half alone
    with beams (their cross attention rides the item's rows); the cross
    half alone at per-row positions; none in a block of tokens."""
    from crisperwhisper_tpu_torch.models import whisper as W
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    params, arch, tokens, cache, sel, _ = _gemv_case("f32", "two-heads-"
                                                     "key-mask", 4)
    halves = []
    plain = da.decode_gemv_plain

    def spy(q, k_stack, *a, **kw):
        halves.append("self" if k_stack is cache.self_k else "cross")
        return plain(q, k_stack, *a, **kw)
    monkeypatch.setattr(da, "decode_gemv_plain", spy)
    n = arch.decoder_layers
    if path == "step":
        W.decode_step(params, arch, tokens, 4, cache, align_sel=sel)
        want = {"self": n, "cross": n}
    elif path == "beams":
        beams = W.init_cache(params, arch, torch.randn(
            (1, _K_ENC, arch.d_model)), cache_len=_RING,
            self_batch=_ROWS)
        cache.self_k, cache.self_v = beams.self_k, beams.self_v
        cache.cross_k, cache.cross_v = beams.cross_k, beams.cross_v
        W.decode_step(params, arch, tokens, 4, cache, align_sel=sel,
                      beam_groups=_ROWS)
        want = {"self": n, "cross": 0}
    elif path == "row-positions":
        W.decode_step(params, arch, tokens,
                      torch.tensor([4, 2, 7], dtype=torch.int32), cache,
                      align_sel=sel)
        want = {"self": 0, "cross": n}
    else:
        W.decode_step_multi(params, arch, tokens[:, None].repeat(1, 3), 4,
                            cache, align_sel=sel)
        want = {"self": 0, "cross": 0}
    assert {h: halves.count(h) for h in want} == want


@pytest.mark.parametrize("case", ["f16-q", "f32-cache-bf16-q",
                                  "int8-without-scales", "key-mask-shape",
                                  "too-many-keys"])
def test_bind_decode_gemv_declines_what_the_step_must_not_route(case):
    """bind_decode_gemv returns None (the step keeps its plain path) where
    kernel 9 would not compute the plain step's function: a q dtype it
    has no route for, a float cache in another dtype than q (the kernel
    would round it to q's), a quantized cache without scales, a key mask
    that is not [B, T], more keys than the kernel takes; and binds the
    TINY caches (head dim 16) on the CPU, where the plain twin runs."""
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    shape = (2, 3, 4, 8, 16)
    f32 = torch.zeros(shape)
    i8 = torch.zeros(shape, dtype=torch.int8)
    sc = torch.zeros(shape[:4], dtype=torch.bfloat16)
    assert da.bind_decode_gemv(torch.float32, f32, f32) is not None
    assert da.bind_decode_gemv(torch.bfloat16, i8, i8, sc, sc) is not None
    args = {"f16-q": (torch.float16, f32.half(), f32.half()),
            "f32-cache-bf16-q": (torch.bfloat16, f32, f32),
            "int8-without-scales": (torch.float32, i8, i8),
            "key-mask-shape": (torch.float32, f32, f32, None, None,
                               torch.ones((3, 9), dtype=torch.bool)),
            "too-many-keys": (torch.float32,) + (torch.zeros(
                (1, 1, 1, da.MAX_KEYS + 1, 16)),) * 2}[case]
    assert da.bind_decode_gemv(*args) is None


# --- the one-token step at a position held on the device -----------------
#
# The greedy loop's CUDA graph (decoding/greedy.py) replays one step at
# every position, so the step reads its position from a 0-d int32 tensor
# on the device: kernel 9 masks by it there, the ring write takes it as
# every row's, the learned-position lookup indexes by it. On the CPU the
# same step runs through the plain twins, and must give the int
# position's bytes.

@pytest.mark.parametrize("position,offset", [(0, False), (_RING // 2, True),
                                             (_RING - 1, False)])
@pytest.mark.parametrize("variant", list(_GEMV_VARIANTS))
@pytest.mark.parametrize("kind", list(_GEMV_KINDS))
def test_one_token_step_at_a_device_position_equals_the_int_position(
        monkeypatch, kind, variant, position, offset):
    """Logits, aligned rows and every cache byte equal, bit for bit, with
    and without a position offset (the conditioned prompt's shift of the
    learned lookup); the device position's ring write is the per-row
    write, once a layer."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.models import whisper as W
    params, arch, tokens, cache, sel, key_mask = _gemv_case(kind, variant,
                                                            position)
    writes = []
    write = W.write_block_columns_group
    monkeypatch.setattr(W, "write_block_columns_group",
                        lambda *a: writes.append(a[2]) or write(*a))
    pos_offset = (torch.tensor([0, 1, position], dtype=torch.int32)
                  if offset else None)
    by_int = testing.clone_cache(cache)
    want = W.decode_step(params, arch, tokens, position, by_int,
                         align_sel=sel, key_mask=key_mask,
                         pos_offset=pos_offset)
    got = W.decode_step(params, arch, tokens,
                        torch.tensor(position, dtype=torch.int32), cache,
                        align_sel=sel, key_mask=key_mask,
                        pos_offset=pos_offset)
    assert len(writes) == arch.decoder_layers
    assert all(w.tolist() == [position] * _ROWS for w in writes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale",
                 "cross_k", "cross_v"):
        a, b = getattr(cache, name), getattr(by_int, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(
            a, b)), name


def test_a_device_position_needs_kernel_9():
    """Where kernel 9 declines the caches (here, bound to decline) a
    device position has no plain path that could read it: the step
    refuses it rather than read it back."""
    from crisperwhisper_tpu_torch.models import whisper as W
    params, arch, tokens, cache, sel, _ = _gemv_case("f32", "no-heads", 3)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(W, "bind_decode_gemv", lambda *a, **kw: None)
        with pytest.raises(ValueError, match="needs kernel 9"):
            W.decode_step(params, arch, tokens,
                          torch.tensor(3, dtype=torch.int32), cache)


@pytest.mark.parametrize("case,reason", [
    ("bulk", "not on a CUDA card"),
    ("no-key-mask", "not on a CUDA card"),
    ("serving-caches", "not on a CUDA card"),
    ("shard", "a tensor-parallel shard"),
    ("f16-ring", "kernel 9 declines the caches"),
    ("f16-cross", "kernel 9 declines the caches"),
    ("too-many-keys", "kernel 9 declines the caches"),
    ("speech-lm", "a speech LM's step"),
    ("kernel-5", "the whole-step kernel")])
def test_step_graph_gate_reads_what_the_inputs_show(case, reason):
    """The greedy loop's decision to capture its step as a CUDA graph: at
    the bulk shape (bf16 caches, alignment heads, a key mask), without a
    key mask, and on serving's int8 ring and int4 cross cache every check
    holds but the card's, which the CPU fails (on the card the gate
    opens: tests/test_torch_gpu.py); each other case fails its own
    check."""
    from dataclasses import replace as dc_replace
    from crisperwhisper_tpu_torch.decoding.greedy import step_graph_refusal
    from crisperwhisper_tpu_torch.models import speech_moe
    from crisperwhisper_tpu_torch.ops import decode_attention as da
    from crisperwhisper_tpu_torch.parallel.mesh import REDUCE
    kind, variant = {"no-key-mask": ("bf16", "one-head"),
                     "serving-caches": ("int4-ring-bf16", "one-head")}.get(
                         case, ("bf16", "two-heads-key-mask"))
    params, arch, _, cache, _, key_mask = _gemv_case(kind, variant, 4)
    if case == "shard":
        layer0 = dict(params["decoder"]["layers"][0])
        layer0["self"] = dict(layer0["self"])
        layer0["self"]["o"] = {**layer0["self"]["o"], REDUCE: object()}
        params = {**params, "decoder": {
            **params["decoder"],
            "layers": [layer0] + params["decoder"]["layers"][1:]}}
    elif case == "f16-ring":
        cache = dc_replace(cache, self_k=cache.self_k.half(),
                           self_v=cache.self_v.half())
    elif case == "f16-cross":
        cache = dc_replace(cache, cross_k=cache.cross_k.half(),
                           cross_v=cache.cross_v.half())
    elif case == "too-many-keys":
        ring = cache.self_k.shape[:3] + (da.MAX_KEYS + 1,) \
            + cache.self_k.shape[4:]
        cache = dc_replace(cache, self_k=torch.zeros(ring).bfloat16(),
                           self_v=torch.zeros(ring).bfloat16())
        key_mask = None
    elif case == "speech-lm":
        arch = speech_moe.SpeechMoEArch(audio=arch)
    assert step_graph_refusal(params, arch, cache, key_mask,
                              case == "kernel-5") == reason
