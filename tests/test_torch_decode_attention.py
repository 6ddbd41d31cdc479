"""The port's decode-attention kernels' plain twins (the CPU path of
crisperwhisper_tpu_torch.ops.decode_attention) against the JAX experiment
kernels, and the port's quantized attention against the JAX oracle
(ops/int8_reference.py's dequant_reference), on the same inputs.

The experiments are not a package: each is loaded from its file. v1 and
v2 are jitted without an interpret switch, so they run interpreted by
patching ``pl.pallas_call`` around the unjitted function (as
tests/test_pallas_kernels.py does); v3 takes ``interpret=True`` and the
sequence-last cache [L, B, H, Dh, T], so the port's [L, B, H, T, Dh]
values are transposed for it, and the s4 case hands it the same int
values as ``jnp.int4``.

Tolerances: probabilities and aligned rows 1e-6 absolute (f32 sums in
other orders); out 1e-4 of its largest magnitude. The scaled
probabilities round to bf16 before P.V, and a rounding that flips
between the two softmaxes would move out by one bf16 step of one term
(up to 4e-3 of it); these seeds flip none, and out agrees within 1e-6.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crisperwhisper_tpu_torch.models.whisper import (pack_int4,
                                                     quantized_attention)
from crisperwhisper_tpu_torch.ops import decode_attention as da
from torch_port_fixtures import one_torch_thread  # noqa: F401

PROBS_BAND = 1e-6
OUT_REL_BAND = 1e-4
B, H, K, D = 2, 4, 40, 64
L, T = 2, 48
_EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_exp_{name}", os.path.join(_EXPERIMENTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def experiments():
    return {n: _load(n) for n in ("decode_attention_v1", "decode_attention_v2",
                                  "decode_gemv_v3")}


def _interpreted(fn, *args):
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return fn.__wrapped__(*args)
    finally:
        pl.pallas_call = orig


def _q(rng, shape, dtype):
    q = (rng.standard_normal(shape) / 8).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    return jnp.asarray(q), torch.from_numpy(q)


def _scales(rng, shape, qmax):
    s = (rng.uniform(1.0, 2.0, shape) * 1.5 / qmax).astype(np.float32)
    return jnp.asarray(s, jnp.bfloat16), torch.from_numpy(s).bfloat16()


def _close(got_out, ref_out, probs=()):
    ref_out = np.asarray(jnp.asarray(ref_out, jnp.float32))
    got_out = got_out.float().numpy()
    assert got_out.shape == ref_out.shape
    assert np.abs(got_out - ref_out).max() <= \
        OUT_REL_BAND * np.abs(ref_out).max()
    for got, ref in probs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=0, atol=PROBS_BAND)


def _int8_cache(rng):
    kq, vq = (rng.integers(-127, 128, (B, H, K, D), dtype=np.int8)
              for _ in range(2))
    return kq, vq, _scales(rng, (B, H, K, 1), 127), \
        _scales(rng, (B, H, K, 1), 127)


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
def test_cross_attention_int8_matches_jax(experiments, version, q_dtype):
    rng = np.random.default_rng(0)
    kq, vq, (ksj, kst), (vsj, vst) = _int8_cache(rng)
    qj, qt = _q(rng, (B, H, 1, D), q_dtype)
    if version == "v1":
        ref = _interpreted(experiments["decode_attention_v1"]
                           .cross_attention_int8,
                           qj, jnp.asarray(kq), ksj, jnp.asarray(vq), vsj)
        got = da.cross_attention_int8(qt, torch.from_numpy(kq), kst,
                                      torch.from_numpy(vq), vst)
    else:
        ref = _interpreted(experiments["decode_attention_v2"]
                           .cross_attention_int8_v2,
                           qj, jnp.asarray(kq), ksj, jnp.asarray(vq), vsj)
        got = da.cross_attention_int8_v2(qt, torch.from_numpy(kq), kst,
                                         torch.from_numpy(vq), vst)
    assert got[0].dtype == qt.dtype and got[1].dtype == torch.float32
    assert tuple(got[1].shape) == (B, H, K)
    _close(got[0], ref[0], [(got[1], ref[1])])


def test_v1_and_v2_keep_their_q_rounding():
    """With an f32 q, v1 multiplies q as it is and v2 rounds it to bf16
    first: the two outputs differ by far more than the band, as the JAX
    kernels' do."""
    rng = np.random.default_rng(0)
    kq, vq, (_, kst), (_, vst) = _int8_cache(rng)
    _, qt = _q(rng, (B, H, 1, D), "f32")
    args = (qt, torch.from_numpy(kq), kst, torch.from_numpy(vq), vst)
    o1, _ = da.cross_attention_int8(*args)
    o2, _ = da.cross_attention_int8_v2(*args)
    assert (o1 - o2).abs().max() > 10 * OUT_REL_BAND * o1.abs().max()
    o2_bf16, _ = da.cross_attention_int8(qt.bfloat16().float(), *args[1:])
    assert torch.equal(o2, o2_bf16)


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tq", [1, 3])
def test_quantized_attention_matches_jax_oracle(q_dtype, tq):
    """The JAX package's serving oracle (dequant_reference: scales folded
    out of both products, any query length) is the port's
    ``models.whisper.quantized_attention`` with [B, H, K] scales."""
    from crisperwhisper_tpu.ops.int8_reference import dequant_reference
    rng = np.random.default_rng(1)
    kq, vq, (ksj, kst), (vsj, vst) = _int8_cache(rng)
    qj, qt = _q(rng, (B, H, tq, D), q_dtype)
    ref = dequant_reference(qj, jnp.asarray(kq), ksj, jnp.asarray(vq), vsj)
    got = quantized_attention(qt, torch.from_numpy(kq),
                              torch.from_numpy(vq), kst[..., 0], vst[..., 0])
    assert got[0].dtype == qt.dtype
    _close(got[0], ref[0], [(got[1], ref[1])])


_GEMV_CASES = {
    # name: (cache kind, q dtype, scales, position, key mask, sel)
    "s8-bf16-scales-sel": ("s8", "bf16", True, None, False, True),
    "s8-f32-scales-position-mask": ("s8", "f32", True, 30, True, False),
    "s4-bf16-all-options": ("s4", "bf16", True, 30, True, True),
    "s4-f32-scales-position-past-T": ("s4", "f32", True, 100, False, True),
    "bf16-bf16-position": ("bf16", "bf16", False, 20, False, False),
    "bf16-f32-mask-sel": ("bf16", "f32", False, None, True, True),
    "f32-f32-no-options": ("f32", "f32", False, None, False, False),
    "f32-bf16-mask-sel": ("f32", "bf16", False, None, True, True),
}


@pytest.mark.parametrize("case", list(_GEMV_CASES))
def test_decode_gemv_attention_matches_jax(experiments, case):
    """One layer of a stacked cache of every kind, with and without each
    option. The key mask masks every key of row 1, whose probabilities are
    then uniform over T on both sides."""
    kind, q_dtype, scales, position, mask, sel = _GEMV_CASES[case]
    rng = np.random.default_rng(sorted(_GEMV_CASES).index(case))
    shape = (L, B, H, T, D)
    if kind in ("s8", "s4"):
        qmax = 7 if kind == "s4" else 127
        ki, vi = (rng.integers(-qmax, qmax + 1, shape, dtype=np.int8)
                  for _ in range(2))
        jdt = jnp.int4 if kind == "s4" else jnp.int8
        kt, vt = ((pack_int4(torch.from_numpy(x)) if kind == "s4"
                   else torch.from_numpy(x)) for x in (ki, vi))
    else:
        qmax = 127
        ki, vi = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        kt, vt = ((torch.from_numpy(x).bfloat16() if kind == "bf16"
                   else torch.from_numpy(x)) for x in (ki, vi))
    kj, vj = (jnp.asarray(np.swapaxes(x, -1, -2)).astype(jdt)
              for x in (ki, vi))
    qj, qt = _q(rng, (B, H, D), q_dtype)
    jkw, tkw = {}, {}
    if scales:
        (jkw["k_scale"], tkw["k_scale"]), (jkw["v_scale"], tkw["v_scale"]) \
            = (_scales(rng, (L, B, H, T), qmax) for _ in range(2))
    if position is not None:
        jkw["position"] = tkw["position"] = position
    if mask:
        m = rng.random((B, T)) > 0.3
        m[1] = False
        jkw["key_mask"], tkw["key_mask"] = jnp.asarray(m), torch.from_numpy(m)
    if sel:
        s = np.zeros((H, 3), np.float32)
        s[1, 0] = s[3, 2] = 1.0            # column 1: no head, all zero
        jkw["sel"], tkw["sel"] = jnp.asarray(s), torch.from_numpy(s)
    ref = experiments["decode_gemv_v3"].decode_gemv_attention(
        qj, kj, vj, 1, interpret=True, **jkw)
    got = da.decode_gemv_attention(qt, kt, vt, 1, **tkw)
    if sel:
        assert got[0].dtype == torch.float32
        assert tuple(got[1].shape) == (B, 3, T)
        assert not got[1][:, 1].any()
        _close(got[0], ref[0], [(got[1], ref[1])])
    else:
        assert got.dtype == torch.float32
        _close(got, ref)
    if mask:
        _, probs = da.decode_gemv_attention(
            qt, kt, vt, 1, **{**tkw, "sel": torch.eye(H)})
        assert torch.allclose(probs[1], torch.full((H, T), 1.0 / T),
                              rtol=0, atol=PROBS_BAND)


def test_decode_gemv_attention_sums_heads_sharing_a_sel_column(experiments):
    """A sel column with two heads gives their weighted sum of
    probabilities, as the reference's einsum does."""
    rng = np.random.default_rng(11)
    ki, vi = (rng.integers(-127, 128, (L, B, H, T, D), dtype=np.int8)
              for _ in range(2))
    kj, vj = (jnp.asarray(np.swapaxes(x, -1, -2)) for x in (ki, vi))
    qj, qt = _q(rng, (B, H, D), "bf16")
    (ksj, kst), (vsj, vst) = (_scales(rng, (L, B, H, T), 127)
                              for _ in range(2))
    s = np.zeros((H, 2), np.float32)
    s[0, 0], s[2, 0], s[3, 1] = 1.0, 0.5, 1.0
    ref = experiments["decode_gemv_v3"].decode_gemv_attention(
        qj, kj, vj, 0, k_scale=ksj, v_scale=vsj, sel=jnp.asarray(s),
        interpret=True)
    out, aligned = da.decode_gemv_attention(
        qt, torch.from_numpy(ki), torch.from_numpy(vi), 0, k_scale=kst,
        v_scale=vst, sel=torch.from_numpy(s))
    _close(out, ref[0], [(aligned, ref[1])])
    _, probs = da.decode_gemv_attention(
        qt, torch.from_numpy(ki), torch.from_numpy(vi), 0, k_scale=kst,
        v_scale=vst, sel=torch.eye(H))
    assert torch.allclose(aligned[:, 0], probs[:, 0] + 0.5 * probs[:, 2],
                          rtol=0, atol=PROBS_BAND)


def test_cpu_wrappers_refuse_other_devices():
    q = torch.zeros((1, 1, 1, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.cross_attention_int8(q, q, q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_gemv_attention(q[0], q, q, 0)
