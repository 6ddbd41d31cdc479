"""PyTorch port: the whole-step quantized decoder (ops/decode_step.py)
against the JAX package's TPU kernel (ops/pallas_decode_b1.py, run in
interpret mode as its own tests run it), its gates, and the quantized
serving slice (hub -> pipeline -> CLI) in both kernel modes.

On the CPU ``whole_step`` runs its plain version. It and the JAX kernel
are the same f32 algebra summed in other orders: logits agree within
1e-4 and alignment probabilities within 1e-5, argmax is equal every step,
and a fresh ring column may differ by one int8 step where a value falls
on a rounding boundary (its bf16 scale then by one bf16 step)."""

import json
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import rand_mel
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import (CHUNK_S, SR, TS_BAND, cache_from_jax,
                                 quantized_tiny, tone_audio,
                                 write_tiny_checkpoint, write_wav)

_SEL = ((0, 1), (1, 2))


def _caches(arch, jq, batch, cross, ring=32):
    """Equal JAX and port caches (the JAX one carried across)."""
    from crisperwhisper_tpu.models import encode, init_cache
    enc = encode(jq, arch, jnp.asarray(rand_mel(batch, 5)))
    jc = init_cache(jq, arch, enc, cross_dtype=cross, cache_len=ring,
                    self_dtype=jnp.int8)
    return jc, cache_from_jax(jc)


def _assert_step(la, lb, aa, ab, jc, pc, pos):
    la, lb = np.asarray(la), lb.numpy()
    assert la.shape == lb.shape
    assert (la.argmax(-1) == lb.argmax(-1)).all(), pos
    np.testing.assert_allclose(lb, la, atol=1e-4)
    assert np.asarray(aa).shape == tuple(ab.shape)
    np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=1e-5)
    ref = cache_from_jax(jc)
    for name in ("self_k", "self_v"):                 # fresh columns
        a = getattr(pc, name)[:, :, :, pos].int()
        b = getattr(ref, name)[:, :, :, pos].int()
        assert (a - b).abs().max() <= 1, (name, pos)
        assert torch.equal(getattr(pc, name)[:, :, :, :pos],
                           getattr(ref, name)[:, :, :, :pos])
    for name in ("self_k_scale", "self_v_scale"):
        torch.testing.assert_close(getattr(pc, name).float(),
                                   getattr(ref, name).float(),
                                   rtol=2 ** -7, atol=0)
    return la.argmax(-1)


@pytest.mark.parametrize("cross", [jnp.int8, jnp.int4])
def test_b1_plain_matches_jax_kernel(cross):
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    jc, pc = _caches(arch, jq, 1, cross)
    sel = alignment_selector(arch, _SEL)
    tok = np.asarray([7], np.int32)
    for i in range(4):
        la, jc, aa = J.decode_step_b1(jq, arch, jnp.asarray(tok),
                                      jnp.int32(i), jc,
                                      align_sel=jnp.asarray(sel),
                                      interpret=True)
        lb, pc, ab = T.decode_step_b1(tq, arch, torch.from_numpy(tok), i, pc,
                                      align_sel=sel)
        tok = _assert_step(la, lb, aa, ab, jc, pc, i).astype(np.int32)
    assert T.whole_step.launches == 0              # CPU: the plain version


def test_rows_plain_matches_jax_kernel():
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    jc, pc = _caches(arch, jq, 3, jnp.int4)
    sel = alignment_selector(arch, _SEL)
    toks = np.asarray([5, 9, 13], np.int32)
    for i in range(3):
        la, jc, aa = J.decode_step_rows(jq, arch, jnp.asarray(toks),
                                        jnp.int32(i), jc,
                                        align_sel=jnp.asarray(sel),
                                        interpret=True)
        lb, pc, ab = T.decode_step_rows(tq, arch, torch.from_numpy(toks), i,
                                        pc, align_sel=sel)
        toks = _assert_step(la, lb, aa, ab, jc, pc, i).astype(np.int32)


def test_multi_plain_matches_jax_kernel():
    """The verify-block mode (int4 cross cache, the serving layout): two
    4-token blocks, at position 0 (the block's own columns alone in the
    ring) and at 4 (after the first block's), on the JAX kernel in
    interpret mode and on the port's plain version, with the bands of the
    b1 mode: every row's argmax equal, logits within 1e-4, alignment rows
    within 1e-5, the S fresh columns at most one int8 step apart, older
    slots equal, scales within one bf16 step."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    jc, pc = _caches(arch, jq, 1, jnp.int4)
    sel = alignment_selector(arch, _SEL)
    for pos, block in ((0, [17, 19, 23, 29]), (4, [31, 37, 41, 43])):
        blk = np.asarray([block], np.int32)
        la, jc, aa = J.decode_step_b1_multi(jq, arch, jnp.asarray(blk),
                                            jnp.int32(pos), jc,
                                            align_sel=jnp.asarray(sel),
                                            interpret=True)
        lb, pc, ab = T.decode_step_b1_multi(tq, arch, torch.from_numpy(blk),
                                            pos, pc, align_sel=sel)
        la = np.asarray(la)
        assert la.shape == tuple(lb.shape) == (1, 4, arch.vocab_size)
        assert (la.argmax(-1) == lb.numpy().argmax(-1)).all(), pos
        np.testing.assert_allclose(lb.numpy(), la, atol=1e-4)
        assert np.asarray(aa).shape == tuple(ab.shape)
        np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=1e-5)
        ref = cache_from_jax(jc)
        end = pos + 4
        for name in ("self_k", "self_v"):
            a = getattr(pc, name)[:, :, :, pos:end].int()
            b = getattr(ref, name)[:, :, :, pos:end].int()
            assert (a - b).abs().max() <= 1, (name, pos)
            assert torch.equal(getattr(pc, name)[:, :, :, :pos],
                               getattr(ref, name)[:, :, :, :pos])
        for name in ("self_k_scale", "self_v_scale"):
            torch.testing.assert_close(getattr(pc, name).float(),
                                       getattr(ref, name).float(),
                                       rtol=2 ** -7, atol=0)
    assert T.whole_step.launches == 0              # CPU: the plain version


def test_multi_at_one_token_equals_b1_bitwise():
    """A one-token verify block is the b1 step, bit for bit: logits,
    alignment rows, ring columns and scales."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int4)
    sel = alignment_selector(arch, _SEL)
    for i, tok in enumerate((7, 11, 13)):
        _, pc, _ = T.decode_step_b1(tq, arch, torch.tensor([tok]), i, pc)
    c1, cm = testing.clone_cache(pc), testing.clone_cache(pc)
    l1, c1, a1 = T.decode_step_b1(tq, arch, torch.tensor([17]), 3, c1,
                                  align_sel=sel)
    lm, cm, am = T.decode_step_b1_multi(tq, arch, torch.tensor([[17]]), 3,
                                        cm, align_sel=sel)
    assert torch.equal(lm[:, 0], l1) and torch.equal(am[:, :, 0], a1)
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        assert torch.equal(getattr(cm, name), getattr(c1, name)), name


def test_multi_gate():
    """supported_multi: the b1 gate for a [1, S] block with S <= 8 rows
    whose S slots fit the ring."""
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int8, ring=32)

    def ok(tokens=torch.zeros((1, 5)), position=0, cache=pc, params=tq,
           key_mask=None):
        return T.supported_multi(params, arch, cache, key_mask, position,
                                 tokens)
    assert ok() and ok(torch.zeros((1, 8)), 24) and ok(torch.zeros((1, 1)))
    assert not ok(torch.zeros((1, 9)))                    # 9 rows
    assert not ok(position=28)                            # past the ring
    assert not ok(torch.zeros((2, 5)))                    # two streams
    assert not ok(torch.zeros(5))                         # not a block
    assert not ok(position=torch.zeros(1, dtype=torch.int32))
    assert not ok(key_mask=torch.ones((1, 32), dtype=torch.bool))
    _, rows = _caches(arch, jq, 3, jnp.int8, ring=32)
    assert not ok(cache=rows)
    _, _, _, unfused = quantized_tiny(fused=False)
    assert not ok(params=unfused)


def test_bf16_alignment_capture_rounds():
    """align_dtype=bf16 rounds each captured probability to bf16, as the
    reference kernel does for its bf16 serving capture."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int8)
    sel = alignment_selector(arch, _SEL)
    x0 = torch.randn((1, arch.d_model), generator=torch.Generator()
                     .manual_seed(0))
    heads = T._heads(sel)
    _, a32 = T.whole_step(tq, arch, x0, 0, pc, heads)
    _, a16 = T.whole_step(tq, arch, x0, 0, pc, heads, align_bf16=True)
    assert torch.equal(a16, a32.to(torch.bfloat16).float())
    assert heads == ((0, 1), (1, 2)) and T._heads(None) == (None,)


@pytest.mark.parametrize("rows", [1, 3])
def test_plain_rounds_ties_half_to_even(rows):
    """testing.tie_params puts layer 0's fresh K/V values on the int8
    ties, where rounding half away from zero would differ; the plain
    version (run by the card's kernel check as its reference) rounds them
    half-to-even with the exact scale."""
    from crisperwhisper_tpu_torch import testing
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, rows, jnp.int4)
    b = testing.tie_params(tq, arch)["decoder"]["layers"][0]["self"]["qkv"]
    v = b["b"][arch.d_model:].numpy() / testing.TIE_UNIT
    assert (np.sign(v) * np.floor(np.abs(v) + 0.5) != np.rint(v)).any()
    assert not b["w_q"][arch.d_model:].any()
    x0 = torch.randn((rows, arch.d_model),
                     generator=torch.Generator().manual_seed(rows))
    assert testing.tie_column_error(tq, arch, x0, 5, pc, plain=True) == 0
    assert testing.tie_column_error(tq, arch, x0, 5, pc) == 0   # CPU: plain


def test_fresh_column_divergence_finds_the_first_flip(monkeypatch):
    """testing.fresh_column_divergence (the card's position-0 scan) finds
    no divergence where both sides are the plain step (the CPU), and
    names the one V value moved an int8 step in layer 1 of a stand-in
    kernel, with the plain value before rounding that rounds to it."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int4)
    x0 = torch.randn((1, arch.d_model),
                     generator=torch.Generator().manual_seed(7))
    assert testing.fresh_column_divergence(tq, arch, x0, 5, pc) == {
        "cells": [0] * arch.decoder_layers,
        "scales": [0] * arch.decoder_layers, "first": None,
        "first_v": None, "first_scale": None, "at": {}}
    plain = T.whole_step

    def kernel(params, arch_, x0_, position, cache, heads, **kw):
        out = plain(params, arch_, x0_, position, cache, heads, **kw)
        if arch_.decoder_layers == 2:
            v = cache.self_v[1, 0, 2, position, 5]
            cache.self_v[1, 0, 2, position, 5] = v - 1 if v > 0 else v + 1
        return out
    monkeypatch.setattr(T, "whole_step", kernel)
    div = testing.fresh_column_divergence(tq, arch, x0, 5, pc)
    assert div["cells"] == [0, 1] and div["first"] == div["first_v"] == 1
    at = div["at"][1]
    assert list(div["at"]) == [1] and at["hid_in"] == at["shift"] == 0.0
    [(half, head, dim, kq, pq, u, margin, uk)] = at["flips"]
    assert (half, head, dim, abs(kq - pq)) == ("V", 2, 5, 1)
    assert round(u) == pq and margin == abs(abs(u) % 1.0 - 0.5) <= 0.5
    assert uk == u and at["scale_flips"] == []


def test_fresh_column_divergence_finds_the_first_scale_flip(monkeypatch):
    """A stand-in kernel that stores one V scale of layer 0 a bf16 step
    up: fresh_column_divergence names that layer's scale, with the plain
    f32 scale that rounds to the plain bf16 one, and no differing value."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int8)
    x0 = torch.randn((1, arch.d_model),
                     generator=torch.Generator().manual_seed(8))
    plain = T.whole_step

    def kernel(params, arch_, x0_, position, cache, heads, **kw):
        out = plain(params, arch_, x0_, position, cache, heads, **kw)
        if arch_.decoder_layers == 2:
            bits = cache.self_v_scale[0, 0, 2, position].view(torch.int16)
            cache.self_v_scale[0, 0, 2, position] = (bits + 1).view(
                torch.bfloat16)
        return out
    monkeypatch.setattr(T, "whole_step", kernel)
    div = testing.fresh_column_divergence(tq, arch, x0, 3, pc)
    assert div["first"] is None and div["first_scale"] == 0
    assert div["scales"] == [1, 0] and list(div["at"]) == [0]
    at = div["at"][0]
    assert at["flips"] == [] and at["hid_in"] == at["shift"] == 0.0
    [(half, head, ks, ps, u, margin, uk)] = at["scale_flips"]
    assert (half, head) == ("V", 2) and ks > ps and uk == u
    assert torch.tensor(u).to(torch.bfloat16).item() == ps
    assert 0.0 <= margin <= 0.5


def _fed_case(mode):
    """(params, arch, x0, position, cache, kw) of one mode on the TINY
    quantized decoder at position 0 (the fresh column alone in the
    ring), for the plain step fed columns."""
    from crisperwhisper_tpu_torch import testing
    arch, _, _, tq = quantized_tiny()
    rows = {"b1": 1, "rows": 3, "multi": 4, "beams": 3}[mode]
    gen = torch.Generator().manual_seed(11)
    cache = testing.random_step_cache(
        arch, 1 if mode == "multi" else rows, "int4", 32, 0, gen,
        shared_cross=mode == "beams")
    x0 = torch.randn((rows, arch.d_model), generator=gen)
    kw = {"multi": mode == "multi", "beams": mode == "beams"}
    return tq, arch, x0, cache, kw


@pytest.mark.parametrize("mode", ["b1", "rows", "multi", "beams"])
def test_plain_fed_its_own_columns_is_unchanged(mode):
    """whole_step_plain fed the fresh columns it wrote itself
    (testing.fresh_columns) gives the unfed step's hid, alignment rows and
    rings bit for bit, in every mode."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step_plain
    tq, arch, x0, cache, kw = _fed_case(mode)
    a, b = testing.clone_cache(cache), testing.clone_cache(cache)
    heads = ((0, 1), (1, 3))
    hid, align = whole_step_plain(tq, arch, x0, 0, a, heads, **kw)
    n = x0.shape[0] if kw["multi"] else 1
    fed = testing.fresh_columns(a, 0, n)
    hid2, align2 = whole_step_plain(tq, arch, x0, 0, b, heads, fresh=fed,
                                    **kw)
    assert torch.equal(hid, hid2) and torch.equal(align, align2)
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("mode", ["b1", "multi"])
def test_plain_fed_a_column_a_step_off_moves_hid(mode):
    """Fed one V value of layer 0 one int8 step off, the plain step
    writes that value into the ring and its hid moves: the argument is
    live. decode_step_errors (CPU: the kernel is the plain step) reads
    every error 0 with the fed compare in place of the unfed one at
    position 0."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops.decode_step import whole_step_plain
    tq, arch, x0, cache, kw = _fed_case(mode)
    a, b = testing.clone_cache(cache), testing.clone_cache(cache)
    hid, _ = whole_step_plain(tq, arch, x0, 0, a, (None,), **kw)
    n = x0.shape[0] if kw["multi"] else 1
    k, v, ks, vs = (t.clone() for t in testing.fresh_columns(a, 0, n))
    v[0, 0, 1, 3] += 1 if v[0, 0, 1, 3] < 127 else -1
    hid2, _ = whole_step_plain(tq, arch, x0, 0, b, (None,),
                               fresh=(k, v, ks, vs), **kw)
    assert b.self_v[0, 0, 1, 0, 3] == v[0, 0, 1, 3]
    assert not torch.equal(hid, hid2)
    errs = testing.decode_step_errors(tq, arch, x0, 0, cache, ((0, 1),),
                                      **kw)
    assert set(errs) == {"hid_fed", "align_fed", "columns_fed",
                         "columns_fed_apart", "scales_fed",
                         "scales_fed_apart", "logits"}
    assert all(e == 0 for e, _ in errs.values()), errs
    errs = testing.decode_step_errors(tq, arch, x0, 5, cache, ((0, 1),),
                                      **kw)
    assert {"hid", "align", "columns"} <= set(errs)


@pytest.mark.parametrize("mode", ["b1", "multi"])
@pytest.mark.parametrize("fault", ["amax_over_126", "scale_2^-8_over"])
def test_decode_step_errors_catch_a_wrong_fresh_scale(monkeypatch, mode,
                                                      fault):
    """A stand-in kernel whose fresh scales are off by under one percent,
    and which uses them in its own attention (amax / 126 for values and
    scale, or the bf16 scale stored 2^-8 over): fed its columns, the
    plain step reproduces its hid, and no value is more than an int8 step
    from the plain step's own. decode_step_errors fails it at position 0
    all the same, on how many of its fresh scales (and, for amax / 126,
    values) part from the plain step's own rounding."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import decode_step as T
    tq, arch, x0, cache, kw = _fed_case(mode)
    plain, quantize = T.whole_step, T._quantize

    def wrong(x, qmax):
        if fault == "amax_over_126":
            return quantize(x, qmax - 1)
        q, sc = quantize(x, qmax)
        return q, (sc.float() * (1 + 2 ** -8)).to(torch.bfloat16)

    def kernel(*args, **kwargs):
        monkeypatch.setattr(T, "_quantize", wrong)
        try:
            return plain(*args, **kwargs)
        finally:
            monkeypatch.setattr(T, "_quantize", quantize)
    monkeypatch.setattr(T, "whole_step", kernel)
    errs = testing.decode_step_errors(tq, arch, x0, 0, cache, ((0, 1),),
                                      **kw)
    over = {name for name, (err, band) in errs.items() if err > band}
    assert not over & {"hid_fed", "align_fed", "columns_fed", "logits"}
    assert "scales_fed_apart" in over, errs
    if fault == "amax_over_126":
        assert "columns_fed_apart" in over, errs


def test_wrapper_constants_match_the_kernel_source():
    """The wrapper's copies of csrc/decode_step.cu's constants, which its
    shared-memory gate and scratch size are computed from, equal the
    source's."""
    import re
    from pathlib import Path
    from crisperwhisper_tpu_torch.ops import decode_step as T
    src = (Path(T.__file__).parents[1] / "csrc"
           / "decode_step.cu").read_text()
    k = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        k[name] = eval(expr.replace("/", "//"), {}, dict(k))
    assert (T.THREADS, T.MAX_ROWS, T.SPLIT, T.MAX_SPLITS, T.ATTN_WARPS) == (
        k["kThreads"], k["kMaxRows"], k["kSplit"], k["kMaxSplits"],
        k["kAttnWarps"])
    assert T.SMEM_LIMIT == k["kMaxDynSmem"]
    assert T.THREADS // 2 == k["kHalf"]


def test_plain_multi_rounds_ties_half_to_even():
    """The same ties in the verify-block mode: all four fresh columns of
    a 4-token block round half-to-even with the exact scale."""
    from crisperwhisper_tpu_torch import testing
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int4)
    x0 = torch.randn((4, arch.d_model),
                     generator=torch.Generator().manual_seed(4))
    assert testing.tie_column_error(tq, arch, x0, 5, pc, plain=True,
                                    multi=True) == 0


def _gate_cases(arch, jq, tq, batch):
    """(name, JAX gate args, port gate args) for the reference's gate
    tests (tests/test_b1_kernel.py:107-127 and :472-505)."""
    from crisperwhisper_tpu.models import encode, init_cache
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu.models.quantize import quantize_decoder_weights
    from crisperwhisper_tpu_torch.models import whisper as W
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    enc = encode(jq, arch, jnp.asarray(rand_mel(batch, 1)))
    jc = init_cache(jq, arch, enc, cross_dtype=jnp.int8, cache_len=32,
                    self_dtype=jnp.int8)
    pc = cache_from_jax(jc)
    jbf = init_cache(jq, arch, enc, cache_len=32)
    pbf = W.init_cache(tq, arch, torch.from_numpy(np.array(enc)),
                       cache_len=32)
    ju = quantize_decoder_weights(init_params(arch, jax.random.PRNGKey(0)))
    pu = params_from_jax(jax.device_get(ju), arch)
    jt, pt = jnp.zeros((batch,), jnp.int32), torch.zeros((batch,),
                                                         dtype=torch.long)
    base = dict(params=(jq, tq), cache=(jc, pc), key_mask=(None, None),
                position=(jnp.int32(0), 0), tokens=(jt, pt))
    cases = [("ok", {}),
             ("batch +1", dict(tokens=(jnp.zeros((batch + 1,), jnp.int32),
                                       torch.zeros((batch + 1,))))),
             ("9 rows", dict(tokens=(jnp.zeros((9,), jnp.int32),
                                     torch.zeros((9,))))),
             ("vector position", dict(position=(
                 jnp.zeros((batch,), jnp.int32),
                 torch.zeros((batch,), dtype=torch.long)))),
             ("key mask", dict(key_mask=(jnp.ones((batch, 32), bool),
                                         torch.ones((batch, 32),
                                                    dtype=torch.bool)))),
             ("bf16 caches", dict(cache=(jbf, pbf))),
             ("unfused weights", dict(params=(ju, pu)))]
    if batch > 1:
        # one shared cross item under R rings (the beams layout)
        cases.append(("cross rows != R", dict(cache=(
            jc._replace(cross_k=jc.cross_k[:, :1],
                        cross_v=jc.cross_v[:, :1],
                        cross_k_scale=jc.cross_k_scale[:, :1],
                        cross_v_scale=jc.cross_v_scale[:, :1]),
            replace(pc, cross_k=pc.cross_k[:, :1], cross_v=pc.cross_v[:, :1],
                    cross_k_scale=pc.cross_k_scale[:, :1],
                    cross_v_scale=pc.cross_v_scale[:, :1])))))
    for name, change in cases:
        args = {**base, **change}
        yield (name, {k: v[0] for k, v in args.items()},
               {k: v[1] for k, v in args.items()})


@pytest.mark.parametrize("rows", [False, True])
def test_gates_match_reference(rows):
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    verdicts = {}
    for name, ja, pa in _gate_cases(arch, jq, tq, 3 if rows else 1):
        if rows:
            ref = J.supported_rows(ja["params"], arch, ja["cache"],
                                   ja["key_mask"], ja["position"],
                                   ja["tokens"])
            got = T.supported_rows(pa["params"], arch, pa["cache"],
                                   pa["key_mask"], pa["position"],
                                   pa["tokens"])
        else:
            ref = J.supported(ja["params"], arch, ja["cache"],
                              ja["key_mask"], 1, ja["position"],
                              ja["tokens"])
            got = T.supported(pa["params"], arch, pa["cache"],
                              pa["key_mask"], 1, pa["position"],
                              pa["tokens"])
        assert bool(got) == bool(ref), name
        verdicts[name] = bool(got)
    assert verdicts.pop("ok") and not any(verdicts.values())
    assert not T.supported(tq, arch, _caches(arch, jq, 1, jnp.int8)[1],
                           None, 2, 0, torch.zeros((1,)))   # beam groups


def test_gate_takes_the_kernels_shape_limits():
    """A head dim, an ffn width or a cross length the CUDA kernel does not
    take fails the gate."""
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, jq, _, tq = quantized_tiny()
    _, pc = _caches(arch, jq, 1, jnp.int8)
    assert T.supported(tq, arch, pc, None, 1, 0, torch.zeros((1,)))
    wide = replace(arch, d_model=512, decoder_attention_heads=4)  # Dh 128
    assert not T._kernel_takes(wide, pc, 1)
    odd = replace(arch, decoder_ffn_dim=136 + 4)
    assert not T._kernel_takes(odd, pc, 1)
    long = replace(pc, cross_k=torch.zeros(pc.cross_k.shape[:3] + (
        T.SPLIT * T.MAX_SPLITS + 1, arch.head_dim), dtype=torch.int8))
    assert not T._kernel_takes(arch, long, 1)             # K > 2048
    assert T._kernel_takes(arch, replace(long, cross_k=long.cross_k[
        :, :, :, :T.SPLIT * T.MAX_SPLITS]), 8)
    # large-v3 at M = 8 on the serving ring (448 + a verify block of 5)
    from types import SimpleNamespace
    from crisperwhisper_tpu_torch.config import WhisperArch
    lv3 = WhisperArch.large_v3()
    meta = SimpleNamespace(
        self_k=torch.empty((32, 8, 20, 453, 64), device="meta"),
        cross_k=torch.empty((32, 8, 20, 1500, 32), device="meta"))
    assert T._kernel_takes(lv3, meta, 8)


# ---------------------------------------------------------------------------
# The serving slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """TINY checkpoint; JAX and port pipelines with quantize="serving",
    b1_decode_kernel, one temperature, 24 new tokens (f32)."""
    from crisperwhisper_tpu.config import PipelineOptions
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu_torch.hub import load_pipeline
    ckpt = write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    po = PipelineOptions(chunk_length_s=CHUNK_S, batch_size=16,
                         return_timestamps="word")
    opts = dict(temperatures=(0.0,), b1_decode_kernel=True,
                max_new_tokens=24)
    jp = jax_load(ckpt, dtype=jnp.float32, pipe_opts=po, quantize="serving")
    jp.gen_opts = replace(jp.gen_opts, **opts)
    tp = load_pipeline(ckpt, dtype=torch.float32, device="cpu",
                       pipe_opts=po, quantize="serving")
    tp.gen_opts = replace(tp.gen_opts, **opts)
    wav = write_wav(str(tmp_path_factory.mktemp("audio") / "clip.wav"),
                    tone_audio(5.0, 3))
    return {"ckpt": ckpt, "wav": wav, "jax": jp, "torch": tp, "po": po}


def _run(pipe, audio):
    """pipe(audio) with word timestamps, and each chunk's tokens."""
    runs = []
    inner = pipe._run_chunks

    def spy(*a, **kw):
        out = inner(*a, **kw)
        runs.append([np.asarray(o["tokens"]) for o in out])
        return out
    pipe._run_chunks = spy
    try:
        res = pipe({"raw": audio, "sampling_rate": SR},
                   return_timestamps="word", adjust_pauses_threshold=0.12)
    finally:
        del pipe._run_chunks
    return res, [t for r in runs for t in r]


def _assert_same(ref, got):
    (r, r_toks), (g, g_toks) = ref, got
    assert len(r_toks) == len(g_toks) > 0
    for a, b in zip(r_toks, g_toks):
        np.testing.assert_array_equal(b, a)
    assert g["text"] == r["text"]
    assert [c["text"] for c in g["chunks"]] == \
        [c["text"] for c in r["chunks"]]
    for a, b in zip(r["chunks"], g["chunks"]):
        np.testing.assert_allclose(b["timestamp"], a["timestamp"],
                                   atol=TS_BAND)
    json.dumps(g)


@pytest.fixture
def step_calls(monkeypatch):
    """Counts of the port's kernel-mode step calls during one test."""
    from crisperwhisper_tpu_torch.ops import decode_step as T
    calls = {"decode_step_b1": 0, "decode_step_rows": 0}
    for name in calls:
        def counted(*a, _f=getattr(T, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(T, name, counted)
    return calls


@pytest.mark.parametrize("seconds,mode", [(5.0, "decode_step_b1"),
                                          (12.0, "decode_step_rows")])
def test_serving_slice_matches_jax(serving, step_calls, seconds, mode):
    """One 5 s window (batch 1: the b1 mode) and a 12 s clip (4 windows:
    the rows mode): equal tokens, text and words, word timestamps within
    one DTW frame; the mode's step ran, the other did not."""
    audio = tone_audio(seconds, 4)
    ref = _run(serving["jax"], audio)
    got = _run(serving["torch"], audio)
    _assert_same(ref, got)
    assert step_calls[mode] > 0
    assert sum(step_calls.values()) == step_calls[mode]


def test_int8_slice_matches_jax(serving, step_calls):
    """quantize=True (int8 cross cache, float ring: outside the kernel's
    gate, so every step is the quantized decode_step) gives the
    reference's tokens."""
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu_torch.hub import load_pipeline
    jp = jax_load(serving["ckpt"], dtype=jnp.float32, quantize=True,
                  pipe_opts=serving["po"])
    tp = load_pipeline(serving["ckpt"], dtype=torch.float32, device="cpu",
                       quantize=True, pipe_opts=serving["po"])
    for p in (jp, tp):
        p.gen_opts = replace(p.gen_opts, temperatures=(0.0,),
                             b1_decode_kernel=True, max_new_tokens=24,
                             staged_ring_quantum=0)
    audio = tone_audio(12.0, 5)
    _assert_same(_run(jp, audio), _run(tp, audio))
    assert sum(step_calls.values()) == 0


def test_cli_quantize_serving(serving, capsys):
    from crisperwhisper_tpu_torch.cli import main
    rc = main(["--f", serving["wav"], "--model", serving["ckpt"],
               "--chunk-length-s", str(CHUNK_S), "--json",
               "--quantize", "serving", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0, out
    result = json.loads(out)
    assert isinstance(result["text"], str) and len(result["chunks"]) > 0
    for c in result["chunks"]:
        s, e = c["timestamp"]
        assert 0.0 <= s <= 60.0 and 0.0 <= e <= 60.0
