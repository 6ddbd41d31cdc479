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


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16", "f32"])
@pytest.mark.parametrize("position", [-3, -1, 0, 20, T - 1, T + 5])
def test_plain_twin_takes_a_position_on_the_device(kind, position):
    """The plain twin of kernel 9 (and its bound form) masks by a 0-d int32
    position tensor as by the int: the same bytes of out and aligned
    rows, before the first key, inside the ring and past its end."""
    g = torch.Generator().manual_seed(position + 40)
    q = torch.randn((B, H, D), generator=g)
    if kind in ("int8", "int4"):
        vals = torch.randint(-7, 8, (2, L, B, H, T, D), generator=g,
                             dtype=torch.int8)
        k, v = (pack_int4(x) if kind == "int4" else x for x in vals)
        ks, vs = (torch.rand((L, B, H, T), generator=g).to(torch.bfloat16)
                  for _ in range(2))
    else:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        q = q.to(dtype)
        k, v = (torch.randn((L, B, H, T, D), generator=g).to(dtype)
                for _ in range(2))
        ks = vs = None
    mask = torch.rand((B, T), generator=g) > 0.2
    sel = torch.eye(H)[:, :3]
    at = torch.tensor(position, dtype=torch.int32)
    want = da.decode_gemv_attention(q, k, v, 1, ks, vs, position, mask, sel)
    got = da.decode_gemv_attention(q, k, v, 1, ks, vs, at, mask, sel)
    bound = da.bind_decode_gemv(q.dtype, k, v, ks, vs, mask)(q, 1, at, sel)
    for w, a, b in zip(want, got, bound):
        assert torch.equal(w, a) and torch.equal(w, b)


def test_cpu_wrappers_refuse_other_devices():
    q = torch.zeros((1, 1, 1, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.cross_attention_int8(q, q, q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_gemv_attention(q[0], q, q, 0)


# --- the kernel's launch plan (csrc/decode_attention.cu takes it as given)

_H100_SMS = 132


@pytest.mark.parametrize("name,pairs,keys,row,want", [
    ("microbench int8", 64 * 20, 1536, 64, (4, 96)),
    ("microbench int4", 64 * 20, 1536, 32, (4, 96)),
    ("microbench bf16", 64 * 20, 1536, 128, (8, 48)),
    ("v1/v2 at batch 16", 16 * 20, 1500, 64, (4, 94)),
    ("phase 8 (b)/(c) int8 cross", 4 * 20, 1500, 64, (8, 47)),
    ("phase 8 (c) int4 cross", 4 * 20, 1500, 32, (8, 47)),
    ("phase 8 (c) self ring", 4 * 20, 448, 64, (8, 14))])
def test_plan_fills_the_card_at_the_smoke_shapes(name, pairs, keys, row,
                                                 want):
    """The cluster size at chip_smoke's shapes: phase 8's 4 rows x 20
    heads take clusters of 8 (FILL blocks an SM); v1/v2's 16 rows and the
    64-row microbench clusters of 4 for int8 and int4 (a slice within four
    blocks an SM) and 8 for bf16 (whose slice of 4 would not fit four);
    each slice whole in shared memory, in SLOTS pieces."""
    cluster, piece = da.plan(pairs, keys, row, _H100_SMS)
    assert (cluster, piece) == want, name
    per = -(-keys // cluster)
    assert piece == -(-per // da.SLOTS)
    assert pairs * cluster >= da.FILL * _H100_SMS or cluster == 8
    assert da.smem_bytes(per, piece, row) <= da.SMEM_BUDGET or cluster == 8
    assert da.smem_bytes(per, piece, row) <= da.STREAM_BUDGET


@pytest.mark.parametrize("row", [32, 64, 128, 256])
@pytest.mark.parametrize("keys", [1, 31, 1500, 1536, 4097, 8192])
@pytest.mark.parametrize("pairs", [1, 80, 1280])
def test_plan_fits_every_shape_the_wrapper_takes(row, keys, pairs):
    """Every cache width, key count and grid: a cluster of 2, 4 or 8
    blocks, pieces of at least one key, shared memory within the stream
    budget (and the per-block budget below a cluster of 8); a slice
    streams through the slots (more than SLOTS pieces) only at a cluster
    of 8, in the largest pieces that fit."""
    cluster, piece = da.plan(pairs, keys, row, _H100_SMS)
    per = -(-keys // cluster)
    assert cluster in (2, 4, 8) and 1 <= piece <= per
    assert da.smem_bytes(per, piece, row) <= da.STREAM_BUDGET
    if cluster < 8:
        assert da.smem_bytes(per, piece, row) <= da.SMEM_BUDGET
    if -(-per // piece) > da.SLOTS:
        assert cluster == 8
        assert da.smem_bytes(per, piece + 1, row) > da.STREAM_BUDGET


def test_plan_constants_match_the_kernel_source():
    import re
    src = open(os.path.join(os.path.dirname(da.__file__), "..", "csrc",
                            "decode_attention.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src)
                   .group(1))
    assert const("kD") == da.HEAD_DIM
    assert const("kThreads") == da.THREADS
    assert const("kMaxKeys") == da.MAX_KEYS
    assert const("kMaxCluster") == da.MAX_CLUSTER
    assert const("kSlots") == da.SLOTS
    assert const("kMaxSmem") == da.SMEM_LIMIT
    assert "constexpr int kHeadBytes = 16 * kSlots + 256;" in src
    assert da.HEAD_BYTES == 16 * da.SLOTS + 256
    assert da.SMEM_BUDGET <= da.STREAM_BUDGET <= da.SMEM_LIMIT // 2
    # the kernel's layout formula, term by term
    body = re.search(r"constexpr size_t smem_bytes\(.*?\{(.*?)\}", src,
                     re.S).group(1)
    for term in ("kHeadBytes + 2 * (size_t)kSlots * piece * row",
                 "4 * round16(per)", "2 * round16(2 * (size_t)per + 15)",
                 "round16((size_t)per + 15)", "4 * kWarps * kD",
                 "8 * (((size_t)n_align + 3) & ~(size_t)3)"):
        assert term in body, term


def _split_key_model(s: np.ndarray, v: np.ndarray, cluster: int):
    """The kernel's softmax and P.V over a cluster, in f32 numpy: each
    rank's slice of keys, its max and sum combined in rank order, p = e /
    sum, the partial P.V of each rank added in rank order."""
    t = s.shape[-1]
    per = -(-t // cluster)
    slices = [slice(min(r * per, t), min((r + 1) * per, t))
              for r in range(cluster)]
    mx = np.float32(-np.inf)
    for sl in slices:
        if s[sl].size:
            mx = max(mx, s[sl].max())
    e = np.exp(s - mx).astype(np.float32)
    total = np.float32(0)
    for sl in slices:
        total = np.float32(total + e[sl].sum(dtype=np.float32))
    p = (e / total).astype(np.float32)
    out = np.zeros(v.shape[-1], np.float32)
    for sl in slices:
        out += (p[sl, None] * v[sl]).sum(axis=0, dtype=np.float32)
    return p, out


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("t", [1, 7, 1500])
def test_split_key_softmax_matches_plain(cluster, t):
    """Splitting the keys over the cluster's ranks (empty ranks at T < C
    included) gives the plain softmax and P.V within the bands."""
    rng = np.random.default_rng(t)
    s = (rng.standard_normal(t) * 3).astype(np.float32)
    v = rng.standard_normal((t, 64)).astype(np.float32)
    p, out = _split_key_model(s, v, cluster)
    rp = torch.softmax(torch.from_numpy(s), -1)
    np.testing.assert_allclose(p, rp.numpy(), rtol=0, atol=PROBS_BAND)
    ref = (rp[:, None] * torch.from_numpy(v)).sum(0).numpy()
    assert np.abs(out - ref).max() <= OUT_REL_BAND * np.abs(ref).max()
