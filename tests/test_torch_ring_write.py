"""PyTorch port: per-row ring writes (ops/ring_write.py) against the JAX
package's write strategies (ops/ring_scatter.py, the Pallas DMA kernel in
interpret mode), and the decoder step at per-row positions
(models/whisper.decode_step_multi / decode_step) against the JAX
functions.

The JAX rings are [L, B, H, Dh, T] with blocks [B, H, Dh, S]; the port's
are [L, B, H, T, Dh] with blocks [B, H, S, Dh] (int4 nibble-packed over
Dh). The same values go into both, and the written rings must be equal
bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import rand_mel
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import to_torch

L, H, DH, T = 3, 4, 16, 24


def _draw(rng, kind, shape):
    """Values of a ring or block of ``kind`` as (numpy, JAX dtype)."""
    if kind == "bf16":
        return rng.standard_normal(shape).astype(np.float32), jnp.bfloat16
    if kind == "f32":
        return rng.standard_normal(shape).astype(np.float32), jnp.float32
    qmax = 7 if kind == "int4" else 127
    return (rng.integers(-qmax, qmax + 1, shape).astype(np.int8),
            jnp.int4 if kind == "int4" else jnp.int8)


def _port_values(x: np.ndarray, kind: str) -> torch.Tensor:
    """A JAX-dtype numpy array in the port's layout (Dh last)."""
    from crisperwhisper_tpu_torch.models.whisper import pack_int4
    t = to_torch(x)
    if kind == "int4":
        return pack_int4(t)
    return t


@pytest.mark.parametrize("s,b", [(1, 3), (5, 1), (5, 3)])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int4"])
def test_plain_write_matches_jax_modes(kind, s, b):
    """The plain version writes the bytes of the JAX "scatter" and "dma"
    strategies (quantized rings with their bf16 scale rings, one grouped
    call; int4 compared unpacked), bit for bit."""
    from crisperwhisper_tpu.ops.ring_scatter import write_block_columns_group \
        as jwrite
    from crisperwhisper_tpu_torch.models.whisper import unpack_int4
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    rng = np.random.default_rng([["bf16", "f32", "int8", "int4"].index(kind),
                                 s, b])
    ring_np, jdt = _draw(rng, kind, (L, b, H, T, DH))
    blk_np, _ = _draw(rng, kind, (b, H, s, DH))
    pos = rng.integers(0, T - s + 1, (b,)).astype(np.int32)
    li = 1
    jpairs = [(jnp.asarray(ring_np, jdt).swapaxes(-1, -2),
               jnp.asarray(blk_np, jdt).swapaxes(-1, -2))]
    quant = kind in ("int8", "int4")
    if quant:
        sr = rng.standard_normal((2, L, b, H, T)).astype(np.float32)
        sb = rng.standard_normal((2, b, H, s)).astype(np.float32)
        jpairs += [(jnp.asarray(sr[i], jnp.bfloat16),
                    jnp.asarray(sb[i], jnp.bfloat16)) for i in range(2)]
    pairs = [(_port_values(np.asarray(r).swapaxes(-1, -2), kind)
              .contiguous(),
              _port_values(np.asarray(k).swapaxes(-1, -2), kind))
             for r, k in jpairs[:1]]
    pairs += [(to_torch(r), to_torch(k)) for r, k in jpairs[1:]]
    ring0 = pairs[0][0].clone()
    write_block_columns_group(pairs, li, torch.from_numpy(pos))
    for mode in ("scatter", "dma"):
        ref = jwrite(jpairs, jnp.int32(li), jnp.asarray(pos), mode=mode)
        got_ring = pairs[0][0]
        if kind == "int4":
            got_ring = unpack_int4(got_ring)
        want = np.asarray(ref[0]).swapaxes(-1, -2)
        if kind == "bf16":
            np.testing.assert_array_equal(
                got_ring.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            np.testing.assert_array_equal(got_ring.numpy(),
                                          want.astype(got_ring.numpy().dtype))
        for (r, _), w in zip(pairs[1:], ref[1:]):
            np.testing.assert_array_equal(r.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
    # the plain reference: only row b's slots [pos[b], pos[b] + S) moved
    moved = (pairs[0][0] != ring0).any(-1)[li]                # [B, H, T]
    for row in range(b):
        outside = torch.ones(T, dtype=torch.bool)
        outside[pos[row]:pos[row] + s] = False
        assert not moved[row][:, outside].any()


def test_write_checks_shapes():
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    ring = torch.zeros((L, 2, H, T, DH))
    blk = torch.zeros((2, H, 3, DH))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk[:1])], 0, torch.zeros(2))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk.double())], 0, torch.zeros(2))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk)], L, torch.zeros(2))
    assert write_block_columns_group.launches == 0     # CPU: plain version


# ---------------------------------------------------------------------------
# The decoder step at per-row positions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """TINY f32 weights in both packages and encoder states for 3 rows
    (computed by the port, handed to both)."""
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from crisperwhisper_tpu_torch.models.whisper import encode
    from helpers import tiny_arch
    arch = tiny_arch()
    jp = jax.device_get(init_params(arch, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, arch)
    enc = encode(tp, arch, torch.from_numpy(rand_mel(batch=3, seed=2))
                 ).numpy()
    return arch, jp, tp, enc


def _caches(arch, jp, tp, enc, quant):
    from crisperwhisper_tpu.models import init_cache as jinit
    from crisperwhisper_tpu_torch.models.whisper import init_cache
    kw = dict(cache_len=24)
    jc = jinit(jp, arch, jnp.asarray(enc), cross_dtype=jnp.int8 if quant
               else None, self_dtype=jnp.int8 if quant else None, **kw)
    pc = init_cache(tp, arch, torch.from_numpy(enc),
                    cross_dtype="int8" if quant else None,
                    self_dtype="int8" if quant else None, **kw)
    return jc, pc


def _assert_rings(jc, pc, quant):
    """Written rings equal: the same slots written (nonzero values, or
    nonzero scales of a quantized ring), float values to f32 rounding,
    int8 values within one step (a value on a rounding boundary), scales
    within one bf16 step."""
    for name in ("self_k", "self_v"):
        want = np.asarray(getattr(jc, name), np.float32).swapaxes(-1, -2)
        got = getattr(pc, name).float().numpy()
        if not quant:
            np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, atol=1.0 if quant else 2e-5,
                                   rtol=0)
    if quant:
        for name in ("self_k_scale", "self_v_scale"):
            got = getattr(pc, name).float().numpy()
            want = np.asarray(getattr(jc, name), np.float32)
            np.testing.assert_array_equal(got != 0, want != 0)
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mode,quant", [("scatter", False), ("dma", True)])
def test_vector_positions_match_jax(tiny_pair, monkeypatch, mode, quant):
    """decode_step_multi (a 4-token block) and then decode_step (one
    token) at per-row positions, float and int8 caches: logits within
    2e-4, alignment rows within 2e-5 (tests/test_model.py bands), rings
    written at the same slots to the same values; the JAX side under each
    of its write strategies (CW_RING_SCATTER)."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.models import decode_step as jstep
    from crisperwhisper_tpu.models import decode_step_multi as jmulti
    from crisperwhisper_tpu_torch.models.whisper import (decode_step,
                                                         decode_step_multi)
    monkeypatch.setenv("CW_RING_SCATTER", mode)
    arch, jp, tp, enc = tiny_pair
    jc, pc = _caches(arch, jp, tp, enc, quant)
    sel = alignment_selector(arch, ((0, 1), (1, 2)))
    rng = np.random.default_rng(1)
    block = rng.integers(2, 40, (3, 4)).astype(np.int32)
    pos = np.asarray([5, 2, 9], np.int32)
    la, jc, aa = jmulti(jp, arch, jnp.asarray(block), jnp.asarray(pos), jc,
                        align_sel=jnp.asarray(sel))
    lb, pc, ab = decode_step_multi(tp, arch, torch.from_numpy(block),
                                   torch.from_numpy(pos), pc, align_sel=sel)
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=2e-4)
    np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=2e-5)
    _assert_rings(jc, pc, quant)
    toks = np.asarray([11, 12, 13], np.int32)
    nxt = pos + 4
    la, jc, aa = jstep(jp, arch, jnp.asarray(toks), jnp.asarray(nxt), jc,
                       align_sel=jnp.asarray(sel))
    lb, pc, ab = decode_step(tp, arch, torch.from_numpy(toks),
                             torch.from_numpy(nxt), pc, align_sel=sel)
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=2e-4)
    np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=2e-5)
    _assert_rings(jc, pc, quant)


def test_vector_positions_equal_per_row_scalar_steps(tiny_pair):
    """Row b of a per-row-position step equals the same row decoded alone
    at its scalar position (the live prefix and mask are per row)."""
    from crisperwhisper_tpu_torch.models.whisper import (decode_step_multi,
                                                         init_cache)
    arch, _, tp, enc = tiny_pair
    block = torch.tensor([[3, 4, 5], [6, 7, 8], [9, 10, 11]])
    pos = torch.tensor([4, 0, 7], dtype=torch.int32)
    cache = init_cache(tp, arch, torch.from_numpy(enc), cache_len=16)
    lv, _, _ = decode_step_multi(tp, arch, block, pos, cache)
    for row in range(3):
        one = init_cache(tp, arch, torch.from_numpy(enc[row:row + 1]),
                         cache_len=16)
        with torch.inference_mode():                  # same ring content
            one.self_k[:, 0] = cache.self_k[:, row]
            one.self_v[:, 0] = cache.self_v[:, row]
        lr, _, _ = decode_step_multi(tp, arch, block[row:row + 1],
                                     int(pos[row]), one)
        torch.testing.assert_close(lv[row], lr[0], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        decode_step_multi(tp, arch, block, torch.tensor([4, 0, 14]), cache)
