"""PyTorch port, kernel 1: encoder attention (ops/fused_attention.py)
against the JAX package's Pallas kernel, run interpreted on the CPU."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def qkv():
    """Seeded inputs per shape, as numpy (pre-scaled q, as callers pass)."""
    def make(shape, seed):
        rng = np.random.default_rng(seed)
        return tuple((rng.standard_normal(shape) * s).astype(np.float32)
                     for s in (0.1, 0.1, 1.0))
    return make


def _jax_pallas_interpret(q, k, v):
    """The TPU kernel itself, interpreted (tests/test_pallas_kernels.py)."""
    from jax.experimental import pallas as pl
    import crisperwhisper_tpu.ops.fused_attention as fa
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(fa.fused_attention.__wrapped__(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("shape", [(2, 4, 300, 64), (1, 4, 250, 16)])
def test_fused_attention_matches_jax_kernel(qkv, shape):
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    q, k, v = qkv(shape, seed=1)
    ref = _jax_pallas_interpret(q, k, v)
    before = fused_attention.launches
    got = fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    # band of the reference's own kernel test (test_pallas_kernels.py:69)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    assert fused_attention.launches == before     # CPU: the plain version


def test_fused_attention_matches_jax_eager_bf16(qkv):
    """bf16 inputs: the plain twin keeps f32 scores like the reference's
    preferred_element_type=f32 path; band = one bf16 ulp at |out| <= 4."""
    from crisperwhisper_tpu.models.whisper import attention
    from crisperwhisper_tpu_torch.ops.fused_attention import attention_plain
    q, k, v = qkv((1, 2, 200, 64), seed=2)
    ref, _ = attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = attention_plain(*(torch.from_numpy(x).bfloat16()
                            for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2 ** -6)


def test_fused_attention_rejects_unsupported_device(qkv):
    """Off the CPU the wrapper launches the kernel or raises: never the
    plain version."""
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    q, k, v = (torch.from_numpy(x).to("meta") for x in qkv((1, 1, 8, 16), 3))
    with pytest.raises(ValueError):
        fused_attention(q, k, v)
