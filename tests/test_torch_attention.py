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


def test_fused_attention_plain_matches_jax_eager_f16(qkv):
    """float16 inputs (load_pipeline(dtype=torch.float16)): the plain twin
    against the reference's eager attention at f16. Both keep f32 scores
    and round P to f16 for the second product; band = one f16 epsilon of
    the largest output (1 to 2 ulps), for the two frameworks' f16
    roundings, as testing.attention_error allows the kernel."""
    from crisperwhisper_tpu.models.whisper import attention
    from crisperwhisper_tpu_torch.ops.fused_attention import attention_plain
    q, k, v = qkv((1, 2, 200, 64), seed=5)
    ref, _ = attention(*(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    got = attention_plain(*(torch.from_numpy(x).half() for x in (q, k, v)))
    assert got.dtype == torch.float16
    ref = np.asarray(ref, np.float32)
    band = float(torch.finfo(torch.float16).eps) * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=band)


@pytest.mark.parametrize("dtype,head_dim,expected", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.float16, 64, "tensor_cores"),
    (torch.bfloat16, 16, "tensor_cores"), (torch.float16, 32, "tensor_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 16, "cuda_cores"),
    (torch.float64, 64, TypeError), (torch.bfloat16, 128, ValueError),
    (torch.float32, 128, ValueError)])
def test_attention_route_by_dtype_and_head_dim(dtype, head_dim, expected):
    """The route a CUDA call takes is decided in Python, before any
    launch: 16-bit types on tensor cores, f32 on CUDA cores; anything
    else raises (no fallback)."""
    from crisperwhisper_tpu_torch.ops.fused_attention import ROUTES, route
    if isinstance(expected, str):
        assert route(dtype, head_dim) == expected and expected in ROUTES
    else:
        with pytest.raises(expected):
            route(dtype, head_dim)


def test_fused_attention_counts_no_route_on_the_cpu(qkv):
    """CPU tensors take the plain version: neither route's count moves."""
    from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention
    q, k, v = (torch.from_numpy(x).half() for x in qkv((1, 2, 40, 64), 6))
    before = dict(fused_attention.route_launches)
    assert fused_attention(q, k, v).dtype == torch.float16
    assert fused_attention.route_launches == before
