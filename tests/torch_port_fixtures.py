"""Shared helpers for the PyTorch-port tests (tests/test_torch_*.py).

The same seed-pinned TINY HF model feeds both packages: its state dict is
converted by each package's loader, so every comparison starts from equal
weights. Inputs are made with numpy and handed to both sides. The
checkpoint directory and the audio come from crisperwhisper_tpu_torch.testing,
which chip_smoke.py uses too.
"""

import os

import pytest

from crisperwhisper_tpu_torch.testing import (CHUNK_S, SR, TS_BAND,  # noqa: F401
                                              tone_audio, write_tiny_configs,
                                              write_wav)
from helpers import state_dict_numpy, torch_tiny_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch on one CPU thread for the tests of a module that imports
    this fixture, restored after them. The port's CPU tests run many tiny
    eager ops; while other pytest workers share the cores, the default
    team of one thread per core makes each op wait for descheduled
    threads, and a pipeline test runs tens of times slower."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_state_dict() -> dict:
    return state_dict_numpy(torch_tiny_model(seed=0))


def write_tiny_checkpoint(path: str) -> str:
    """write_tiny_configs plus the seed-pinned HF model's safetensors."""
    import torch
    from safetensors.torch import save_file
    write_tiny_configs(path)
    sd = {k: torch.from_numpy(v).contiguous()
          for k, v in tiny_state_dict().items() if k != "proj_out.weight"}
    save_file(sd, os.path.join(path, "model.safetensors"))
    return path


def port_config(obj):
    """A JAX package config dataclass (SpecialTokens, GenerationOptions,
    ...) as the port's class of the same name and fields, for tests that
    compare or replace it on the port's side; the port only reads fields
    and never converts."""
    from dataclasses import fields
    from crisperwhisper_tpu_torch import config
    cls = getattr(config, type(obj).__name__)
    return cls(**{f.name: getattr(obj, f.name) for f in fields(obj)})


def to_torch(a):
    """A host array of the JAX package (bf16 and int4 included) as a CPU
    tensor: bf16 keeps its bits, int4 widens to int8."""
    import numpy as np
    import torch
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "int4":
        a = a.astype(np.int8)
    return torch.from_numpy(np.array(a))


def quantized_tiny(fused: bool = True):
    """TINY f32 weights from the JAX package's init_params, with random
    decoder biases and LayerNorms (testing.random_affine, seed 1),
    quantized on both sides: (arch, JAX quantized tree, port tree
    quantized in the port, port tree carried across from the JAX
    quantized tree)."""
    import jax
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu.models import quantize as JQ
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from crisperwhisper_tpu_torch.testing import random_affine
    from helpers import tiny_arch
    arch = tiny_arch()
    jp = random_affine(jax.device_get(init_params(arch, jax.random.PRNGKey(0))),
                       1)
    tp = params_from_jax(jp, arch)
    if fused:
        jp = JQ.fuse_decoder_qkv(jp, arch.head_dim)
        tp = TQ.fuse_decoder_qkv(tp, arch.head_dim)
    jq = JQ.quantize_decoder_weights(jp)
    return (arch, jq, TQ.quantize_decoder_weights(tp),
            params_from_jax(jax.device_get(jq), arch))


def cache_from_jax(jc):
    """A JAX DecoderCache (sequence-last) as the port's (head-dim-last;
    int4 halves nibble-packed)."""
    import numpy as np
    from crisperwhisper_tpu_torch.models.whisper import (DecoderCache,
                                                         pack_int4)

    def half(x):
        t = to_torch(x).transpose(-1, -2).contiguous()
        return pack_int4(t) if np.asarray(x).dtype.name == "int4" else t

    def scale(x):
        return None if x is None else to_torch(x).contiguous()
    return DecoderCache(
        self_k=half(jc.self_k), self_v=half(jc.self_v),
        cross_k=half(jc.cross_k), cross_v=half(jc.cross_v),
        cross_k_scale=scale(jc.cross_k_scale),
        cross_v_scale=scale(jc.cross_v_scale),
        self_k_scale=scale(jc.self_k_scale),
        self_v_scale=scale(jc.self_v_scale))
