"""PyTorch port: HF-format export (state_dict_from_params,
save_hf_checkpoint and the port's own safetensors writer) and the port's
parameter checkpoints (utils/checkpoint), against the JAX package and the
safetensors package on the same TINY weights. Every comparison is exact:
export and checkpoints move bytes, they compute nothing."""

import json
import os
from dataclasses import asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import tiny_state_dict, to_torch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return None


def _assert_same_tree(a, b, device="cpu"):
    """Same structure (dicts and lists), dtypes and bits, every leaf of b
    on ``device``."""
    assert _structure(a) == _structure(b)
    la, lb = sorted(_leaves(a)), sorted(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert y.device.type == device, k
        assert x.dtype == y.dtype, k
        assert torch.equal(x.cpu(), y.cpu()), k


@pytest.fixture(scope="module")
def weights():
    from crisperwhisper_tpu.models import params_from_state_dict as jload
    from crisperwhisper_tpu_torch.models.loader import params_from_state_dict
    sd = tiny_state_dict()
    arch = tiny_arch()
    return {"sd": sd, "arch": arch, "jax": jload(sd, arch, dtype=jnp.float32),
            "torch": params_from_state_dict(sd, arch, torch.float32)}


def test_state_dict_from_params_matches_jax(weights):
    """Key for key and value for value the JAX package's export of the
    same weights, which is the HF state dict but the tied proj_out."""
    from crisperwhisper_tpu.models.loader import state_dict_from_params as J
    from crisperwhisper_tpu_torch.models.loader import state_dict_from_params
    got = state_dict_from_params(weights["torch"])
    ref = J(weights["jax"])
    assert set(got) == set(ref) == set(weights["sd"]) - {"proj_out.weight"}
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_hf_checkpoint_loads_back_in_both_packages(weights, tmp_path,
                                                        dtype):
    """The directory loads back bit-equal through the port's load_params
    (f32 and bf16; LayerNorms stay f32) and, at f32, through the JAX
    package's (the safetensors package's reader); its config gives the
    same architecture, with config_extra merged in."""
    from crisperwhisper_tpu.models.loader import load_params as jload
    from crisperwhisper_tpu_torch.models.loader import (load_params,
                                                        save_hf_checkpoint)
    from crisperwhisper_tpu_torch.models.loader import params_from_state_dict
    arch = weights["arch"]
    params = params_from_state_dict(weights["sd"], arch, dtype)
    d = str(tmp_path / "ckpt")
    save_hf_checkpoint(d, params, arch, config_extra={"median_filter_width": 7})
    back, arch2 = load_params(d, dtype=dtype, device="cpu")
    assert asdict(arch2) == asdict(arch)
    _assert_same_tree(params, back)
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["median_filter_width"] == 7
    if dtype == torch.float32:
        jp, _ = jload(d, dtype=jnp.float32)
        for (k, a), (_, b) in zip(sorted(_leaves(jax.device_get(jp))),
                                  sorted(_leaves(jax.device_get(
                                      weights["jax"])))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)


def test_safetensors_writer_round_trips_every_dtype(tmp_path):
    """The port's writer for F32, BF16, F16, I8 and U8 (and a scalar, an
    empty tensor and a transposed view), read back bit for bit by the
    port's reader and by the safetensors package, with the header's
    {"format": "pt"} that from_pretrained checks."""
    from safetensors import safe_open
    from safetensors.torch import load_file
    from crisperwhisper_tpu_torch.models.loader import (read_safetensors,
                                                        write_safetensors)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 7), generator=g)
    tensors = {"f32": x, "bf16": x.bfloat16(), "f16": x.half(),
               "i8": torch.randint(-128, 128, (3, 9), generator=g,
                                   dtype=torch.int8),
               "u8": torch.randint(0, 256, (11,), generator=g,
                                   dtype=torch.uint8),
               "scalar": torch.tensor(2.5), "empty": torch.zeros((0, 4)),
               "view": x.T}
    path = str(tmp_path / "t.safetensors")
    n = write_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    for got in (read_safetensors(path), load_file(path)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("kind", ["int8", "int4", "fused"])
def test_save_hf_checkpoint_refuses_quantized_and_fused_trees(weights,
                                                               tmp_path,
                                                               kind):
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.models.loader import save_hf_checkpoint
    arch, tp = weights["arch"], weights["torch"]
    tree = {"int8": lambda: TQ.quantize_decoder_weights(tp),
            "int4": lambda: TQ.quantize_decoder_weights(tp, bits=4),
            "fused": lambda: TQ.fuse_decoder_qkv(tp, arch.head_dim)}[kind]()
    with pytest.raises(ValueError, match="quantized|fused"):
        save_hf_checkpoint(str(tmp_path / "ckpt"), tree, arch)


@pytest.mark.parametrize("kind", ["fused_int8", "int4"])
def test_save_params_round_trip(weights, tmp_path, kind):
    """A fused int8 tree and a group-wise int4 tree come back with their
    structure, dtypes and bits, and the metadata beside them (as
    tests/test_checkpoint.py:16 holds the JAX package's)."""
    from crisperwhisper_tpu_torch.models import quantize as TQ
    from crisperwhisper_tpu_torch.utils.checkpoint import (load_saved_params,
                                                           save_params)
    tp, hd = weights["torch"], weights["arch"].head_dim
    tree = (TQ.quantize_decoder_weights(TQ.fuse_decoder_qkv(tp, hd))
            if kind == "fused_int8"
            else TQ.quantize_decoder_weights(tp, bits=4))
    path = str(tmp_path / "ckpt")
    save_params(path, tree, metadata={"arch": "tiny", "quantized": True})
    restored, meta = load_saved_params(path, device="cpu")
    assert meta == {"arch": "tiny", "quantized": True}
    _assert_same_tree(tree, restored)
    dtypes = {t.dtype for _, t in _leaves(restored)}
    assert {torch.float32, torch.bfloat16} <= dtypes
    assert (torch.int8 if kind == "fused_int8" else torch.uint8) in dtypes


def test_save_params_writes_a_slice_alone(tmp_path):
    """A view into a larger storage is written as itself; no metadata
    reads back as {}."""
    from crisperwhisper_tpu_torch.utils.checkpoint import (load_saved_params,
                                                           save_params)
    big = torch.arange(4 * 100_000, dtype=torch.float32).reshape(4, 100_000)
    save_params(str(tmp_path), {"layers": [big[1]], "t": big[:, :3].T})
    assert os.path.getsize(tmp_path / "params.pt") < 200_000 * 4
    back, meta = load_saved_params(str(tmp_path), device="cpu")
    assert meta == {}
    assert torch.equal(back["layers"][0], big[1])
    assert torch.equal(back["t"], big[:, :3].T)


def test_classification_head_from_jax(weights):
    """A JAX classification head comes across as
    classification_head_from_state_dict reads the HF tensors."""
    from crisperwhisper_tpu.models.whisper import init_classification_head
    from crisperwhisper_tpu_torch.models.loader import (
        classification_head_from_jax, classification_head_from_state_dict)
    jhead = jax.device_get(init_classification_head(
        weights["arch"], 5, jax.random.PRNGKey(2), classifier_proj_size=32))
    head = classification_head_from_jax(jhead)
    hf = {f"{n}.{k}": to_torch(jhead[n][o]).T if o == "w"
          else to_torch(jhead[n][o])
          for n in ("projector", "classifier") for k, o in (("weight", "w"),
                                                            ("bias", "b"))}
    _assert_same_tree(classification_head_from_state_dict(hf, device="cpu"),
                      head)
    assert head["classifier"]["w"].shape == (5, 32)


def test_exported_checkpoint_loads_in_reference_stack(weights, tmp_path):
    """The reference stack's from_pretrained reads the port's export with
    no missing or unexpected key, every tensor bit-equal (proj_out tied),
    and its decoder gives the port's forward logits in the decode-step
    band (atol=2e-4, rtol=1e-4, tests/test_torch_model.py:169)."""
    from transformers import WhisperForConditionalGeneration
    from helpers import TINY_SPECIALS
    from crisperwhisper_tpu_torch.models.loader import save_hf_checkpoint
    from crisperwhisper_tpu_torch.models.whisper import forward
    arch, params = weights["arch"], weights["torch"]
    d = str(tmp_path / "ckpt")
    save_hf_checkpoint(d, params, arch, config_extra={
        "pad_token_id": TINY_SPECIALS.eot, "bos_token_id": TINY_SPECIALS.eot,
        "eos_token_id": TINY_SPECIALS.eot,
        "decoder_start_token_id": TINY_SPECIALS.sot})
    with open(os.path.join(d, "model.safetensors"), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert json.loads(f.read(n))["__metadata__"] == {"format": "pt"}
    hf, info = WhisperForConditionalGeneration.from_pretrained(
        d, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    hsd = hf.state_dict()
    for k, t in weights["sd"].items():
        assert torch.equal(hsd[k], torch.as_tensor(np.asarray(t))), k
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal(
        (2, arch.num_mel_bins, 2 * arch.max_source_positions)
    ).astype(np.float32) * 0.1)
    ids = torch.from_numpy(rng.integers(0, arch.vocab_size, (2, 6)))
    with torch.no_grad():
        theirs = hf(input_features=mel, decoder_input_ids=ids).logits
    ours = forward(params, arch, mel, ids)
    torch.testing.assert_close(ours.float(), theirs, atol=2e-4, rtol=1e-4)
