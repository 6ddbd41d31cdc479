"""Checkpoint loading: HF safetensors or a JAX parameter tree -> port params.

Port of crisperwhisper_tpu/models/loader.py. The port's layout (see
models/whisper.py) keeps torch's own: linear weights [d_out, d_in], conv
weights [C_out, C_in, k], one dict per layer. So an HF state dict maps by
name only, while a JAX tree (``params_from_jax``) is transposed back: its
dense weights are [d_in, d_out], its conv weights HIO [k, C_in, C_out] and
its layers stacked on a leading axis.

The safetensors reader and writer are self-contained (u64 little-endian
header length, JSON header padded to 8 bytes, raw little-endian tensor
bytes laid end to end), so loading and export (``save_hf_checkpoint``)
need neither the ``safetensors`` package nor JAX.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .._device import resolve as resolve_device
from ..config import WhisperArch

from .whisper import Params

_ATTN_MAP = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "o"}
_F32_KEYS = {"ln", "ln1", "ln2", "ln3", "ln_post"}
# quantized dense scales stay bf16
_KEEP = {"w_scale": torch.bfloat16, "w_gscale": torch.bfloat16}

# safetensors dtype tag -> (numpy storage dtype, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}
_ST_TAGS = {torch_dtype: tag for tag, (_, torch_dtype) in _ST_DTYPES.items()}


def _key_path(key: str) -> tuple[tuple, int | None] | None:
    """HF state-dict key -> (path in the port tree, layer index or None);
    None for keys deliberately ignored (the tied proj_out.weight)."""
    key = re.sub(r"^model\.", "", key)
    if key == "proj_out.weight":          # tied to decoder.embed_tokens
        return None
    m = re.match(r"(encoder|decoder)\.layers\.(\d+)\.(.+)", key)
    if m:
        stack, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        wb = "w" if rest.endswith("weight") else "b"
        lns = (("self_attn_layer_norm", "ln1"), ("final_layer_norm", "ln2")) \
            if stack == "encoder" else \
            (("self_attn_layer_norm", "ln1"), ("encoder_attn_layer_norm", "ln2"),
             ("final_layer_norm", "ln3"))
        for hf, ours in lns:
            if rest.startswith(hf):
                return (stack, ours, "scale" if wb == "w" else "bias"), idx
        attn = {"encoder": (("self_attn", "attn"),),
                "decoder": (("self_attn", "self"),
                            ("encoder_attn", "cross"))}[stack]
        for hf, ours in attn:
            m2 = re.match(hf + r"\.(\w+)\.(weight|bias)$", rest)
            if m2:
                return (stack, ours, _ATTN_MAP[m2.group(1)], wb), idx
        m2 = re.match(r"(fc1|fc2)\.(weight|bias)$", rest)
        if m2:
            return (stack, "mlp", m2.group(1), wb), idx
        raise KeyError(f"unrecognized layer tensor: {key}")
    flat = {
        "encoder.conv1.weight": ("encoder", "conv1", "w"),
        "encoder.conv1.bias": ("encoder", "conv1", "b"),
        "encoder.conv2.weight": ("encoder", "conv2", "w"),
        "encoder.conv2.bias": ("encoder", "conv2", "b"),
        "encoder.embed_positions.weight": ("encoder", "pos"),
        "encoder.layer_norm.weight": ("encoder", "ln_post", "scale"),
        "encoder.layer_norm.bias": ("encoder", "ln_post", "bias"),
        "decoder.embed_tokens.weight": ("decoder", "tok_emb"),
        "decoder.embed_positions.weight": ("decoder", "pos_emb"),
        "decoder.layer_norm.weight": ("decoder", "ln", "scale"),
        "decoder.layer_norm.bias": ("decoder", "ln", "bias"),
    }
    if key in flat:
        return flat[key], None
    raise KeyError(f"unrecognized checkpoint tensor: {key}")


def _set(tree: dict, path: tuple, value: Any) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _finish(tree: dict, arch: WhisperArch, dtype: torch.dtype,
            device: torch.device | str) -> Params:
    """Cast (LayerNorms stay f32: bf16-rounded affine params move logits
    enough to shift DTW jumps; int8 weights and their bf16 scales stay as
    quantized) and move every leaf to the device."""
    def cast(node, keep=None):
        if isinstance(node, dict):
            return {k: cast(v, keep or (torch.float32 if k in _F32_KEYS
                                        else _KEEP.get(k)))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v, keep) for v in node]
        t = node.to(device)
        if t.is_floating_point():
            t = t.to(keep or dtype)
        return t.contiguous()

    for stack, n in (("encoder", arch.encoder_layers),
                     ("decoder", arch.decoder_layers)):
        layers = tree[stack]["layers"]
        missing = sorted(set(range(n)) - set(layers))
        if missing:
            raise ValueError(f"missing {stack} layers {missing}")
        tree[stack]["layers"] = [layers[i] for i in range(n)]
    return cast(tree)


def params_from_state_dict(state: Mapping[str, Any], arch: WhisperArch,
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str = "cpu") -> Params:
    """Flat HF-style state dict (numpy arrays or tensors) -> port params."""
    tree: dict = {"encoder": {"layers": {}}, "decoder": {"layers": {}}}
    for key, value in state.items():
        conv = _key_path(key)
        if conv is None:
            continue
        path, idx = conv
        t = torch.as_tensor(np.asarray(value)) \
            if not isinstance(value, torch.Tensor) else value
        if idx is None:
            _set(tree, path, t)
        else:
            layer = tree[path[0]]["layers"].setdefault(idx, {})
            _set(layer, path[1:], t)
    return _finish(tree, arch, dtype, device)


def params_from_jax(tree_np: Mapping[str, Any], arch: WhisperArch,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> Params:
    """The JAX package's parameter tree, read back to host numpy (e.g.
    ``jax.device_get``), -> port params. Dense [d_in, d_out] -> [d_out,
    d_in]; conv HIO [k, C_in, C_out] -> [C_out, C_in, k]; stacked [L, ...]
    layer leaves -> one dict per layer. A quantized tree (models/quantize)
    carries across as well: int8 ``w_q`` [L, d_in, d_out] -> [d_out, d_in],
    bf16 ``w_scale`` [L, 1, d_out] -> [d_out]; group-wise int4 ``w_q4``
    [L, G, gsz/2, d_out] -> [d_out, G, gsz/2] (the same bytes: the
    packings agree), bf16 ``w_gscale`` [L, G, d_out] -> [d_out, G]; the
    fused ``self.qkv`` entry like any dense. A classification head is
    ``classification_head_from_jax``'s."""
    out: dict = {}
    for stack in ("encoder", "decoder"):
        src = dict(tree_np[stack])
        layers = _jax_walk(src.pop("layers"), (stack, "layers"))
        n = arch.encoder_layers if stack == "encoder" else arch.decoder_layers

        def take(node, i):
            if isinstance(node, dict):
                return {k: take(v, i) for k, v in node.items()}
            return node[i]

        out[stack] = _jax_walk(src, (stack,))
        out[stack]["layers"] = {i: take(layers, i) for i in range(n)}
    return _finish(out, arch, dtype, device)


def _jax_leaf(path: tuple, x: np.ndarray) -> torch.Tensor:
    """One leaf of a JAX tree (host numpy) in the port's layout."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":                # ml_dtypes storage
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if path[-1] == "w" and path[-2] in ("conv1", "conv2"):
        return t.permute(2, 1, 0)
    if path[-1] in ("w", "w_q", "w_gscale"):
        return t.transpose(-1, -2)
    if path[-1] == "w_scale":                  # [L, 1, d_out] -> [L, d_out]
        return t.squeeze(-2)
    if path[-1] == "w_q4":                     # [L, G, gsz/2, d_out]
        return t.permute(0, 3, 1, 2)
    return t


def _jax_walk(node, path: tuple = ()):
    if isinstance(node, Mapping):
        return {k: _jax_walk(v, path + (k,)) for k, v in node.items()}
    return _jax_leaf(path, node)


def classification_head_from_jax(head_np: Mapping[str, Any],
                                 dtype: torch.dtype = torch.float32,
                                 device: torch.device | str = "cpu"
                                 ) -> Params:
    """The JAX package's classification head ({"projector", "classifier"},
    reference whisper.py:939), read back to host numpy, -> the head that
    ``classification_head_from_state_dict`` gives for the same weights."""
    return classification_head_from_state_dict(
        {f"{name}.{hf}": _jax_walk(head_np[name][ours], (name, ours))
         for name in ("projector", "classifier")
         for hf, ours in (("weight", "w"), ("bias", "b"))
         if ours in head_np[name]}, dtype, device)


def classification_head_from_state_dict(state: Mapping[str, Any],
                                        dtype: torch.dtype = torch.float32,
                                        device: torch.device | str | None
                                        = None) -> Params:
    """WhisperForAudioClassification's ``projector.*`` and
    ``classifier.*`` tensors (modeling_whisper.py:1500) -> the head of
    models/whisper.audio_classification_forward: {"projector": {w, b},
    "classifier": {w, b}}, already the port's [d_out, d_in] layout, cast
    to ``dtype`` on ``device`` ("cuda" unless the caller names one)."""
    dev = resolve_device(device, "classification_head_from_state_dict")

    def tensor(key):
        v = state[key]
        t = v if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        return t.to(device=dev, dtype=dtype).contiguous()

    head: Params = {}
    for name in ("projector", "classifier"):
        head[name] = {"w": tensor(f"{name}.weight")}
        if f"{name}.bias" in state:
            head[name]["b"] = tensor(f"{name}.bias")
    return head


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read every tensor of one .safetensors file (CPU tensors)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(f.read())
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype "
                             f"{info['dtype']}")
        np_dtype, torch_dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * np.dtype(np_dtype).itemsize \
                or end > len(data):
            raise ValueError(f"{path}: tensor {name} has inconsistent "
                             "offsets")
        arr = np.frombuffer(data, dtype=np.dtype(np_dtype).newbyteorder("<"),
                            count=count, offset=start).reshape(shape)
        t = torch.from_numpy(arr.astype(np_dtype, copy=True))
        out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 \
            else t
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]
                      ) -> int:
    """Write ``tensors`` (any device; F64, F32, F16, BF16, I64, I32, I16,
    I8, U8 or BOOL) to one .safetensors file that ``read_safetensors`` and
    the ``safetensors`` package read back bit for bit: tensors in name
    order, laid end to end after the header. The header carries
    ``{"format": "pt"}``, as ``save_pretrained`` writes it, because
    ``from_pretrained`` checks it. Returns the bytes written."""
    names = sorted(tensors)
    header: dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _ST_TAGS:
            raise ValueError(f"{path}: tensor {name} has dtype {t.dtype}, "
                             "which safetensors does not store")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)            # data starts on 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:          # numpy has no bf16
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
    return 8 + len(blob) + offset


def state_dict_from_params(params: Params) -> dict[str, torch.Tensor]:
    """The inverse of ``params_from_state_dict`` (reference loader.py:242):
    port params -> a flat HF state dict ("model."-prefixed keys, torch
    layouts, which are the port's own), for export into the reference
    stack (``from_pretrained``). The tensors are the params' own, on their
    device. Quantized (``w_q``/``w_q4``) and fused (``qkv``) trees cannot
    be exported: ValueError; export the source params instead."""
    out: dict[str, torch.Tensor] = {}

    def lin(prefix: str, p: Params) -> None:
        if "w_q" in p or "w_q4" in p:
            raise ValueError(f"{prefix}: quantized leaf cannot be exported "
                             "to HF format; export the unquantized params")
        out[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            out[f"{prefix}.bias"] = p["b"]

    def ln(prefix: str, p: Params) -> None:
        out[f"{prefix}.weight"] = p["scale"]
        out[f"{prefix}.bias"] = p["bias"]

    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):
        out[f"model.encoder.{name}.weight"] = enc[name]["w"]
        out[f"model.encoder.{name}.bias"] = enc[name]["b"]
    out["model.encoder.embed_positions.weight"] = enc["pos"]
    ln("model.encoder.layer_norm", enc["ln_post"])
    out["model.decoder.embed_tokens.weight"] = dec["tok_emb"]
    out["model.decoder.embed_positions.weight"] = dec["pos_emb"]
    ln("model.decoder.layer_norm", dec["ln"])
    for i, lp in enumerate(enc["layers"]):
        base = f"model.encoder.layers.{i}"
        ln(f"{base}.self_attn_layer_norm", lp["ln1"])
        ln(f"{base}.final_layer_norm", lp["ln2"])
        for hf, ours in _ATTN_MAP.items():
            lin(f"{base}.self_attn.{hf}", lp["attn"][ours])
        lin(f"{base}.fc1", lp["mlp"]["fc1"])
        lin(f"{base}.fc2", lp["mlp"]["fc2"])
    for i, lp in enumerate(dec["layers"]):
        base = f"model.decoder.layers.{i}"
        if "qkv" in lp["self"]:
            raise ValueError(f"{base}: fused q/k/v cannot be exported to HF "
                             "format; export the params before "
                             "fuse_decoder_qkv")
        ln(f"{base}.self_attn_layer_norm", lp["ln1"])
        ln(f"{base}.encoder_attn_layer_norm", lp["ln2"])
        ln(f"{base}.final_layer_norm", lp["ln3"])
        for hf, ours in _ATTN_MAP.items():
            lin(f"{base}.self_attn.{hf}", lp["self"][ours])
            lin(f"{base}.encoder_attn.{hf}", lp["cross"][ours])
        lin(f"{base}.fc1", lp["mlp"]["fc1"])
        lin(f"{base}.fc2", lp["mlp"]["fc2"])
    return out


def save_hf_checkpoint(model_dir: str, params: Params, arch: WhisperArch,
                       config_extra: Mapping[str, Any] | None = None
                       ) -> None:
    """Write an HF-format checkpoint directory (model.safetensors and
    config.json) that ``load_params``, the JAX package's loader and the
    reference's ``from_pretrained`` read. Tokenizer and generation files
    are the caller's (they are data, not weights)."""
    os.makedirs(model_dir, exist_ok=True)
    write_safetensors(os.path.join(model_dir, "model.safetensors"),
                      state_dict_from_params(params))
    cfg = {**arch.to_hf_config(), **(dict(config_extra) if config_extra
                                      else {})}
    cfg.setdefault("model_type", "whisper")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)


def _iter_safetensor_files(model_dir: str) -> Iterable[str]:
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        for fname in sorted(set(weight_map.values())):
            yield os.path.join(model_dir, fname)
    else:
        single = os.path.join(model_dir, "model.safetensors")
        if not os.path.exists(single):
            raise FileNotFoundError(f"no safetensors in {model_dir}")
        yield single


def load_params(model_dir: str, arch: WhisperArch | None = None,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device | str | None = None,
                mesh: Any | None = None) -> tuple[Params, WhisperArch]:
    """Load a local HF-format Whisper checkpoint directory -> (params,
    arch), on ``device`` ("cuda" unless the caller names one).

    mesh: a ("data", "model") mesh (parallel/mesh.make_mesh): the tensors
    are cast on the host and this rank copies only its own slices to its
    device (parallel/mesh.shard_params), so the whole model never lands on
    one card (reference loader.py:207-239). A ``device`` other than the
    mesh's is a ValueError."""
    if mesh is not None:
        from ..parallel.mesh import check_device, shard_params
        check_device(mesh, device, "load_params")
    else:
        device = resolve_device(device, "load_params")
    if arch is None:
        with open(os.path.join(model_dir, "config.json")) as f:
            arch = WhisperArch.from_hf_config(json.load(f))
    state: dict[str, torch.Tensor] = {}
    for path in _iter_safetensor_files(model_dir):
        state.update(read_safetensors(path))
    if mesh is not None:
        return shard_params(params_from_state_dict(state, arch, dtype,
                                                   "cpu"), mesh), arch
    return params_from_state_dict(state, arch, dtype, device), arch
