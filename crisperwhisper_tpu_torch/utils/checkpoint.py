"""Save and restore a parameter tree in the port's own format.

Port of crisperwhisper_tpu/utils/checkpoint.py, which writes an orbax
checkpoint. The HF path (models/loader.py) renames every tensor on each
load and cannot hold a quantized or fused tree; this one stores the
ready tree (plain, fused, int8 or group-wise int4; lists of layer dicts;
f32, bf16, int8 and uint8 leaves) and gives it back bit for bit.

Format: ``<path>/params.pt`` written by ``torch.save`` and read by
``torch.load(weights_only=True, map_location=device)``, and
``<path>/metadata.json`` beside it when metadata is given. ``torch.save``
keeps the tree's structure (dicts, lists) and every dtype as they are, so
nothing has to encode them in key names, and ``weights_only=True``
unpickles only tensors and plain containers, so loading a file runs no
code from it. Neither needs orbax, safetensors or JAX.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from .._device import resolve as resolve_device


def _own_storage(tree: Any) -> Any:
    """The tree with every tensor that views a larger storage copied out,
    so that saving a slice (a layer of a stacked array, the first layers
    of a model) does not write the whole storage behind it."""
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_own_storage(v) for v in tree)
    if isinstance(tree, torch.Tensor) and (
            tree.untyped_storage().nbytes()
            != tree.numel() * tree.element_size()
            or not tree.is_contiguous()):
        return tree.contiguous().clone()
    return tree


def save_params(path: str, params: Any,
                metadata: dict | None = None) -> None:
    """Save a parameter tree (dicts and lists of tensors of any dtype, on
    any device) to the directory ``path``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    torch.save(_own_storage(params), os.path.join(path, "params.pt"))
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f)


def load_saved_params(path: str,
                      device: torch.device | str | None = None
                      ) -> tuple[Any, dict]:
    """Restore a tree saved by ``save_params`` onto ``device`` ("cuda"
    unless the caller names one): (params, metadata), metadata {} when
    none was saved."""
    dev = resolve_device(device, "load_saved_params")
    path = os.path.abspath(path)
    params = torch.load(os.path.join(path, "params.pt"), map_location=dev,
                        weights_only=True)
    meta_path = os.path.join(path, "metadata.json")
    metadata = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return params, metadata
