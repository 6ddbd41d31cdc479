"""Random weights from the seed, in the port's parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program (``load_pipeline(params=...)``) and to the plain reference. They
are drawn on the device in four calls (encoder matrices, decoder
matrices, biases, LayerNorms) in the type they are served in, and every
leaf is a view of one of those buffers.

The distributions are chosen so that the decoded tokens depend on the
audio and on the context, as far as random weights allow, while a bf16
forward pass stays close to the f32 one (PERF.md, PR 15, gives the
readings of each choice):

* dense and conv weights are N(0, 1 / fan_in), a term of the residual's
  own size from each layer (the port's ``init_params`` draws N(0, 0.02),
  and a small model then decodes one token at every position);
* queries and keys are 1.5 times that, so attention is sharper than an
  average over frames (3 times made the model chaotic: bf16 and f32
  runs then differ as much as fp8 and f32 do);
* the encoder's residual branches (attention output, fc2) are a tenth
  of it, so that each frame keeps its own features through the encoder
  and the frames do not collapse to one vector with depth;
* the embeddings keep N(0, 0.02); biases and LayerNorms are drawn too
  (N(0, 0.02) around 0 and 1), so that a path that drops a bias or a
  LayerNorm's affine shows in the check.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STD = 0.02


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float64))
    t = np.arange(length, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _shapes(arch) -> dict:
    """Per stack: the matrix, bias and LayerNorm leaves as (path, shape)
    lists, in the port's layout (linear weights [d_out, d_in])."""
    d = arch.d_model
    mats: dict[str, list] = {"encoder": [], "decoder": []}
    bias: list = []
    norms: list = []

    def lin(stack, path, d_in, d_out, with_bias=True):
        mats[stack].append((path + ("w",), (d_out, d_in)))
        if with_bias:
            bias.append((path + ("b",), (d_out,)))

    def attn(stack, path):
        lin(stack, path + ("q",), d, d)
        lin(stack, path + ("k",), d, d, with_bias=False)
        lin(stack, path + ("v",), d, d)
        lin(stack, path + ("o",), d, d)

    def ln(path):
        norms.append((path + ("scale",), (d,)))
        norms.append((path + ("bias",), (d,)))

    mats["encoder"].append((("encoder", "conv1", "w"),
                            (d, arch.num_mel_bins, 3)))
    bias.append((("encoder", "conv1", "b"), (d,)))
    mats["encoder"].append((("encoder", "conv2", "w"), (d, d, 3)))
    bias.append((("encoder", "conv2", "b"), (d,)))
    for i in range(arch.encoder_layers):
        p = ("encoder", "layers", i)
        ln(p + ("ln1",))
        attn("encoder", p + ("attn",))
        ln(p + ("ln2",))
        lin("encoder", p + ("mlp", "fc1"), d, arch.encoder_ffn_dim)
        lin("encoder", p + ("mlp", "fc2"), arch.encoder_ffn_dim, d)
    ln(("encoder", "ln_post"))
    mats["decoder"].append((("decoder", "tok_emb"), (arch.vocab_size, d)))
    mats["decoder"].append((("decoder", "pos_emb"),
                            (arch.max_target_positions, d)))
    for i in range(arch.decoder_layers):
        p = ("decoder", "layers", i)
        ln(p + ("ln1",))
        attn("decoder", p + ("self",))
        ln(p + ("ln2",))
        attn("decoder", p + ("cross",))
        ln(p + ("ln3",))
        lin("decoder", p + ("mlp", "fc1"), d, arch.decoder_ffn_dim)
        lin("decoder", p + ("mlp", "fc2"), arch.decoder_ffn_dim, d)
    ln(("decoder", "ln"))
    return {"mats": mats, "bias": bias, "norms": norms}


def _put(tree: dict, path: tuple, value) -> None:
    """Set tree[path] = value, making the dicts and the per-layer lists
    (an int key) on the way."""
    node = tree
    for i, key in enumerate(path[:-1]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(
                key, [] if isinstance(path[i + 1], int) else {})
    node[path[-1]] = value


QK_GAIN = 1.5                    # queries and keys
ENCODER_BRANCH_GAIN = 0.1        # the encoder's attention output and fc2


def _std(path: tuple, shape: tuple) -> float:
    """The std of a matrix leaf (see the module's docstring)."""
    if path[-1] in ("tok_emb", "pos_emb"):
        return STD
    gain = 1.0
    if path[-2] in ("q", "k"):
        gain = QK_GAIN
    elif path[0] == "encoder" and path[-2] in ("o", "fc2"):
        gain = ENCODER_BRANCH_GAIN
    return gain / math.sqrt(math.prod(shape[1:]))


def _fill(tree: dict, leaves: list, buf: torch.Tensor,
          scaled: bool = False) -> None:
    """Views of ``buf`` for ``leaves``; with ``scaled``, the leaves are
    laid out by their std, and each run of one std is scaled by one
    multiply."""
    if scaled:
        leaves = sorted(leaves, key=lambda leaf: _std(*leaf))
    off = 0
    runs: list = []
    for path, shape in leaves:
        n = math.prod(shape)
        _put(tree, path, buf[off:off + n].view(shape))
        if scaled:
            std = _std(path, shape)
            if runs and runs[-1][0] == std:
                runs[-1][2] = off + n
            else:
                runs.append([std, off, off + n])
        off += n
    for std, a, b in runs:
        buf[a:b].mul_(std)


def make(arch, seed: int, device, dtype: torch.dtype) -> dict:
    """The whole parameter tree for ``arch`` from ``seed``: matrices and
    biases in ``dtype``, LayerNorms in f32 (the port's layout)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = _shapes(arch)
    tree: dict = {}

    def draw(leaves, dt, scale=1.0):
        n = sum(math.prod(s) for _, s in leaves)
        buf = torch.randn((n,), generator=gen, device=device, dtype=dt)
        if scale != 1.0:
            buf.mul_(scale)
        return buf

    for stack in ("encoder", "decoder"):
        _fill(tree, shapes["mats"][stack],
              draw(shapes["mats"][stack], dtype), scaled=True)
    _fill(tree, shapes["bias"], draw(shapes["bias"], dtype, STD))
    # LayerNorm scales first, around 1; then their biases
    norms = sorted(shapes["norms"], key=lambda leaf: leaf[0][-1] != "scale")
    buf = draw(norms, torch.float32, STD)
    _fill(tree, norms, buf)
    buf[:buf.numel() // 2].add_(1.0)
    tree["encoder"]["pos"] = torch.from_numpy(
        sinusoids(arch.max_source_positions, arch.d_model)).to(
            device=device, dtype=dtype)
    return tree

