"""Device mesh and tensor-parallel sharding rules over torch.distributed.

Port of crisperwhisper_tpu/parallel/mesh.py. The chunk batch is split over
the "data" axis (each 30 s window is independent) and the attention heads
and MLP hidden units of the transformer over the "model" axis.

The JAX package has one controller process and lets XLA insert the
collectives from its shardings. Here each rank is one process that owns
one device (``cuda:LOCAL_RANK``, or the CPU under gloo) and keeps only its
own slice of every parameter, as a plain tensor. The one collective of the
forward pass is the sum a row-parallel dense needs: ``models/whisper.dense``
all-reduces its partial product over the "model" group before the bias,
wherever ``shard_params`` left the ``REDUCE`` key in the dense's dict. A
tree without it takes the unsharded code path and no collective.

Sharding layout per leaf, in the port's layout (weights [d_out, d_in],
one dict per layer); a spec is a tuple with an axis name or None per
dimension, trailing dimensions unnamed, () replicated:
  attn q/k/v, mlp fc1 (column-parallel): w ("model", None), b ("model",)
  attn o, mlp fc2 (row-parallel):        w (None, "model"), b ()
  everything else (LayerNorms, conv stem, embeddings): replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .._device import resolve as resolve_device

DATA, MODEL = "data", "model"
REDUCE = "tp_reduce"    # a row-parallel dense: all-reduce the partial product
SLICE = "tp_slice"      # a replicated fused qkv: keep this rank's heads


@dataclass(frozen=True)
class AxisShard:
    """This rank's place on one mesh axis: the process group of the ranks
    that share its other coordinates, its index on the axis and the axis
    size."""
    group: Any
    index: int
    size: int


def make_mesh(data: int = 1, model: int = 1, devices: list | None = None,
              device: torch.device | str | None = None):
    """A ("data", "model") DeviceMesh over the ranks of the initialised
    process group (``init_multihost``), row-major as the JAX mesh:
    rank ``devices[i * model + j]`` holds place (i, j). ``devices`` lists
    global ranks (default: every rank in order). ``device``: where each
    rank keeps its tensors, its card by default ("cuda", the device set by
    ``torch.cuda.set_device``); pass "cpu" for a gloo world of CPU ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_multihost (or init_process_group) first")
    world = dist.get_world_size()
    ranks = list(devices) if devices is not None else list(range(world))
    n = data * model
    if n > len(ranks):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, "
                         f"have {len(ranks)}")
    if n != world:
        raise ValueError(f"mesh {data}x{model} covers {n} of the world's "
                         f"{world} ranks; every rank must hold a place")
    dev = resolve_device(device, "make_mesh")
    return DeviceMesh(dev.type, torch.tensor(ranks[:n]).reshape(data, model),
                      mesh_dim_names=(DATA, MODEL))


def axis_sizes(mesh) -> dict[str, int]:
    """{"data": d, "model": m}, the JAX mesh's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_shard(mesh, axis: str) -> AxisShard:
    return AxisShard(mesh.get_group(axis), mesh.get_local_rank(axis),
                     axis_sizes(mesh)[axis])


def mesh_device(mesh) -> torch.device:
    """The device this rank keeps its tensors on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device, who: str) -> None:
    """ValueError when the caller names a device other than this rank's
    device on ``mesh``."""
    if device is None:
        return
    own, asked = mesh_device(mesh), torch.device(device)
    if asked.type != own.type or asked.index not in (None, own.index):
        raise ValueError(f"{who}: device={asked} is not the mesh's device "
                         f"on this rank ({own})")


# the leaf specs of mesh.py:46-59 (_col_parallel) and :62-76
# (_row_parallel), moved to [d_out, d_in] weights: int8 w_q like w; w_scale
# [d_out] splits with d_out and is replicated on a row dense (it applies
# after the sum); group-wise int4 w_q4 [d_out, G, gsz/2] and w_gscale
# [d_out, G] split d_out on a column dense and G on a row dense
_COL = {"w": (MODEL, None), "w_q": (MODEL, None), "w_scale": (MODEL,),
        "w_q4": (MODEL, None, None), "w_gscale": (MODEL, None),
        "b": (MODEL,)}
_ROW = {"w": (None, MODEL), "w_q": (None, MODEL), "w_scale": (),
        "w_q4": (None, MODEL, None), "w_gscale": (None, MODEL), "b": ()}


def _kind(path: tuple) -> str | None:
    """"col", "row", "fused" or None (replicated) for the dense dict at
    ``path`` (mesh.py:79-102 _param_spec)."""
    names = [str(p) for p in path]
    if not names:
        return None
    if any(g in names[:-1] for g in ("attn", "self", "cross")):
        if names[-1] == "qkv":
            # a fused [3d, d] qkv: a plain "model" split of its rows would
            # cut across the q/k/v block boundaries; replicate it instead
            # (mesh.py:87-92), and hub.load_pipeline does not fuse on a mesh
            return "fused"
        return "row" if names[-1] == "o" else "col"
    if "mlp" in names[:-1]:
        return {"fc1": "col", "fc2": "row"}.get(names[-1])
    return None


def _param_spec(path: tuple) -> tuple:
    """The spec of the leaf at ``path`` (its dense dict's path + its key)."""
    kind = _kind(path[:-1])
    if kind == "col":
        return _COL.get(path[-1], ())
    if kind == "row":
        return _ROW.get(path[-1], ())
    return ()                                    # LN, conv, embeddings


def _map(fn, node, path: tuple = ()):
    """``fn(path, leaf)`` over every leaf of a tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(node)]
    return fn(path, node)


def param_pspecs(params: Any) -> Any:
    """A tree of specs with the structure of ``params`` (mesh.py:105-110)."""
    return _map(lambda path, _: _param_spec(path), params)


def _mark(node, path: tuple, shard: AxisShard):
    """Copy of the dict tree with REDUCE in every row-parallel dense and
    SLICE in every fused qkv."""
    if isinstance(node, list):
        return [_mark(v, path + (i,), shard) for i, v in enumerate(node)]
    if not isinstance(node, dict):
        return node
    out = {k: _mark(v, path + (k,), shard) for k, v in node.items()}
    kind = _kind(path)
    if kind == "row":
        out[REDUCE] = shard
    elif kind == "fused":
        out[SLICE] = shard
    return out


def shard_params(params: Any, mesh) -> Any:
    """This rank's tree: every leaf cut to its slice on the "model" axis
    and put on this rank's device (mesh.py:113-117). Works on host
    tensors, so that a loader copies only the slices to the card. On a
    model axis of 1 the tree is only moved: no dense all-reduces."""
    shard = axis_shard(mesh, MODEL)
    dev = mesh_device(mesh)

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for dim, axis in enumerate(_param_spec(path)):
            if axis != MODEL:
                continue
            n = leaf.shape[dim]
            if n % shard.size:
                raise ValueError(f"{'/'.join(map(str, path))}: dimension "
                                 f"{dim} ({n}) does not divide over the "
                                 f"model axis ({shard.size})")
            step = n // shard.size
            leaf = leaf.narrow(dim, shard.index * step, step)
        return leaf.to(dev).contiguous()

    out = _map(place, params)
    return _mark(out, (), shard) if shard.size > 1 else out


def model_shard(params: Any) -> AxisShard | None:
    """The model-axis shard a tree from ``shard_params`` carries, None for
    an unsharded tree (or a model axis of 1)."""
    for stack in ("decoder", "encoder"):
        layers = params.get(stack, {}).get("layers") or [{}]
        lp = layers[0]
        for group in ("self", "attn"):
            if group in lp:
                return lp[group]["o"].get(REDUCE)
    return None


@dataclass(frozen=True)
class BatchSharding:
    """Rows of a batch split over the mesh's "data" axis
    (``data_sharding``): data rank i takes rows [i * B / n, (i + 1) * B / n)
    of a batch of B rows, B a multiple of n."""
    mesh: Any

    @property
    def axis(self) -> AxisShard:
        return axis_shard(self.mesh, DATA)


@dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole value (``replicated``)."""
    mesh: Any


def data_sharding(mesh) -> BatchSharding:
    """Batch-dim sharding for inputs (chunks over the data axis)."""
    return BatchSharding(mesh)


def replicated(mesh) -> Replicated:
    return Replicated(mesh)
