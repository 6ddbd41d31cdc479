"""Tensor- and data-parallel serving over torch.distributed (the port of
crisperwhisper_tpu/parallel/); ``parallel.dryrun`` is the twin of
``__graft_entry__.dryrun_multichip``."""

from .mesh import (data_sharding, make_mesh, param_pspecs, replicated,
                   shard_params)
from .multihost import (host_local_array, init_multihost,
                        make_serving_mesh, process_local_batch)

__all__ = ["data_sharding", "make_mesh", "param_pspecs", "replicated",
           "shard_params", "host_local_array", "init_multihost",
           "make_serving_mesh", "process_local_batch"]
