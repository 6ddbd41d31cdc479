"""Kernel wrappers and the plain alignment chain.

The JAX package's public names, but for ``supports_pallas`` and the test
oracle ``dequant_reference`` (the port's is
models.whisper.quantized_attention)."""

from .alignment import (attention_to_jump_times, dtw_jump_times, dtw_trace,
                        median_filter, znorm_tokens)
# NOTE: neither the fused_attention nor the dtw FUNCTION is re-exported
# here under its own name: it would shadow its submodule on the package
# (import-as resolves attributes first); use
# `from crisperwhisper_tpu_torch.ops.fused_attention import fused_attention`.
# The DTW kernel's wrapper keeps the JAX package's name for its kernel
# entry.
from .dtw import dtw as pallas_dtw_jump_times

__all__ = ["attention_to_jump_times", "dtw_jump_times", "dtw_trace",
           "median_filter", "znorm_tokens", "pallas_dtw_jump_times"]
