"""crisperwhisper_tpu_torch — the PyTorch/CUDA port of crisperwhisper_tpu.

The same verbatim-ASR path (mel, encoder, greedy seek-loop decode with
alignment-head capture, DTW word timestamps, pause redistribution),
quantized serving and speculative decoding in PyTorch for an NVIDIA H100,
with hand-written kernels for the encoder attention (CUDA), the alignment
prep (Triton), the DTW (CUDA), the whole-step quantized decoder (CUDA) and
the per-row ring writes (CUDA). It imports no JAX and nothing of
crisperwhisper_tpu: the jax-free host modules it needs (config, tokenizer,
pipeline.pauses, the native helpers) are copies, pinned to the originals
by tests/test_torch_pipeline.py.
"""

__version__ = "0.1.0"
