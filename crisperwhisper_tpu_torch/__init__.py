"""crisperwhisper_tpu_torch — the PyTorch/CUDA port of crisperwhisper_tpu.

The same verbatim-ASR path (mel, encoder, greedy seek-loop decode with
alignment-head capture, DTW word timestamps, pause redistribution),
quantized serving, speculative decoding, beam search, prompting and
multi-stream and live serving (``serving/``) in PyTorch for an NVIDIA
H100, with hand-written CUDA kernels for the encoder attention, the
alignment prep, the DTW, the whole-step quantized decoder and the per-row
ring writes (and for the reference's off-path kernels). ``python -m
crisperwhisper_tpu_torch`` is its CLI. It imports no JAX and nothing of
crisperwhisper_tpu: the jax-free host modules it needs (config,
tokenizer, normalizers, pipeline.pauses, the evaluation metrics, the
native helpers) are copies, pinned to the originals by
tests/test_torch_pipeline.py.
"""

__version__ = "0.1.0"
