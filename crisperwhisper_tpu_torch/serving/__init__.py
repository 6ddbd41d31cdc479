"""Serving over one ASRPipeline: the cross-stream batcher with live
partials, and the incremental single-stream session."""

from .batcher import StreamHandle, StreamingBatcher
from .live import LiveSession

__all__ = ["LiveSession", "StreamHandle", "StreamingBatcher"]
