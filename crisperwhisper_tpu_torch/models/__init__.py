"""Whisper model functions and checkpoint loading."""

from .whisper import (DecoderCache, alignment_selector, decode_step,
                      decode_step_multi, decoder_forward, encode, forward,
                      init_cache, init_params, sinusoids)
from .loader import (classification_head_from_state_dict, load_params,
                     params_from_state_dict)

__all__ = ["DecoderCache", "alignment_selector", "decode_step",
           "decode_step_multi", "decoder_forward", "encode", "forward",
           "init_cache", "init_params", "sinusoids", "load_params",
           "params_from_state_dict", "classification_head_from_state_dict"]
