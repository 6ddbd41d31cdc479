"""Decoding: processors, greedy, beam and speculative loops, the seek
loop and short-form generation.

The JAX package's public names, but for its jitted entries
(``*_decode_jit``): here the loops are the entries. As in the JAX
package, the package attribute ``generate`` is the seek loop's function,
not the short-form module: import that module's names with
``from crisperwhisper_tpu_torch.decoding.generate import ...``."""

from .assisted import assisted_decode
from .beam import BeamResult, beam_decode
from .fallback import compression_ratio, need_fallback
from .generate import ShortFormOutput, build_prompt, generate_short_form
from .longform import GenerateOutput, generate
from .segments import pad_segments_to_max_length, retrieve_segment
from .greedy import DecodeResult, greedy_decode
from .processors import (TimestampState, apply_begin_suppress,
                         apply_suppress, apply_timestamp_rules,
                         process_scores, suppress_tokens_mask)

__all__ = ["assisted_decode", "BeamResult", "beam_decode",
           "ShortFormOutput", "build_prompt", "generate_short_form",
           "GenerateOutput", "generate", "compression_ratio",
           "need_fallback", "pad_segments_to_max_length",
           "retrieve_segment", "DecodeResult", "greedy_decode",
           "TimestampState", "apply_begin_suppress", "apply_suppress",
           "apply_timestamp_rules", "process_scores", "suppress_tokens_mask"]
