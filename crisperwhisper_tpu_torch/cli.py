"""CLI transcriber on the PyTorch port — the ref:transcribe.py equivalent.

Usage:
    python -m crisperwhisper_tpu_torch.cli --f audio.wav --model /path/ckpt \\
        [--language en] [--batch-size 16] [--chunk-length-s 30] \\
        [--timestamps word] [--adjust-pauses 0.12] [--json] \\
        [--num-beams N] [--prompt TEXT] \\
        [--quantize none|int8|serving] [--assistant prompt_lookup|self:K] \\
        [--device cuda|cpu]

The flags are those of crisperwhisper_tpu.cli, and ``--device``: the model
runs on the CUDA card unless ``--device cpu`` asks for the CPU (the
counterpart of the reference's JAX_PLATFORMS). ``--num-beams`` decodes
with beam search, ``--prompt`` biases the decoder with a text prompt,
``--quantize`` loads the quantized decoder and ``--assistant`` decodes
speculatively (the ``quantize`` and ``assistant`` of hub.load_pipeline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transcribe an audio file.")
    p.add_argument("--f", type=str, required=True,
                   help="Path to the audio file")
    p.add_argument("--model", type=str, required=True,
                   help="Local checkpoint directory (HF format)")
    p.add_argument("--language", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--chunk-length-s", type=float, default=30.0)
    p.add_argument("--timestamps", type=str, default="word",
                   choices=["word", "segment", "none"])
    p.add_argument("--num-beams", type=int, default=1)
    p.add_argument("--adjust-pauses", type=float, default=None,
                   metavar="THRESHOLD",
                   help="Apply pause redistribution (e.g. 0.12)")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "serving"],
                   help="Serving quantization: int8 decoder weights "
                        "with an int8 cross cache (int8), or with an int4 "
                        "cross cache and an int8 self ring (serving)")
    p.add_argument("--prompt", type=str, default=None,
                   help="Domain-vocabulary bias text (tokenized via "
                        "get_prompt_ids; the reference's prompt_ids)")
    p.add_argument("--assistant", type=str, default=None, metavar="MODE",
                   help="Speculative decoding: 'prompt_lookup' or "
                        "'self:K' (layer-truncated self-draft)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Where the model runs (default: the CUDA card)")
    p.add_argument("--json", action="store_true",
                   help="Print the full result dict as JSON")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.f):
        print(f"Error: The file '{args.f}' does not exist.")
        return 1
    try:
        from dataclasses import replace

        from .config import PipelineOptions

        from .hub import load_pipeline

        rt = {"word": "word", "segment": True, "none": False}[args.timestamps]
        pipe = load_pipeline(
            args.model, language=args.language, device=args.device,
            quantize={"none": False, "int8": True,
                      "serving": "serving"}[args.quantize],
            assistant=args.assistant,
            pipe_opts=PipelineOptions(chunk_length_s=args.chunk_length_s,
                                      batch_size=args.batch_size,
                                      return_timestamps=rt))
        if args.num_beams > 1:
            pipe.gen_opts = replace(pipe.gen_opts, num_beams=args.num_beams)
        result = pipe(args.f, return_timestamps=rt,
                      adjust_pauses_threshold=args.adjust_pauses,
                      prompt=args.prompt)
        if args.json:
            print(json.dumps(result, default=float))
        else:
            print("Transcription:")
            print(result["text"])
        return 0
    except Exception as e:  # mirror ref:transcribe.py:46-52
        print(f"An error occurred while transcribing the audio: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
