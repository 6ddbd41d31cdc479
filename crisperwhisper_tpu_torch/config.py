"""Configuration tree for the TPU-native CrisperWhisper framework.

Mirrors the three config layers of the reference system (SURVEY.md §5.6):
  1. the serialized model/checkpoint config  -> :class:`WhisperArch`
  2. the generation config                   -> :class:`GenerationOptions`
  3. pipeline/CLI kwargs                     -> :class:`PipelineOptions`

Field semantics follow the reference checkpoint contract
(ref: hf transformers models/whisper/configuration_whisper.py) but the
representation is our own: frozen dataclasses, static-shape-friendly, with
everything the jitted decode loop needs resolvable at trace time.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class WhisperArch:
    """Architecture hyperparameters of a Whisper-family checkpoint.

    Defaults are the whisper *tiny* geometry; classmethods provide the other
    family members. ``feature_size`` (number of mel bins) is 80 for <=large-v2
    and 128 for large-v3 (SURVEY.md §2.9).
    """

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    # --- canonical family geometries -------------------------------------
    @classmethod
    def tiny(cls, multilingual: bool = False) -> "WhisperArch":
        return cls(vocab_size=51865 if multilingual else 51864)

    @classmethod
    def base(cls) -> "WhisperArch":
        return cls(d_model=512, encoder_layers=6, decoder_layers=6,
                   encoder_attention_heads=8, decoder_attention_heads=8,
                   encoder_ffn_dim=2048, decoder_ffn_dim=2048)

    @classmethod
    def small(cls) -> "WhisperArch":
        return cls(d_model=768, encoder_layers=12, decoder_layers=12,
                   encoder_attention_heads=12, decoder_attention_heads=12,
                   encoder_ffn_dim=3072, decoder_ffn_dim=3072)

    @classmethod
    def medium(cls) -> "WhisperArch":
        return cls(d_model=1024, encoder_layers=24, decoder_layers=24,
                   encoder_attention_heads=16, decoder_attention_heads=16,
                   encoder_ffn_dim=4096, decoder_ffn_dim=4096)

    @classmethod
    def large_v2(cls) -> "WhisperArch":
        return cls(vocab_size=51865, d_model=1280,
                   encoder_layers=32, decoder_layers=32,
                   encoder_attention_heads=20, decoder_attention_heads=20,
                   encoder_ffn_dim=5120, decoder_ffn_dim=5120)

    @classmethod
    def large_v3(cls) -> "WhisperArch":
        return cls(vocab_size=51866, num_mel_bins=128, d_model=1280,
                   encoder_layers=32, decoder_layers=32,
                   encoder_attention_heads=20, decoder_attention_heads=20,
                   encoder_ffn_dim=5120, decoder_ffn_dim=5120)

    @classmethod
    def from_hf_config(cls, d: Mapping[str, Any]) -> "WhisperArch":
        """Build from a parsed HF ``config.json`` mapping."""
        keys = {f.name for f in dataclasses.fields(cls)} - {"activation"}
        kw = {k: d[k] for k in keys if k in d}
        if "activation_function" in d:
            kw["activation"] = d["activation_function"]
        return cls(**kw)

    def to_hf_config(self) -> dict[str, Any]:
        """Inverse of from_hf_config: an HF ``config.json`` mapping
        (checkpoint export — models/loader.save_hf_checkpoint)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "activation"}
        d["activation_function"] = self.activation
        d["model_type"] = "whisper"
        return d


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel frontend parameters.

    Parity contract: hf models/whisper/feature_extraction_whisper.py:94-106
    (n_fft=400, hop=160, fmin=0, fmax=8000, slaney mel bank, 30 s windows).
    """

    feature_size: int = 80          # mel bins; 128 for large-v3
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    chunk_length: int = 30          # seconds

    @property
    def n_samples(self) -> int:
        return self.chunk_length * self.sampling_rate          # 480000

    @property
    def nb_max_frames(self) -> int:
        return self.n_samples // self.hop_length               # 3000


@dataclass(frozen=True)
class SpecialTokens:
    """Special-token layout of the (adjusted) Whisper vocabulary.

    Standard Whisper layout per SURVEY.md §2.9; values here are the
    multilingual-v2 defaults and are overridden from the checkpoint's
    generation_config / tokenizer files at load time.
    """

    eot: int = 50257                 # <|endoftext|> = eos/bos/pad
    sot: int = 50258                 # <|startoftranscript|>
    translate: int = 50358
    transcribe: int = 50359
    sot_prev: int = 50361            # <|startofprev|>
    no_speech: int = 50362           # <|nospeech|>
    no_timestamps: int = 50363       # <|notimestamps|>
    timestamp_begin: int = 50364     # <|0.00|>
    language_begin: int = 50259      # first language token (<|en|>)
    num_languages: int = 99

    @property
    def timestamp_end(self) -> int:
        # 1501 timestamp tokens <|0.00|>..<|30.00|> at 0.02 s
        return self.timestamp_begin + 1500


@dataclass(frozen=True)
class GenerationOptions:
    """Decode-policy configuration (reference: generation_config.json +
    generate(**kwargs) overrides, hf generation_whisper.py:386-661)."""

    max_new_tokens: int = 381   # <= max_target_positions - p. Chosen so
    #                             the standard timestamped pipeline prompt
    #                             [sot, lang, task] (p=3) gives a self-KV
    #                             ring of exactly 384 = 3x128 lanes: the
    #                             seq-last ring pads its last axis to 128
    #                             lanes, and a non-multiple length pays
    #                             that padding on EVERY per-step ring read
    #                             (e.g. 448 -> 512 lanes = 14% waste).
    #                             381 still far exceeds a 30 s verbatim
    #                             chunk (~192 tokens at the retokenized
    #                             vocab's ~2x token rate).
    num_beams: int = 1
    temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float | None = 2.4
    logprob_threshold: float | None = -1.0
    no_speech_threshold: float | None = 0.6
    condition_on_prev_tokens: bool = False
    condition_mode: str = "static"  # positional semantics of the
    #                                 left-padded prev-conditioned prompt:
    #                                 "static"  = pads CONSUME learned
    #                                 positions (HF padding='max_length'
    #                                 static-cache mode, hf
    #                                 generation_whisper.py:1913-1921);
    #                                 "dynamic" = mask-aware positions —
    #                                 real tokens take 0..len-1, pads take
    #                                 none (HF default padding='longest'
    #                                 + decoder_position_ids =
    #                                 cumsum(mask)-1, hf generation/
    #                                 utils.py "Create missing
    #                                 position_ids on the fly"). Same
    #                                 static shapes either way: dynamic
    #                                 mode only shifts the pos_emb gather
    #                                 by a per-row offset.
    return_timestamps: bool = True
    return_token_timestamps: bool = True
    median_filter_width: int = 7               # app overrides to 3 (ref:app.py:41)
    alignment_heads: tuple[tuple[int, int], ...] = ()
    suppress_tokens: tuple[int, ...] = ()
    begin_suppress_tokens: tuple[int, ...] = ()
    max_initial_timestamp_index: int = 50      # 1.0 s (hf logits_process.py:1946)
    language: str | None = None
    task: str = "transcribe"
    forced_tokens: tuple[int | None, ...] | None = None
    #                               legacy `forced_decoder_ids` VALUES
    #                               (positions 1..N after sot), already
    #                               validated by hub.load_generation_options
    #                               (hf generation_whisper.py:1503-1541).
    #                               Consumed by build_prompt only when no
    #                               language token is pinned, exactly like
    #                               the reference's task/language-unset
    #                               gate. A None in slot 0 = undefined
    #                               language (detection follows).
    prompt_ids: tuple[int, ...] | None = None
    #                               user prompt injection — the output of
    #                               WhisperTokenizer.get_prompt_ids
    #                               ([<|startofprev|>, *text ids]); biases
    #                               decoding toward domain vocabulary (hf
    #                               generate(prompt_ids=...),
    #                               generation_whisper.py:1875-1943).
    force_unique_generate_call: bool = False
    #                               run EXACTLY ONE seek iteration per
    #                               generate call (hf generate
    #                               (force_unique_generate_call=True),
    #                               generation_whisper.py:913 — the loop
    #                               breaks after the first pass instead
    #                               of re-decoding a window remainder).
    #                               The chunked pipeline's 30 s windows
    #                               are single-pass with real checkpoints
    #                               almost always; this pins it.
    prompt_condition_type: str = "first-segment"
    #                               "first-segment": the prompt seeds the
    #                               previous-context buffer and is trimmed
    #                               away as real segments accumulate;
    #                               "all-segments": every window's
    #                               conditioned prefix re-begins with the
    #                               full prompt (requires
    #                               condition_on_prev_tokens=True, hf
    #                               _set_prompt_condition_type :1755-1771).
    time_precision: float = 0.02
    prompt_seed: int = 0
    kv_cache_int8: bool = False     # int8 cross-KV cache (serving)
    kv_cache_int4: bool = False     # int4 cross-KV (halves the decode
    #                                 loop's dominant HBM read; wins over
    #                                 int8 when the batch is large enough
    #                                 to be bandwidth-bound)
    self_kv_cache_int8: bool = False  # int8 SELF ring (columns quantized
    #                                   as written; per-position scales
    #                                   folded outside the dots)
    self_kv_cache_int4: bool = False
    assistant_spec_len: int = 5     # speculation window for assisted
    #                                 decoding (hf num_assistant_tokens
    #                                 default, generation config)
    prompt_lookup: bool = False     # draft-free n-gram speculation (hf
    #                                 prompt_lookup_num_tokens analog;
    #                                 window = assistant_spec_len). The
    #                                 pipeline passes it to generate() as
    #                                 assistant="prompt_lookup"; output
    #                                 is exactness-pinned to greedy.
    b1_decode_kernel: bool = False  # batch-1 whole-step Pallas decoder
    #                                 kernel (ops/pallas_decode_b1): one
    #                                 fused kernel streams all decoder
    #                                 weights per step — the single-stream
    #                                 latency lever. Serving NUMERICS
    #                                 OPTION (f32 residual stream vs the
    #                                 XLA step's bf16), token-agreement
    #                                 tested; engages only in the gated
    #                                 int8-weight/int8-self-ring config
    #                                 at batch 1, greedy/sampling.
    staged_ring_quantum: int = 64   # staged ring growth (greedy/sampling
    #                                 XLA loop): > 0 runs the decode loop
    #                                 in ring-width stages of this many
    #                                 slots (use 128 = one lane tile), so
    #                                 the self-attention read scales with
    #                                 the LIVE prefix instead of the full
    #                                 allocated ring (~1/3 of the
    #                                 dominant batched self-ring read at
    #                                 the 192-token budget). Numerics
    #                                 contract (tests/test_staged_ring.py):
    #                                 token sequences are pinned EXACT on
    #                                 every path; probabilities
    #                                 (alignment/logprobs) are bitwise
    #                                 when the ring fits a few quanta and
    #                                 move by reduction-order ulp at
    #                                 wider rings (width-dependent sum
    #                                 parenthesization; measured 9.3e-10
    #                                 max abs at ring 151) — alignment
    #                                 consumers needing bitwise repro of
    #                                 a non-staged run must set 0 = off
    #                                 (single full-width loop). Applies
    #                                 to greedy/sampling, beam AND
    #                                 assisted loops. Default 64 from
    #                                 the round-4 on-chip quantum sweep
    #                                 (large-v3 B=64, 192 tokens, device
    #                                 RTFx: off 365.8 / 64 -> 390.3 /
    #                                 128 -> 383.7 / 256 -> 365.4); the
    #                                 assisted path was A/B'd separately
    #                                 at B=1 (staged on beats off,
    #                                 245.5 vs 251.6 ms prompt-lookup).


@dataclass(frozen=True)
class PipelineOptions:
    """Chunked long-form orchestration (ref:transcribe.py:21-31 defaults)."""

    chunk_length_s: float = 30.0
    stride_length_s: tuple[float, float] | None = None   # default chunk/6 each side
    batch_size: int = 16
    return_timestamps: str | bool = "word"
    assistant_max_batch: int | None = None  # latency-adaptive speculation:
    #                                 use the pipeline's assistant (draft
    #                                 model / self:K / prompt_lookup) only
    #                                 for device batches of at most this
    #                                 many rows. The measured crossover
    #                                 (scripts/spec_accept_bench.py, v5e):
    #                                 speculation is ~1.7-2x at batch 1
    #                                 but LOSES at large batch (0.86x at
    #                                 B=64 even with a perfect draft), so
    #                                 assistant_max_batch=1 gives
    #                                 interactive single-chunk requests
    #                                 the speculative fast path while
    #                                 full batches stay plain greedy.
    #                                 None = use the assistant always.

    def strides(self) -> tuple[float, float]:
        if self.stride_length_s is None:
            s = self.chunk_length_s / 6.0
            return (s, s)
        return tuple(self.stride_length_s)  # type: ignore[return-value]

    @classmethod
    def throughput(cls, **overrides: Any) -> "PipelineOptions":
        """The measured-optimal bulk-transcription shape on one v5e chip:
        batch 96 (the round-4 on-chip batch sweep optimum — 64: 390 /
        96: 413 device RTFx; 128 exhausts HBM on the int4 cross caches).
        Pair with hub.load_pipeline(quantize="serving"). The default
        PipelineOptions keeps the reference-parity batch_size=16
        (ref: hf pipeline batch_size)."""
        return cls(**{"batch_size": 96, **overrides})


def load_checkpoint_configs(model_dir: str) -> dict[str, Any]:
    """Read config.json / generation_config.json / preprocessor_config.json
    from a local checkpoint directory into plain dicts (missing files -> {})."""
    out: dict[str, Any] = {}
    for name in ("config", "generation_config", "preprocessor_config"):
        path = os.path.join(model_dir, name + ".json")
        if os.path.exists(path):
            with open(path) as f:
                out[name] = json.load(f)
        else:
            out[name] = {}
    return out
