"""Synthetic checkpoints, audio and kernel checks for runs of the port on
the card.

chip_smoke.py and tests/test_torch_gpu.py both take their inputs, their
comparisons and their bands from here, so the two hold the kernels and
the slice to the same limits. The checkpoint directories hold configs and
a tokenizer only; the caller builds random weights with
``models.whisper.init_params``, so nothing is downloaded.

  * ``write_tiny_configs``: the TINY model of tests/helpers.py with 5 s
    windows and a vocabulary aligned to its special tokens
    (tests/vocab_fixture.py ``build_model_vocab_dir``);
  * ``write_large_v3_configs``: the full large-v3 geometry with the
    standard multilingual layout and full text-id coverage
    (scripts/make_bench_ckpt.py ``ensure_bench_checkpoint`` without
    weights);
  * ``write_speech_moe_configs`` and ``speech_moe_params``: a speech LM
    (models/speech_moe.py) at any geometry, with Qwen2's specials, and
    its random weights.

tests/test_torch_pipeline.py checks that both write the same files as
those originals.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .tokenizer.bpe import bytes_to_unicode
from .tokenizer.languages import LANGUAGE_CODES

from .config import SpecialTokens, WhisperArch

SR = 16000
CHUNK_S = 5                 # the TINY model's window (250 source positions)
TS_BAND = 0.02              # one DTW frame: the two sides sum in other orders
ATTN_F32_BAND = 2e-5        # the reference kernel's f32 band
PREP_BAND = 1e-5            # the reference align-prep kernel's band
# The decode-step kernel against its plain version: both are the same f32
# algebra summed in other orders, over up to 32 layers, and a fresh K/V
# column may round one int8 step apart where a value sits near a rounding
# boundary. Measured on an H100 with random decoder biases and LayerNorms
# at large-v3 width, up to 4 rows, at ring position 60, hid stays within
# 1.2e-5 of its largest magnitude and the alignment probabilities within
# 3.5e-6; the bands are 3-4x the worst of those. At position 0 they hold
# for some draws only: the fresh column is then the only live slot, so a
# V value, or a V bf16 scale, that rounds one step apart on the two sides
# reaches hid whole, and every later layer's values move with it (on one
# draw a layer-3 V scale 1.5e-5 of a bf16 step from its rounding boundary
# moved the residual entering layer 4 by 3.5e-4 of its largest; such
# sound draws read tens of times the hid band, and a later value up to 2
# int8 steps apart; testing.fresh_column_divergence shows where). So hid
# and align are also held, at every position and alone at position 0,
# against the plain step fed the kernel's own fresh columns, values and
# bf16 scales (decode_step_errors' ``hid_fed`` / ``align_fed``): hid is
# then held by the kernel's arithmetic, whatever the draw. A kernel that
# used the f32 scale of the fresh column instead of its bf16 rounding read
# 185x the unfed band on one draw, not far above what sound draws read
# there. The fed columns themselves are held to the plain step's own
# rounding of the same layer (``columns_fed``, ``scales_fed``): each value
# within one int8 step and each bf16 scale within one bf16 step, and only
# a few of them apart at all, since one parts only where its f32 value
# before rounding sits within a few f32 ulps of a rounding boundary. On
# an H100 at large-v3 (8 draws at position 0, 1-5 rows at 60) at most
# 5.5e-5 of the values (18 of 4 rows' 327,680) and 7.8e-4 of the scales
# (1 of a row's 1,280) parted; STEP_COLUMN_APART and STEP_SCALE_APART allow
# 18x and 12x that, and a count of at most STEP_APART_FLOOR passes at any
# size, for small shapes. A kernel whose scales were off by under one
# percent (amax / 126, or 2^-8 over) keeps every value within a step and
# hid_fed in band, but moves most of its scales
# (tests/test_torch_decode_step.py). Logits go through the serving head,
# which rounds hid to the activation dtype: with bf16 activations two
# hids a few f32 ulps apart may round to neighbouring bf16 values, so the
# logits band is at least one epsilon of that dtype of the largest logit
# (as attention_error's bf16 band). Values placed exactly on the ties of
# the int8 rounding (``tie_params``) must come out half-to-even, exactly.
STEP_REL_BAND = 5e-5
STEP_ALIGN_BAND = 1e-5
STEP_COLUMN_BAND = 1        # int8 steps
STEP_SCALE_BAND = 1         # bf16 steps
STEP_COLUMN_APART = 1e-3    # share of fresh values apart (fed compare)
STEP_SCALE_APART = 1e-2     # share of fresh bf16 scales apart (fed compare)
STEP_APART_FLOOR = 2        # counts apart that pass at any size
TIE_UNIT = 1.0 / 16         # the f32 (and bf16) scale of a tie column
# The fused log-mel kernel: the reference kernel's band against the rfft
# frontend (tests/test_pallas_kernels.py:85), held against the plain twin
# and against extract_features (torch.stft).
MEL_BAND = 2e-4
# The decode-attention kernels against their plain twins: probabilities
# and aligned rows absolute (f32 sums in other orders); out relative to
# its largest magnitude, because the scaled probabilities round to bf16
# before P.V and one of them may round the other way on the two sides
# (one bf16 step of that term). A bf16 out (v1 and v2 under a bf16 q)
# allows one bf16 epsilon of the largest output, as attention_error does:
# two f32 sums a few ulps apart may round to neighbouring bf16 values.
DA_PROBS_BAND = 1e-6
DA_OUT_REL_BAND = 1e-3

# The grouped expert kernel against its plain twin, relative to the
# largest output: both multiply bf16 operands exactly and sum in f32, in
# other orders; where the two gate/up sums round silu(gate) * up to
# neighbouring bf16 values (about one element in a thousand), the down
# product moves by ~1e-4 of the output's size
MOE_BAND = 2e-3

TINY = dict(
    vocab_size=1000, d_model=64, encoder_layers=2, decoder_layers=2,
    encoder_attention_heads=4, decoder_attention_heads=4,
    encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=250,
    max_target_positions=96, num_mel_bins=80)
TINY_SPECIALS = SpecialTokens(
    eot=900, sot=901, translate=902, transcribe=903, sot_prev=904,
    no_speech=905, no_timestamps=906, timestamp_begin=907,
    language_begin=908, num_languages=0)
TINY_ALIGN_HEADS = [[0, 1], [1, 3], [0, 2]]
LARGE_V3_ALIGN_HEADS = 15   # CrisperWhisper fine-tunes 15 heads

# merge chains of the TINY vocabulary (each pair mergeable left to right)
_MERGES = [
    ("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
    ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d"),
    ("Ġ", "hello"), ("Ġ", "world"),
    ("t", "h"), ("th", "e"), ("Ġ", "the"),
    ("u", "m"), ("u", "h"),
    ("i", "n"), ("Ġ", "in"), ("Ġin", "g"),
    ("[", "U"), ("[U", "H"), ("[UH", "]"),
    ("[U", "M"), ("[UM", "]"),
    ("c", "a"), ("ca", "t"), ("Ġ", "cat"),
    ("d", "o"), ("do", "g"), ("Ġ", "dog"),
]


def _write_json(path: str, obj, **kw) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, **kw)


def _write_tokenizer(path: str, vocab: dict, merges, added: dict) -> None:
    _write_json(os.path.join(path, "vocab.json"), vocab, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    _write_json(os.path.join(path, "added_tokens.json"), added,
                ensure_ascii=False)


def write_tiny_configs(path: str) -> str:
    """The TINY checkpoint directory without weights: configs with 5 s
    windows, byte-level BPE vocabulary padded to 900 entries, then the 7
    specials at the model's ids (900-906)."""
    os.makedirs(path, exist_ok=True)
    vocab = {tok: i for i, tok in enumerate(bytes_to_unicode().values())}
    for a, b in _MERGES:
        vocab.setdefault(a + b, len(vocab))
    i = 0
    while len(vocab) < TINY_SPECIALS.eot:
        vocab.setdefault(f"<unused{i}>", len(vocab))
        i += 1
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|translate|>",
                "<|transcribe|>", "<|startofprev|>", "<|nospeech|>",
                "<|notimestamps|>"]
    _write_tokenizer(path, vocab, _MERGES,
                     {tok: TINY_SPECIALS.eot + j
                      for j, tok in enumerate(specials)})
    _write_json(os.path.join(path, "config.json"),
                {**TINY, "model_type": "whisper", "median_filter_width": 7})
    _write_json(os.path.join(path, "generation_config.json"), {
        "alignment_heads": TINY_ALIGN_HEADS,
        "max_initial_timestamp_index": 50,
        "no_timestamps_token_id": TINY_SPECIALS.no_timestamps,
        "eos_token_id": TINY_SPECIALS.eot,
        "decoder_start_token_id": TINY_SPECIALS.sot,
        "temperature": 0.0})
    _write_json(os.path.join(path, "preprocessor_config.json"), {
        "feature_size": 80, "sampling_rate": SR, "n_fft": 400,
        "hop_length": 160, "chunk_length": CHUNK_S})
    return path


def _base36(n: int) -> str:
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    out = ""
    while True:
        out = digits[n % 36] + out
        n //= 36
        if n == 0:
            return out


def large_v3_align_heads(arch: WhisperArch) -> list[tuple[int, int]]:
    """The (layer, head) alignment heads of the large-v3 configs."""
    return [((2 + 2 * i) % arch.decoder_layers,
             i % arch.decoder_attention_heads)
            for i in range(LARGE_V3_ALIGN_HEADS)]


def write_large_v3_configs(path: str, arch: WhisperArch | None = None) -> str:
    """A large-v3 checkpoint directory without weights: every id below eot
    decodes to a space-led word, so host post-processing of random-weight
    tokens costs what it would on real ones."""
    arch = arch or WhisperArch.large_v3()
    sp = SpecialTokens()
    os.makedirs(path, exist_ok=True)
    vocab = {tok: i for i, tok in enumerate(bytes_to_unicode().values())}
    for i in range(len(vocab), sp.eot):
        vocab[f"Ġw{_base36(i)}"] = i
    added = {"<|endoftext|>": sp.eot, "<|startoftranscript|>": sp.sot}
    for j, code in enumerate(LANGUAGE_CODES[:sp.num_languages]):
        added[f"<|{code}|>"] = sp.language_begin + j
    added.update({"<|translate|>": sp.translate,
                  "<|transcribe|>": sp.transcribe,
                  "<|startofprev|>": sp.sot_prev,
                  "<|nospeech|>": sp.no_speech,
                  "<|notimestamps|>": sp.no_timestamps})
    _write_tokenizer(path, vocab, [], added)
    _write_json(os.path.join(path, "config.json"),
                {**arch.to_hf_config(), "median_filter_width": 7})
    _write_json(os.path.join(path, "generation_config.json"), {
        "alignment_heads": [list(h) for h in large_v3_align_heads(arch)],
        "max_initial_timestamp_index": 50,
        "no_timestamps_token_id": sp.no_timestamps,
        "eos_token_id": sp.eot,
        "pad_token_id": sp.eot,
        "decoder_start_token_id": sp.sot,
        "is_multilingual": True})
    _write_json(os.path.join(path, "preprocessor_config.json"), {
        "feature_size": arch.num_mel_bins, "sampling_rate": SR,
        "n_fft": 400, "hop_length": 160, "chunk_length": 30})
    return path


# Qwen2's specials and Qwen2.5-Omni's audio tokens (speech_moe's prompt)
SPEECH_LM_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                      "<|im_end|>": 151645, "<|AUDIO|>": 151646,
                      "<|audio_start|>": 151647, "<|audio_end|>": 151648}


def write_speech_moe_configs(path: str, hf_config: dict) -> str:
    """A speech-LM checkpoint directory without weights (``model_type``
    ``grin_qwen2_vl``, models/speech_moe.py): ``hf_config`` as its
    config.json, every text id below <|endoftext|> a space-led word,
    Qwen2's specials, 30 s windows."""
    os.makedirs(path, exist_ok=True)
    eot = SPEECH_LM_SPECIALS["<|endoftext|>"]
    vocab = {tok: i for i, tok in enumerate(bytes_to_unicode().values())}
    for i in range(len(vocab), eot):
        vocab[f"Ġw{_base36(i)}"] = i
    _write_tokenizer(path, vocab, [], SPEECH_LM_SPECIALS)
    _write_json(os.path.join(path, "config.json"), hf_config)
    _write_json(os.path.join(path, "generation_config.json"), {
        "eos_token_id": SPEECH_LM_SPECIALS["<|im_end|>"],
        "pad_token_id": eot})
    _write_json(os.path.join(path, "preprocessor_config.json"), {
        "feature_size": hf_config.get("audio_config", {}).get(
            "num_mel_bins", 128), "sampling_rate": SR, "n_fft": 400,
        "hop_length": 160, "chunk_length": 30})
    return path


def speech_moe_params(arch, gen: torch.Generator, device,
                      dtype: torch.dtype) -> dict:
    """Random weights of a ``models.speech_moe.SpeechMoEArch`` in the
    port's layout: the Whisper encoder of ``models.whisper.init_params``,
    then dense N(0, 1 / fan_in) (queries and keys 1.5 times that), token
    embeddings N(0, 1), the router f32
    at 2 / sqrt(hidden), biases N(0, 0.02), RMSNorm weights f32 around 1
    (the benchmark's scales, portbench/archs/grin_qwen2_vl.py)."""
    import dataclasses
    import math

    from .models.whisper import init_params
    audio = dataclasses.replace(arch.audio, decoder_layers=0, vocab_size=1,
                                max_target_positions=1)
    enc = init_params(audio, gen, device, dtype)["encoder"]

    def draw(*shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(std)

    def lin(d_in, d_out, bias=True, gain=1.0):
        p = {"w": draw(d_out, d_in, std=gain / math.sqrt(d_in))}
        if bias:
            p["b"] = draw(d_out, std=0.02)
        return p

    def norm(d):
        return {"scale": draw(d, std=0.02, dt=torch.float32).add_(1.0)}

    d, f, e = arch.hidden_size, arch.expert_dim, arch.num_experts
    kv = arch.num_key_value_heads * arch.head_dim
    s = arch.shared_experts * arch.shared_dim
    layers = [{"ln1": norm(d),
               "attn": {"q": lin(d, d, gain=1.5), "k": lin(d, kv, gain=1.5),
                        "v": lin(d, kv), "o": lin(d, d, bias=False)},
               "ln2": norm(d),
               "router": {"w": draw(e + arch.null_experts, d,
                                    std=2 / math.sqrt(d), dt=torch.float32)},
               "shared": {"gate": lin(d, s, False), "up": lin(d, s, False),
                          "down": lin(s, d, False)},
               "experts": {"gate": draw(e, f, d, std=d ** -0.5),
                           "up": draw(e, f, d, std=d ** -0.5),
                           "down": draw(e, d, f, std=f ** -0.5)}}
              for _ in range(arch.num_hidden_layers)]
    return {"encoder": enc, "adapter": lin(arch.audio.d_model, d),
            "decoder": {"tok_emb": draw(arch.vocab_size, d, std=1.0),
                        "layers": layers, "norm": norm(d),
                        "head": lin(d, arch.vocab_size, bias=False)}}


def tone_audio(seconds: float = 12.0, seed: int = 0) -> np.ndarray:
    """A 300 Hz tone in noise, 16 kHz f32."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 300 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def write_wav(path: str, audio: np.ndarray) -> str:
    """16-bit PCM WAV at 16 kHz."""
    from scipy.io import wavfile
    wavfile.write(path, SR, (audio * 32767).astype(np.int16))
    return path


def to_device(tree, device):
    """A parameter tree (dicts and lists of tensors) with ``tensor.to(device)``
    applied to every leaf: moved to a device, or cast to a dtype."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def tree_mismatch(ref, got, device: str | None = None) -> list[str]:
    """The leaf paths where the tree ``got`` differs from ``ref`` in
    structure (dicts and lists), dtype or bits, or, with ``device``, lies
    on another device type; [] when it is the same tree."""
    if isinstance(ref, dict):
        if not isinstance(got, dict) or got.keys() != ref.keys():
            return ["/"]
        return [f"/{k}{p}" for k in ref
                for p in tree_mismatch(ref[k], got[k], device)]
    if isinstance(ref, list):
        if not isinstance(got, list) or len(got) != len(ref):
            return ["/"]
        return [f"/{i}{p}" for i, (a, b) in enumerate(zip(ref, got))
                for p in tree_mismatch(a, b, device)]
    if not isinstance(got, torch.Tensor) or got.dtype != ref.dtype \
            or (device is not None and got.device.type != device) \
            or got.shape != ref.shape or not torch.equal(got.cpu(),
                                                         ref.cpu()):
        return [""]
    return []


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------


def attention_error(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> tuple[float, float]:
    """(max |fused_attention − reference|, band). The reference is
    ``attention_plain`` on the inputs widened to f32, which is the
    kernel's own algebra (P stays f32), rounded to the input dtype. f32
    keeps the reference kernel's 2e-5; bf16 allows one bf16 epsilon of the
    largest output (1 to 2 ulps: two f32 results that differ in summation
    order may round to neighbouring bf16 values)."""
    from .ops.fused_attention import attention_plain, fused_attention
    got = fused_attention(q, k, v).float()
    ref = attention_plain(q.float(), k.float(), v.float()).to(q.dtype).float()
    band = ATTN_F32_BAND if q.dtype == torch.float32 else \
        torch.finfo(q.dtype).eps * ref.abs().max().item()
    return (got - ref).abs().max().item(), band


def live_cells(n_tokens: torch.Tensor, n_frames: torch.Tensor, t: int,
               m: int) -> torch.Tensor:
    """[B, t, m] bool: token < n_tokens and frame < n_frames per row."""
    dev = n_tokens.device
    return ((torch.arange(t, device=dev)[None, :, None]
             < n_tokens[:, None, None])
            & (torch.arange(m, device=dev)[None, None, :]
               < n_frames[:, None, None]))


def align_prep_error(w: torch.Tensor, n_tokens: torch.Tensor,
                     n_frames: torch.Tensor, width: int = 7
                     ) -> tuple[float, torch.Tensor]:
    """(max |align_prep − align_prep_plain| over the live cells, the
    kernel's output). The DTW reads no cell past n_tokens or n_frames (the
    kernel writes 0 there), so only live cells are compared; band
    ``PREP_BAND``."""
    from .ops.align_prep import align_prep, align_prep_plain
    got = align_prep(w, n_tokens, n_frames, width)
    live = live_cells(n_tokens, n_frames, w.shape[2], w.shape[3])
    err = ((got - align_prep_plain(w, n_tokens, n_frames, width)).abs()
           * live).max().item()
    return err, got


def dtw_error(cost: torch.Tensor, n_tokens: torch.Tensor,
              n_frames: torch.Tensor) -> int:
    """Max |dtw − dtw_jump_times| in frames over every row; 0 is the
    exact match both must give."""
    from .ops.alignment import dtw_jump_times
    from .ops.dtw import dtw
    got = dtw(cost, n_tokens, n_frames)
    return int((got - dtw_jump_times(cost, n_tokens, n_frames)).abs().max()
               .item())


def dtw_phases(cost: torch.Tensor, n_tokens: torch.Tensor,
               n_frames: torch.Tensor) -> tuple[float, float, float]:
    """One launch of the DTW kernel with its stamps on: (milliseconds from
    the first block's start to the last block's end, the walk's and the
    backtrace's milliseconds in the block that ended last) on the device's
    %globaltimer. Needs the card."""
    from .ops.dtw import dtw
    stamps = torch.zeros((cost.shape[0], 3), dtype=torch.int64,
                         device=cost.device)
    dtw(cost, n_tokens, n_frames, stamps=stamps)
    t = stamps.cpu().double()
    last = int(t[:, 2].argmax())
    return (float(t[:, 2].max() - t[:, 0].min()) / 1e6,
            float(t[last, 1] - t[last, 0]) / 1e6,
            float(t[last, 2] - t[last, 1]) / 1e6)


def log_mel_phases(waveform: torch.Tensor, cfg) -> tuple[float, float,
                                                          float]:
    """One call of the fused log-mel kernel with its stamps on: (milliseconds
    from the first FFT block's start to the last clip block's end, the FFT
    launch's and the clip launch's share of them) on the device's
    %globaltimer. Needs the card."""
    from .audio.fused_mel import fused_log_mel
    stamps = torch.tensor([-1, 0, 0], dtype=torch.int64,
                          device=waveform.device)
    fused_log_mel(waveform, cfg, stamps=stamps)
    t = stamps.cpu().double()
    return (float(t[2] - t[0]) / 1e6, float(t[1] - t[0]) / 1e6,
            float(t[2] - t[1]) / 1e6)


def mel_errors(waveform: torch.Tensor, cfg) -> tuple[dict, torch.Tensor]:
    """The fused log-mel kernel against its plain twin and against
    ``extract_features``: ({name: (max error, band)}, the kernel's
    features)."""
    from .audio.fused_mel import fused_log_mel, log_mel_plain
    from .audio.mel import extract_features
    got = fused_log_mel(waveform, cfg)
    return {"plain": ((got - log_mel_plain(waveform, cfg)).abs().max()
                      .item(), MEL_BAND),
            "stft": ((got - extract_features(waveform, cfg)).abs().max()
                     .item(), MEL_BAND)}, got


def decode_attention_inputs(shape: tuple[int, ...], kind: str,
                            gen: torch.Generator, q_dtype=torch.bfloat16
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(q, k, k_scale, v, v_scale) for one query per row against a cache
    of ``shape`` [..., B, H, T, 64]: q [B, H, 64] N(0, 1) / 8 (pre-scaled),
    values of ``kind`` "int8", "int4" (packed), "bf16" or "f32" whose
    dequantized magnitude is about N(0, 1), bf16 scales [..., B, H, T]
    (drawn for float caches too; callers leave them out there)."""
    from .models.whisper import pack_int4
    dev = gen.device
    b, h, _, d = shape[-4:]
    q = (torch.randn((b, h, d), generator=gen, device=dev) / 8).to(q_dtype)
    qmax = 7 if kind == "int4" else 127

    def values():
        if kind in ("bf16", "f32"):
            x = torch.randn(tuple(shape), generator=gen, device=dev)
            return x.to(torch.bfloat16) if kind == "bf16" else x
        x = torch.randint(-qmax, qmax + 1, tuple(shape), generator=gen,
                          device=dev, dtype=torch.int8)
        return pack_int4(x) if kind == "int4" else x

    def scales():
        return ((torch.rand(tuple(shape[:-1]), generator=gen, device=dev)
                 + 1.0) * (1.5 / qmax)).to(torch.bfloat16)
    return q, values(), scales(), values(), scales()


def cross_attention_errors(q: torch.Tensor, k: torch.Tensor,
                           k_scale: torch.Tensor, v: torch.Tensor,
                           v_scale: torch.Tensor, v2: bool = False
                           ) -> dict:
    """``cross_attention_int8`` (``cross_attention_int8_v2`` with ``v2``)
    against its plain twin on q [B, H, 1, 64], int8 K/V [B, H, K, 64] and
    scales [B, H, K, 1]: {name: (max error, band)} for out and probs."""
    from .ops import decode_attention as da
    fn = da.cross_attention_int8_v2 if v2 else da.cross_attention_int8
    out, probs = fn(q, k, k_scale, v, v_scale)
    rout, rprobs = da.cross_attention_int8_plain(q, k, k_scale, v, v_scale,
                                                 q_bf16=v2)
    return _attention_errors(out, rout, {"probs": (probs, rprobs)})


def decode_gemv_errors(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       layer: int, **kw) -> dict:
    """``decode_gemv_attention`` against ``decode_gemv_plain`` on the same
    arguments: {name: (max error, band)} for out (and the aligned rows
    with ``sel``)."""
    from .ops import decode_attention as da
    got = da.decode_gemv_attention(q, k, v, layer, **kw)
    ref = da.decode_gemv_plain(q, k, v, layer, **kw)
    if kw.get("sel") is None:
        return _attention_errors(got, ref, {})
    return _attention_errors(got[0], ref[0], {"aligned": (got[1], ref[1])})


def _attention_errors(out, rout, probs: dict) -> dict:
    rel = max(DA_OUT_REL_BAND, torch.finfo(out.dtype).eps)
    errs = {"out": ((out.float() - rout.float()).abs().max().item(),
                    rel * rout.float().abs().max().item())}
    for name, (got, ref) in probs.items():
        errs[name] = ((got - ref).abs().max().item(), DA_PROBS_BAND)
    return errs


def random_affine(tree, seed: int):
    """``tree`` (a parameter tree of tensors or of numpy arrays) with every
    decoder bias drawn from N(0, 0.02), every decoder LayerNorm gain from
    1 + N(0, 0.1) and shift from N(0, 0.1), each in its leaf's dtype and
    device. init_params leaves them at 0 and 1, where a kernel that
    dropped a bias or read the wrong row of its vector table would still
    agree with its plain version."""
    rng = np.random.default_rng(seed)
    draws = {"b": (0.0, 0.02), "bias": (0.0, 0.1), "scale": (1.0, 0.1)}

    def draw(x, mean, std):
        v = (rng.standard_normal(tuple(x.shape)) * std + mean).astype(
            np.float32)
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(v).to(device=x.device, dtype=x.dtype)
        return v.astype(x.dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        return draw(node, *draws[key]) if key in draws else node
    return {**tree, "decoder": walk(tree["decoder"])}


def quantized_decoder(params, arch: WhisperArch, seed: int = 1):
    """``params`` with random decoder biases and LayerNorms
    (``random_affine``), then the decoder fused and quantized as
    ``load_pipeline(quantize=...)`` does."""
    from .models.quantize import fuse_decoder_qkv, quantize_decoder_weights
    return quantize_decoder_weights(
        fuse_decoder_qkv(random_affine(params, seed), arch.head_dim))


def tie_params(params, arch: WhisperArch):
    """Quantized ``params`` whose layer 0 puts every fresh K and V value on
    a tie of the int8 rounding: the K/V rows of its fused QKV weights are
    zero and their biases TIE_UNIT times ±127 then ±0.5, ±1.5, ... ±7.5
    in each head. The f32 scale is then exactly TIE_UNIT (as is its bf16
    rounding) and every other value divides to k + 0.5, where rounding
    half-to-even and half away from zero differ."""
    d, dh = arch.d_model, arch.head_dim
    i = np.arange(dh)
    head = np.where(i % 2 == 0, 1.0, -1.0) * ((i - 1) % 8 + 0.5)
    ties = []
    for top in (127.0, -127.0):                       # K, then V
        head[0] = top
        ties.append(np.tile(head, d // dh))
    dec = params["decoder"]
    qkv = dec["layers"][0]["self"]["qkv"]
    w_q, b = qkv["w_q"].clone(), qkv["b"].clone()
    w_q[d:] = 0
    b[d:] = torch.from_numpy(np.concatenate(ties) * TIE_UNIT).to(b)
    lay0 = {**dec["layers"][0],
            "self": {**dec["layers"][0]["self"],
                     "qkv": {**qkv, "w_q": w_q, "b": b}}}
    return {**params, "decoder": {**dec,
                                  "layers": [lay0, *dec["layers"][1:]]}}


def _fresh(ring: torch.Tensor, position: int, n: int) -> torch.Tensor:
    """The fresh columns of a step: ring[:, :, :, position] (one per
    stream), or with n > 1 the multi mode's [:, 0, :, position:+n] as
    [L, n, H, ...]."""
    if n == 1:
        return ring[:, :, :, position]
    return ring[:, 0, :, position:position + n].transpose(1, 2)


def tie_column_error(params, arch: WhisperArch, x0: torch.Tensor,
                     position: int, cache, plain: bool = False,
                     multi: bool = False, beams: bool = False) -> int:
    """Largest distance, in int8 steps, of layer 0's fresh K/V columns
    from the half-to-even rounding of ``tie_params``'s values (0 is the
    exact match it must give; a bf16 scale other than TIE_UNIT counts as
    128). Runs ``whole_step`` (its plain version with ``plain``; the
    verify-block mode with ``multi``, the beams mode with ``beams``) on a
    clone of ``cache``."""
    from .ops.decode_step import whole_step, whole_step_plain
    tp = tie_params(params, arch)
    work = clone_cache(cache)
    (whole_step_plain if plain else whole_step)(tp, arch, x0, position,
                                                work, (None,), multi=multi,
                                                beams=beams)
    d = arch.d_model
    n = x0.shape[0] if multi else 1
    b = tp["decoder"]["layers"][0]["self"]["qkv"]["b"].float().cpu()
    err = 0
    for i, name in enumerate(("self_k", "self_v")):
        want = torch.round(b[(i + 1) * d:(i + 2) * d] / TIE_UNIT)
        got = _fresh(getattr(work, name), position, n)[0].float().cpu()
        err = max(err, int((got.reshape(got.shape[0], d) - want)
                           .abs().max()))
        scale = _fresh(getattr(work, name + "_scale"), position, n)[0]
        if not bool((scale.float() == TIE_UNIT).all()):
            err = max(err, 128)
    return err


def random_step_cache(arch: WhisperArch, rows: int, cross: str,
                      ring: int, position: int, gen: torch.Generator,
                      k_enc: int | None = None, shared_cross: bool = False):
    """A serving cache with random content: an int8 ring filled below
    ``position`` (zeros from there), an int8 or packed-int4 cross cache
    (of batch 1 with ``shared_cross``: the beams mode's), bf16 scales
    about what quantized N(0, 1) projections give."""
    from .models.whisper import DecoderCache, pack_int4
    dev = gen.device
    n, h, dh = arch.decoder_layers, arch.decoder_attention_heads, \
        arch.head_dim
    k_enc = k_enc or arch.max_source_positions

    def ints(shape, qmax):
        return torch.randint(-qmax, qmax + 1, shape, generator=gen,
                             device=dev, dtype=torch.int8)

    def scales(shape, qmax):
        return ((torch.rand(shape, generator=gen, device=dev) + 1.0)
                * (2.0 / qmax)).to(torch.bfloat16)

    def ring_half():
        x = ints((n, rows, h, ring, dh), 127)
        x[:, :, :, position:] = 0
        return x

    def ring_scales():
        x = scales((n, rows, h, ring), 127)
        x[:, :, :, position:] = 0
        return x

    qmax = 7 if cross == "int4" else 127
    items = 1 if shared_cross else rows

    def cross_half():
        x = ints((n, items, h, k_enc, dh), qmax)
        return pack_int4(x) if cross == "int4" else x
    return DecoderCache(
        self_k=ring_half(), self_v=ring_half(),
        cross_k=cross_half(), cross_v=cross_half(),
        cross_k_scale=scales((n, items, h, k_enc), qmax),
        cross_v_scale=scales((n, items, h, k_enc), qmax),
        self_k_scale=ring_scales(), self_v_scale=ring_scales())


def repeat_cross(cache, rows: int):
    """A clone of ``cache`` whose cross cache of batch 1 is repeated to
    ``rows`` items: the rows mode's layout of the beams mode's cache."""
    from dataclasses import replace
    work = clone_cache(cache)
    return replace(work, **{
        name: getattr(work, name).repeat_interleave(rows, 1).contiguous()
        for name in ("cross_k", "cross_v", "cross_k_scale",
                     "cross_v_scale")})


def clone_cache(cache):
    from dataclasses import fields, replace
    return replace(cache, **{f.name: getattr(cache, f.name).clone()
                             for f in fields(cache)
                             if getattr(cache, f.name) is not None})


def fresh_columns(cache, position: int, n: int = 1) -> tuple:
    """The fresh columns a step wrote into ``cache`` at ``position`` (n of
    them with the multi mode's n > 1): (K, V, K scales, V scales), each
    [L, M, H(, Dh)], the layout ``whole_step_plain(fresh=...)`` takes."""
    return tuple(_fresh(getattr(cache, name), position, n)
                 for name in ("self_k", "self_v", "self_k_scale",
                              "self_v_scale"))


def decode_step_errors(params, arch: WhisperArch, x0: torch.Tensor,
                       position: int, cache, heads,
                       multi: bool = False, beams: bool = False,
                       align_bf16: bool = False) -> dict:
    """The decode-step kernel (``whole_step``) against ``whole_step_plain``
    on clones of one cache: {name: (max error, band)} for

      * ``hid_fed`` / ``align_fed``: hid and align against the plain
        step fed the kernel's own fresh columns, values and bf16 scales
        (``fresh=``; all M of them with ``multi``). A column that rounds
        one int8 or bf16 step apart on the two sides (a value near a
        rounding boundary) then reaches no later layer: these hold the
        kernel to its arithmetic at every position;
      * ``columns_fed`` / ``scales_fed``: the kernel's fresh values (int8
        steps) and bf16 scales (bf16 steps) against that fed step's own
        rounding of each layer (``own=``), and ``columns_fed_apart`` /
        ``scales_fed_apart``: how many of them differ at all (a count,
        its band a share of their number, at least STEP_APART_FLOOR);
      * ``hid`` / ``align`` / ``columns``: against the plain step on its
        own columns, at positions > 0 only. At position 0 the fresh column
        is a head's only live slot, so one V value a step apart reaches
        hid whole, moves every later layer's values with it (a later
        column may then part by more than a step), and the fed compare
        takes the place of this one;
      * ``logits``: the serving head (``_lm_head``) on each hid, against
        the fed plain step at position 0 and the unfed one elsewhere.

    ``beams`` runs the beams mode (a cache made with ``shared_cross``),
    ``align_bf16`` the bf16 alignment capture on both sides."""
    from .ops.decode_step import _lm_head, whole_step, whole_step_plain
    kc, pc, fc = clone_cache(cache), clone_cache(cache), clone_cache(cache)
    kw = dict(multi=multi, beams=beams, align_bf16=align_bf16)
    hid, align = whole_step(params, arch, x0, position, kc, heads, **kw)
    rhid, ralign = whole_step_plain(params, arch, x0, position, pc, heads,
                                    **kw)
    n = x0.shape[0] if multi else 1
    fed, own = fresh_columns(kc, position, n), []
    fhid, falign = whole_step_plain(params, arch, x0, position, fc, heads,
                                    fresh=fed, own=own, **kw)
    dec = params["decoder"]
    ref = rhid if position > 0 else fhid
    logits, rlogits = _lm_head(dec, hid), _lm_head(dec, ref)
    cols = max(int((_fresh(getattr(kc, name), position, n).int()
                    - _fresh(getattr(pc, name), position, n).int())
                   .abs().max()) for name in ("self_k", "self_v"))
    # own holds (values, scales) per layer, K then V; mine is laid out as
    # fed: (K, V, K scales, V scales), each [L, M, H(, Dh)]
    mine = [torch.stack([c[j] for c in own[i::2]])
            for j in (0, 1) for i in (0, 1)]
    steps = torch.cat([(fed[i].int() - mine[i].int()).abs().flatten()
                       for i in (0, 1)])
    ulps = torch.cat([(fed[i].view(torch.int16).int()      # scales > 0
                       - mine[i].view(torch.int16).int()).abs().flatten()
                      for i in (2, 3)])
    rel = STEP_REL_BAND
    head_rel = max(rel, torch.finfo(dec["tok_emb"].dtype).eps)
    errs = {
        "hid_fed": ((hid - fhid).abs().max().item(),
                    rel * fhid.abs().max().item()),
        "align_fed": ((align - falign).abs().max().item(), STEP_ALIGN_BAND),
        "columns_fed": (int(steps.max()), STEP_COLUMN_BAND),
        "columns_fed_apart": (int((steps > 0).sum()), max(
            STEP_APART_FLOOR, STEP_COLUMN_APART * steps.numel())),
        "scales_fed": (int(ulps.max()), STEP_SCALE_BAND),
        "scales_fed_apart": (int((ulps > 0).sum()), max(
            STEP_APART_FLOOR, STEP_SCALE_APART * ulps.numel())),
        "logits": ((logits - rlogits).abs().max().item(),
                   head_rel * rlogits.abs().max().item())}
    if position > 0:
        errs["hid"] = ((hid - rhid).abs().max().item(),
                       rel * rhid.abs().max().item())
        errs["align"] = ((align - ralign).abs().max().item(),
                         STEP_ALIGN_BAND)
        errs["columns"] = (cols, STEP_COLUMN_BAND)
    return errs


def decode_step_phases(params, arch: WhisperArch, x0: torch.Tensor,
                       position: int, cache, heads, multi: bool = False,
                       beams: bool = False) -> tuple[float, dict]:
    """One launch of the decode-step kernel on a clone of ``cache`` with
    its phase stamps on: (milliseconds from its start to its last barrier
    on the device's %globaltimer, {phase: share of that time} summed over
    the layers, in ``ops.decode_step.PHASES`` order). Needs the card."""
    from .ops.decode_step import PHASES, whole_step
    stamps = torch.zeros((8 * arch.decoder_layers + 1,), dtype=torch.int64,
                         device=x0.device)
    whole_step(params, arch, x0, position, clone_cache(cache), heads,
               multi=multi, beams=beams, stamps=stamps)
    t = stamps.cpu().double()
    steps = (t[1:] - t[:-1]).reshape(arch.decoder_layers, len(PHASES))
    total = float(t[-1] - t[0])
    return total / 1e6, {name: float(v) / total
                         for name, v in zip(PHASES, steps.sum(0))}


def _first_layers(params, arch: WhisperArch, cache, n: int):
    """``params``, ``arch`` and a clone of ``cache`` cut to the first n
    decoder layers (the kernel then stops after layer n - 1)."""
    from dataclasses import fields, replace
    dec = params["decoder"]
    return ({**params, "decoder": {**dec, "layers": dec["layers"][:n]}},
            replace(arch, decoder_layers=n),
            replace(cache, **{f.name: getattr(cache, f.name)[:n].clone()
                              for f in fields(cache)
                              if getattr(cache, f.name) is not None}))


def _unrounded_kv(lp: dict, arch: WhisperArch, hid: torch.Tensor):
    """Layer ``lp``'s fresh K and V of residual ``hid`` [1, d] before
    rounding, by the plain step's algebra: ([K, V] in int8 steps, x /
    (amax / 127) as ``_quantize`` divides, each [H, Dh]; [K, V] f32 scales
    amax / 127, each [H])."""
    from .ops.decode_step import _gemv, _ln
    d, h, dh = arch.d_model, arch.decoder_attention_heads, arch.head_dim
    qkv = _gemv(_ln(hid.float(), lp["ln1"]), lp["self"]["qkv"])
    values, scales = [], []
    for i in (1, 2):
        x = qkv[0, i * d:(i + 1) * d].reshape(h, dh)
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
        values.append(x / scale)
        scales.append(scale[:, 0])
    return values, scales


def _bf16_margin(x: torch.Tensor) -> torch.Tensor:
    """Distance of f32 ``x`` from its nearest bf16 rounding boundary, in
    bf16 steps (0: on a tie)."""
    low = (x.float().view(torch.int32) & 0xFFFF).double()
    return (low - 0x8000).abs() / 0x10000


def fresh_column_divergence(params, arch: WhisperArch, x0: torch.Tensor,
                            position: int, cache) -> dict:
    """Where the decode-step kernel's fresh ring columns first part from
    ``whole_step_plain``'s, for one row (b1 mode, no alignment heads):

      * ``cells`` / ``scales``: per layer, the K and V values, and the
        bf16 scales, that differ between the two;
      * ``first`` / ``first_v`` / ``first_scale``: the first layer with
        a differing value, with a differing V value, and with a differing
        bf16 scale (None: none);
      * ``at``: for each of those layers, {``hid_in``: how far the
        kernel's residual entering it is from the plain one's, relative
        to the plain one's largest value; ``shift``: how far that moves
        the layer's fresh values, in int8 steps (the plain algebra on
        both residuals); ``flips``: its differing values as (half, head,
        dim, kernel's int8, plain int8, the plain value before rounding
        in int8 steps, that value's distance from the nearest rounding
        boundary, the plain algebra's value on the kernel's residual);
        ``scale_flips``: its differing bf16 scales as (half, head,
        kernel's, plain, the plain f32 scale before rounding, its
        distance from the nearest bf16 rounding boundary in bf16 steps,
        the plain algebra's f32 scale on the kernel's residual)}.

    A value that sits within ``shift`` (or a few f32 ulps) of a boundary
    may round either way on two correct sides, and so may a scale. At
    position 0 a K value or scale so flipped changes nothing (the softmax
    of one score is 1), but a V value, or a V scale (one bf16 step, 2^-8
    to 2^-7 of the head's output), is the only V slot of its head, and so
    reaches hid whole."""
    from .ops.decode_step import whole_step, whole_step_plain
    kc, pc = clone_cache(cache), clone_cache(cache)
    whole_step(params, arch, x0, position, kc, (None,))
    whole_step_plain(params, arch, x0, position, pc, (None,))
    halves = ("self_k", "self_v")
    diff = [_fresh(getattr(kc, n), position, 1)[:, 0]
            != _fresh(getattr(pc, n), position, 1)[:, 0] for n in halves]
    sdiff = [_fresh(getattr(kc, n + "_scale"), position, 1)[:, 0]
             != _fresh(getattr(pc, n + "_scale"), position, 1)[:, 0]
             for n in halves]
    cells = (diff[0].sum((1, 2)) + diff[1].sum((1, 2))).tolist()
    v_cells = diff[1].sum((1, 2)).tolist()
    out = {"cells": cells,
           "scales": (sdiff[0].sum(1) + sdiff[1].sum(1)).tolist(),
           "first": next((i for i, n in enumerate(cells) if n), None),
           "first_v": next((i for i, n in enumerate(v_cells) if n), None),
           "at": {}}
    out["first_scale"] = next((i for i, n in enumerate(out["scales"]) if n),
                              None)
    for li in sorted({out["first"], out["first_v"], out["first_scale"]}
                     - {None}):
        hk = hp = x0.float()
        if li > 0:
            p, a, c = _first_layers(params, arch, cache, li)
            hk, _ = whole_step(p, a, x0, position, c, (None,))
            p, a, c = _first_layers(params, arch, cache, li)
            hp, _ = whole_step_plain(p, a, x0, position, c, (None,))
        lp = params["decoder"]["layers"][li]
        (uk, sk), (up, sp) = (_unrounded_kv(lp, arch, h) for h in (hk, hp))
        flips, scale_flips = [], []
        for i, n in enumerate(halves):
            for head, dim in diff[i][li].nonzero().tolist():
                u = up[i][head, dim].item()
                flips.append((n[-1].upper(), head, dim,
                              int(getattr(kc, n)[li, 0, head, position, dim]),
                              int(getattr(pc, n)[li, 0, head, position, dim]),
                              u, abs(abs(u) % 1.0 - 0.5),
                              uk[i][head, dim].item()))
            ks = getattr(kc, n + "_scale")[li, 0, :, position]
            ps = getattr(pc, n + "_scale")[li, 0, :, position]
            for head in sdiff[i][li].nonzero()[:, 0].tolist():
                scale_flips.append((n[-1].upper(), head, ks[head].item(),
                                    ps[head].item(), sp[i][head].item(),
                                    _bf16_margin(sp[i][head]).item(),
                                    sk[i][head].item()))
        out["at"][li] = {
            "hid_in": ((hk - hp).abs().max() / hp.abs().max()).item(),
            "shift": max((a - b).abs().max().item()
                         for a, b in zip(uk, up)),
            "flips": flips, "scale_flips": scale_flips}
    return out


def beams_rows_mismatch(params, arch: WhisperArch, x0: torch.Tensor,
                        position: int, cache, heads) -> list[str]:
    """The outputs on which the beams mode (``whole_step(beams=True)`` on
    ``cache``, made with ``shared_cross``) differs from the rows mode on
    the same rings with the cross cache repeated per row: hid, align or a
    ring tensor. Empty when the two agree bit for bit, as they must: only
    the cross cache's indexing tells the modes apart."""
    from .ops.decode_step import whole_step
    a, b = clone_cache(cache), repeat_cross(cache, x0.shape[0])
    hb, ab = whole_step(params, arch, x0, position, a, heads, beams=True)
    hr, ar = whole_step(params, arch, x0, position, b, heads)
    names = ("self_k", "self_v", "self_k_scale", "self_v_scale")
    return ([n for n, x, y in (("hid", hb, hr), ("align", ab, ar))
             if not torch.equal(x, y)]
            + [n for n in names
               if not torch.equal(getattr(a, n), getattr(b, n))])


def ring_write_inputs(arch: WhisperArch, rows: int, s: int, ring: int,
                      kind: str, gen: torch.Generator
                      ) -> tuple[list, torch.Tensor]:
    """A verify block's ring writes at ``arch``'s width: (pairs of (ring
    [L, rows, H, ring, *], block [rows, H, s, *]), per-row start slots
    int32 [rows], distinct and in bounds). ``kind`` "bf16" gives bf16 K/V
    rings; "int8" and "int4" (packed) give quantized rings with their bf16
    scale rings, as models/whisper.init_cache lays them out."""
    dev = gen.device
    n, h, dh = (arch.decoder_layers, arch.decoder_attention_heads,
                arch.head_dim)

    def values(shape):
        if kind == "bf16":
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        if kind == "int4":
            shape = shape[:-1] + (shape[-1] // 2,)
            return torch.randint(0, 256, shape, generator=gen, device=dev,
                                 dtype=torch.uint8)
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    pairs = [(values((n, rows, h, ring, dh)), values((rows, h, s, dh)))
             for _ in range(2)]
    if kind != "bf16":
        pairs += [(torch.rand((n, rows, h, ring), generator=gen, device=dev)
                   .to(torch.bfloat16),
                   torch.rand((rows, h, s), generator=gen, device=dev)
                   .to(torch.bfloat16)) for _ in range(2)]
    pos = torch.randint(0, ring - s + 1, (rows,), generator=gen, device=dev,
                        dtype=torch.int32)
    return pairs, pos


def ring_write_library(pairs, li: int, positions: torch.Tensor) -> None:
    """The same writes as one advanced-index assignment (``index_put_``)
    per tensor: the library yardstick of the ring-write kernel."""
    rows = torch.arange(positions.shape[0], device=positions.device)
    for ring, blk in pairs:
        slots = positions.long()[:, None] + torch.arange(
            blk.shape[2], device=positions.device)[None, :]
        ring[li, rows[:, None], :, slots] = blk.transpose(1, 2)


def ring_write_error(pairs, li: int, positions: torch.Tensor) -> int:
    """Bytes that differ between the ring-write kernel and its plain
    version, each run on clones of the rings (0: bit-identical, as they
    must be)."""
    from .ops.ring_write import (write_block_columns_group,
                                 write_block_columns_plain)
    got = [(ring.clone(), blk) for ring, blk in pairs]
    want = [(ring.clone(), blk) for ring, blk in pairs]
    write_block_columns_group(got, li, positions)
    write_block_columns_plain(want, li, positions.cpu())
    return sum(int((g.view(torch.uint8) != w.view(torch.uint8)).sum())
               for (g, _), (w, _) in zip(got, want))


# the device kernels of the wrappers that the plain step calls inside its
# CUDA graph (decoding/greedy.py), by the wrapper's name
STEP_KERNELS = {"decode_gemv_attention": "decode_attention_kernel",
                "ring_write": "ring_write_kernel"}


def device_kernel_counts(prof, kernels: dict[str, str]) -> dict[str, int]:
    """Kernels that ran on the device in a finished ``torch.profiler``
    trace with the CUDA activity, by key of ``kernels`` ({key: a word of
    the kernel's name}). A launch captured in a CUDA graph counts at each
    replay, where a wrapper's ``launches`` counts the one call that
    recorded it."""
    counts = dict.fromkeys(kernels, 0)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            continue
        name = ev.name()
        for key, word in kernels.items():
            if word in name:
                counts[key] += 1
                break
    return counts


# ---------------------------------------------------------------------------
# The TINY slice on two devices
# ---------------------------------------------------------------------------


def tiny_slice(ckpt: str, params, device: str, audio: np.ndarray,
               quantize: bool | str = False, assistant: str | None = None,
               num_beams: int = 1, prompt: str | None = None
               ) -> tuple[dict, list[np.ndarray]]:
    """The TINY f32 slice on ``device``: the pipeline's result for
    ``audio`` (word timestamps, adjust_pauses 0.12), and each 5 s chunk's
    tokens. ``quantize="serving"`` also turns on the whole-step decode
    kernel (``b1_decode_kernel``) with 24 new tokens per window, on
    ``params`` with random decoder biases and LayerNorms
    (``random_affine``, seed 1). ``assistant`` is load_pipeline's;
    ``num_beams`` > 1 decodes with beam search; ``prompt`` is the
    pipeline's text prompt, with condition_on_prev_tokens on."""
    from dataclasses import replace
    from .config import PipelineOptions
    from .hub import load_pipeline
    from .pipeline.asr import chunk_iter
    po = PipelineOptions(chunk_length_s=CHUNK_S, batch_size=16,
                         return_timestamps="word")
    if quantize == "serving":
        params = random_affine(params, 1)
    pipe = load_pipeline(ckpt, dtype=torch.float32, device=device,
                         params=to_device(params, device), pipe_opts=po,
                         quantize=quantize, assistant=assistant)
    if quantize == "serving":
        pipe.gen_opts = replace(pipe.gen_opts, b1_decode_kernel=True,
                                max_new_tokens=24)
    pipe.gen_opts = replace(pipe.gen_opts, num_beams=num_beams,
                            condition_on_prev_tokens=prompt is not None)
    res = pipe({"raw": audio, "sampling_rate": SR}, return_timestamps="word",
               adjust_pauses_threshold=0.12, prompt=prompt)
    stride = round(CHUNK_S / 6 * SR)
    chunks = list(chunk_iter(audio, 0, CHUNK_S * SR, stride, stride))
    toks = [o["tokens"] for o in pipe._run_chunks(chunks, CHUNK_S * SR,
                                                   "word", prompt=prompt)]
    return res, toks


def token_agreement(ref: list, got: list) -> float:
    """Token agreement of two runs' chunk tokens over the shorter of the
    two streams (the reference's measure, tests/test_b1_kernel.py:94)."""
    r = np.concatenate([np.asarray(t).reshape(-1) for t in ref])
    g = np.concatenate([np.asarray(t).reshape(-1) for t in got])
    n = min(len(r), len(g))
    return float((r[:n] == g[:n]).mean()) if n else 0.0


def slice_timestamp_gap(ref: tuple[dict, list[np.ndarray]],
                        got: tuple[dict, list[np.ndarray]]) -> float:
    """Largest word-timestamp gap between two ``tiny_slice`` runs. Raises
    AssertionError when their tokens, text or words differ."""
    (r, r_toks), (g, g_toks) = ref, got
    if len(r_toks) != len(g_toks) or not all(
            np.array_equal(a, b) for a, b in zip(r_toks, g_toks)):
        raise AssertionError("slice tokens differ")
    if g["text"] != r["text"]:
        raise AssertionError(f"slice text differs: {g['text']!r} vs "
                             f"{r['text']!r}")
    if [c["text"] for c in g["chunks"]] != [c["text"] for c in r["chunks"]]:
        raise AssertionError("slice words differ")
    return max((abs(x - y) for a, b in zip(r["chunks"], g["chunks"])
                for x, y in zip(a["timestamp"], b["timestamp"])),
               default=0.0)


def result_gap(ref: dict, got: dict) -> float:
    """Largest word-timestamp gap between two pipeline results. Raises
    AssertionError when their text or words differ, or when ``ref`` has
    no words."""
    if got["text"] != ref["text"]:
        raise AssertionError(f"text differs: {got['text']!r} vs "
                             f"{ref['text']!r}")
    if [c["text"] for c in got["chunks"]] != [c["text"]
                                              for c in ref["chunks"]]:
        raise AssertionError("words differ")
    if not ref["chunks"]:
        raise AssertionError("no words")
    return max(abs(x - y) for a, b in zip(ref["chunks"], got["chunks"])
               for x, y in zip(a["timestamp"], b["timestamp"]))


def serving_slice(ckpt: str, params, device: str, audio: np.ndarray
                  ) -> dict:
    """The TINY f32 serving slice on ``device`` at batch size 4 and one
    temperature. "pipe" and "pipe_adjusted": the pipeline's own results
    for ``audio`` (adjust_pauses 0.12 in the second); "requests": a 7 s
    prefix of ``audio``, then ``audio`` three times, submitted together
    to a StreamingBatcher with on_partial (the prefix's windows do not
    fill a batch, so each later stream straddles two batches and gets a
    partial), "refs" the pipeline's results for them, "streams" the
    batcher's and "stream_partials" their partials, "batcher_launches"
    the encoder-attention launches made while the worker thread ran
    them; "live": a LiveSession fed ``audio`` in ragged blocks (seeded)
    with adjust_pauses 0.12, "live_partials" its partials."""
    from dataclasses import replace
    from .config import PipelineOptions
    from .hub import load_pipeline
    from .ops.fused_attention import fused_attention
    from .serving import LiveSession, StreamingBatcher
    po = PipelineOptions(chunk_length_s=CHUNK_S, batch_size=4,
                         return_timestamps="word")
    pipe = load_pipeline(ckpt, dtype=torch.float32, device=device,
                         params=to_device(params, device), pipe_opts=po)
    pipe.gen_opts = replace(pipe.gen_opts, temperatures=(0.0,))
    clips = [audio[:7 * SR]] + [audio] * 3

    def request(x):
        return {"raw": x, "sampling_rate": SR}
    out = {"pipe": pipe(request(audio), return_timestamps="word"),
           "pipe_adjusted": pipe(request(audio), return_timestamps="word",
                                 adjust_pauses_threshold=0.12)}
    out["refs"] = [pipe(request(clips[0]), return_timestamps="word")] + [
        out["pipe"]] * 3
    partials = [[] for _ in clips]
    before = fused_attention.launches
    batcher = StreamingBatcher(pipe, max_batch_delay_s=0.01)
    try:
        handles = [batcher.submit(request(x), on_partial=p.append)
                   for x, p in zip(clips, partials)]
        out["streams"] = [h.result(timeout=600) for h in handles]
        out["batcher_launches"] = fused_attention.launches - before
    finally:
        batcher.shutdown()
    out["stream_partials"] = partials
    live = []
    sess = LiveSession(pipe, adjust_pauses_threshold=0.12,
                       on_partial=live.append)
    rng = np.random.default_rng(5)
    i = 0
    while i < len(audio):
        n = int(rng.integers(1000, 40000))
        sess.feed(audio[i:i + n])
        i += n
    out["live"] = sess.finish()
    out["live_partials"] = live
    return out


def prefix_stable(partials: list[dict], final: dict) -> None:
    """Partials in order, each one's words but the open last one a prefix
    of ``final``'s; raises AssertionError."""
    ns = [p["n_chunks_done"] for p in partials]
    if ns != sorted(ns) or not all(p["is_partial"] for p in partials):
        raise AssertionError(f"partials out of order: {ns}")
    words = [(c["text"], c["timestamp"]) for c in final["chunks"]]
    for p in partials:
        got = [(c["text"], c["timestamp"]) for c in p["chunks"]][:-1]
        if got != words[:len(got)]:
            raise AssertionError(f"partial {p['n_chunks_done']} is not a "
                                 "prefix of the final words")


def serving_gap(out: dict) -> float:
    """Checks of one ``serving_slice``: each stream's result against the
    pipeline's for the same audio (text and words equal), ``finish()``
    equal to the pause-adjusted pipeline result exactly, partials (some
    from the batcher, some from the session) ordered and prefix-stable
    except the open last word. Returns the largest word gap of the
    streams against the pipeline; raises AssertionError."""
    if out["live"] != out["pipe_adjusted"]:
        raise AssertionError("LiveSession.finish() differs from "
                             "pipe(whole, adjust_pauses_threshold=0.12)")
    if not out["live_partials"] or not any(out["stream_partials"]):
        raise AssertionError("no live partials")
    prefix_stable(out["live_partials"], out["pipe"])
    gap = 0.0
    for ref, res, partials in zip(out["refs"], out["streams"],
                                  out["stream_partials"]):
        gap = max(gap, result_gap(ref, res))
        prefix_stable(partials, res)
    return gap


# ---------------------------------------------------------------------------
# Worlds of ranks (parallel/): the spawner the tests and chip_smoke.py share
# ---------------------------------------------------------------------------

RANK_RESULT = "cw-rank-result "      # the line a rank prints its result on
COLLECTIVE_TIMEOUT_S = 60.0          # a collective that waits longer fails
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, target: str, kwargs: dict | None = None, *,
              backend: str = "gloo", device: str = "cpu",
              timeout: float = 300.0, env: dict | None = None
              ) -> list[dict]:
    """Spawn ``world`` ranks of one process group on a free localhost
    port; each runs ``target`` ("module:function", imported from the
    repo's root) with ``kwargs`` and returns a JSON-able dict. Returns the
    ranks' dicts by rank. ``device`` "cuda" puts rank r on card r modulo
    the card count (two ranks share one card under gloo). Every child is
    killed once ``timeout`` seconds have passed, and its collectives fail
    after COLLECTIVE_TIMEOUT_S; a rank that fails or is killed raises
    RuntimeError with the end of its output."""
    import subprocess
    import sys
    import tempfile
    import time
    spec = json.dumps({"world": world, "port": free_port(),
                       "target": target, "kwargs": kwargs or {},
                       "backend": backend, "device": device})
    child_env = {**os.environ, **(env or {}), "CW_RANK_SPEC": spec,
                 "PYTHONPATH": os.pathsep.join(
                     [_REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                if p])}
    if device == "cpu":
        child_env["OMP_NUM_THREADS"] = "1"
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    code = ("import sys; from crisperwhisper_tpu_torch.testing import "
            "rank_main; sys.exit(rank_main())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=log, stderr=subprocess.STDOUT,
                              cwd=_REPO, env=child_env)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith(RANK_RESULT)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(
                f"rank {r} of {world} ({target}) exited {p.returncode}"
                f"{' at the time limit' if p.returncode == -9 else ''}:\n"
                + out[-6000:])
        results.append(json.loads(lines[-1][len(RANK_RESULT):]))
    return results


def rank_main() -> int:
    """A child of ``run_world``: join the process group, run the target,
    print its result on a RANK_RESULT line."""
    import importlib
    import sys
    import torch.distributed as dist
    from .parallel import init_multihost
    rank = int(sys.argv[1])
    spec = json.loads(os.environ["CW_RANK_SPEC"])
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
        ids = None
    else:
        ids = [rank % torch.cuda.device_count()]
    init_multihost(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                   local_device_ids=ids, backend=spec["backend"],
                   timeout=COLLECTIVE_TIMEOUT_S)
    module, name = spec["target"].split(":")
    try:
        result = getattr(importlib.import_module(module), name)(
            **spec["kwargs"])
    finally:
        dist.destroy_process_group()
    print(RANK_RESULT + json.dumps(result), flush=True)
    return 0


def gather_rows(x: np.ndarray, mesh) -> np.ndarray:
    """Every data rank's rows of a host array, in data-rank order."""
    import torch.distributed as dist
    from .parallel.mesh import DATA, axis_shard
    axis = axis_shard(mesh, DATA)
    parts: list = [None] * axis.size
    dist.all_gather_object(parts, np.asarray(x), group=axis.group)
    return np.concatenate(parts)


def rows_of(x, mesh):
    """This rank's rows of a batch split over the mesh's data axis."""
    from .parallel.mesh import DATA, axis_shard
    axis = axis_shard(mesh, DATA)
    k = x.shape[0] // axis.size
    return x[axis.index * k:(axis.index + 1) * k]


def param_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


def unflatten(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return out


def mesh_greedy(params, arch: WhisperArch, mel: np.ndarray, mesh,
                max_new: int, cross_dtype: str | None = None) -> dict:
    """Encode this data rank's rows of ``mel`` and decode ``max_new``
    greedy tokens from <|startoftranscript|> (the JAX package's
    tests/test_parallel.py decode); the whole batch's sequences and
    log-probability sums, gathered over the data axis."""
    from .config import GenerationOptions
    from .decoding.greedy import greedy_decode
    from .models.whisper import encode
    from .parallel.mesh import mesh_device
    dev = mesh_device(mesh) if mesh is not None else torch.device("cpu")
    rows = rows_of(mel, mesh) if mesh is not None else mel
    enc = encode(params, arch, torch.from_numpy(rows).to(dev))
    prompt = torch.full((rows.shape[0], 1), TINY_SPECIALS.sot)
    res = greedy_decode(params, arch, TINY_SPECIALS,
                        GenerationOptions(max_initial_timestamp_index=50),
                        enc, prompt, max_new_tokens=max_new,
                        cross_cache_dtype=cross_dtype)
    seqs, slp = res.sequences.cpu().numpy(), res.sum_logprobs.cpu().numpy()
    if mesh is not None:
        seqs, slp = gather_rows(seqs, mesh), gather_rows(slp, mesh)
    return {"sequences": seqs.tolist(), "sum_logprobs": slp.tolist()}


def tiny_mesh_options():
    """The TINY pipeline options of the JAX package's mesh tests
    (tests/test_parallel.py:75-83): three alignment heads, one
    temperature, 16 new tokens, batch size 2, word timestamps."""
    from .config import GenerationOptions, PipelineOptions
    return (GenerationOptions(
        alignment_heads=((0, 1), (1, 3), (0, 2)), median_filter_width=7,
        max_initial_timestamp_index=50, compression_ratio_threshold=None,
        logprob_threshold=None, no_speech_threshold=None,
        temperatures=(0.0,), max_new_tokens=16),
        PipelineOptions(chunk_length_s=CHUNK_S, batch_size=2,
                        return_timestamps="word"))


def call_with_tokens(pipe, request) -> tuple[dict, list[list[int]]]:
    """``pipe(request)`` with word timestamps, and the tokens of each of
    its chunks as ``_run_chunks`` returned them."""
    tokens: list[list[int]] = []
    inner = pipe._run_chunks

    def spy(*a, **kw):
        out = inner(*a, **kw)
        tokens.extend(o["tokens"][0].tolist() for o in out)
        return out

    pipe._run_chunks = spy
    try:
        return pipe(request, return_timestamps="word"), tokens
    finally:
        del pipe._run_chunks


def serve_on_mesh(pipe, request, streams: int = 3, timed: bool = False
                  ) -> dict:
    """On rank 0: ``call_with_tokens(pipe, request)``; with ``timed`` the
    request again on the host clock (its wall seconds, after a synchronize
    on the card); then ``streams`` copies of it through a
    StreamingBatcher; then close the followers. On the other ranks: follow
    rank 0 until it closes. Rank 0 returns {"direct": [result], "tokens":
    [[ids] per chunk], "wall": s or None, "streams": [results]}; the
    others {}."""
    import time
    import torch.distributed as dist
    from .serving import StreamingBatcher
    if dist.get_rank() != 0:
        pipe.follow()
        return {}
    wall, served = None, []
    try:
        direct, tokens = call_with_tokens(pipe, request)
        if timed:
            t0 = time.perf_counter()
            pipe(request, return_timestamps="word")
            if pipe.device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if streams:
            batcher = StreamingBatcher(pipe)
            try:
                handles = [batcher.submit(request) for _ in range(streams)]
                served = [h.result(timeout=600) for h in handles]
            finally:
                batcher.shutdown()
    finally:
        pipe.close()
    return {"direct": [direct], "tokens": tokens, "wall": wall,
            "streams": served}


def launch_counts() -> dict[str, int]:
    """Launches of the main path's kernels in this process: encoder
    attention (also by route), alignment prep, DTW and the ring write."""
    from .ops import align_prep, dtw, fused_attention, ring_write
    fa = fused_attention.fused_attention
    return {"encoder_attention": fa.launches,
            **{f"encoder_attention_{k}": v
               for k, v in fa.route_launches.items()},
            "align_prep": align_prep.align_prep.launches,
            "dtw": dtw.dtw.launches,
            "ring_write": ring_write.write_block_columns_group.launches}


def _slice_pipeline(ckpt: str, params, max_new: int | None,
                    language: str | None, mesh=None, assistant=None):
    """The pipeline ``mesh_slice`` and ``unsharded_slice`` serve: batch
    size 8, word timestamps, one temperature, on ``params`` (the whole
    tree; on a mesh each rank cuts its slices), with ``assistant``."""
    from dataclasses import replace
    from .config import PipelineOptions
    from .hub import load_pipeline
    chunk = 30 if params["encoder"]["pos"].shape[0] == 1500 else CHUNK_S
    dtype = params["decoder"]["tok_emb"].dtype
    pipe = load_pipeline(ckpt, params=params, mesh=mesh, dtype=dtype,
                         device=(None if mesh is not None
                                 else params["decoder"]["tok_emb"].device),
                         language=language, assistant=assistant,
                         pipe_opts=PipelineOptions(chunk_length_s=chunk,
                                                   batch_size=8,
                                                   return_timestamps="word"))
    pipe.gen_opts = replace(pipe.gen_opts, temperatures=(0.0,))
    if max_new is not None:
        pipe.gen_opts = replace(pipe.gen_opts, max_new_tokens=max_new,
                                force_unique_generate_call=True)
    return pipe


def slice_params(ckpt: str, dtype: str, device: str = "cuda"):
    """``init_params`` of the checkpoint's architecture from seed 0 on
    ``device``, in ``dtype`` ("float32", "bfloat16"): the same tree in
    every process."""
    from .config import load_checkpoint_configs
    from .models.whisper import init_params
    arch = WhisperArch.from_hf_config(load_checkpoint_configs(ckpt)["config"])
    return init_params(arch, torch.Generator(device=device).manual_seed(0),
                       device, getattr(torch, dtype))


def unsharded_slice(ckpt: str, seconds: float, dtype: str,
                    max_new: int | None = None,
                    language: str | None = None,
                    device: str = "cuda") -> dict:
    """``mesh_slice``'s request on one device, off any mesh: {"direct":
    [result], "tokens": [[ids] per chunk]}. TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = _slice_pipeline(ckpt, slice_params(ckpt, dtype, device), max_new,
                           language)
    res, tokens = call_with_tokens(
        pipe, {"raw": tone_audio(seconds, 2), "sampling_rate": SR})
    return {"direct": [res], "tokens": tokens}


def _reset_launches() -> None:
    """Set every counter ``launch_counts`` reads to 0."""
    from .ops import align_prep, dtw, fused_attention, ring_write
    for w in (fused_attention.fused_attention, align_prep.align_prep,
              dtw.dtw, ring_write.write_block_columns_group):
        w.launches = 0
    fused_attention.fused_attention.route_launches = dict.fromkeys(
        fused_attention.ROUTES, 0)


def mesh_slice(ckpt: str, seconds: float, dtypes: list[str],
               streams: int = 3, max_new: int | None = None,
               language: str | None = None, device: str = "cuda",
               assistants: list[str] = ()) -> dict:
    """One rank of the model-parallel pipeline on ``device`` (the card,
    or "cpu" for a rehearsal on gloo CPU ranks): the mesh is
    1 x world over the process group. For each dtype: ``slice_params``
    (the same weights on every rank), cut to this rank's slices by
    load_pipeline(mesh=), serving ``tone_audio(seconds, 2)`` through
    ``serve_on_mesh`` (the batcher on the last dtype, the timed repeat
    on the others), then the last dtype's pipeline with each of
    ``assistants`` (no batcher). TF32 is off.
    Returns per dtype this rank's share of the replicated parameter bytes,
    the head counts the encoder attention saw, the kernel launches, and
    on rank 0 serve_on_mesh's results; per assistant the launches and on
    rank 0 the results. ``max_new`` bounds each window to one seek pass of
    that many new tokens."""
    import torch.distributed as dist
    from .models import whisper
    from .parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, dist.get_world_size(), device=device)
    req = {"raw": tone_audio(seconds, 2), "sampling_rate": SR}
    heads: list[int] = []
    inner = whisper.fused_attention

    def seen(q, k, v):
        heads.append(int(q.shape[1]))
        return inner(q, k, v)

    out = {"rank": dist.get_rank(), "runs": {}, "assistants": {}}
    whisper.fused_attention = seen
    try:
        for i, name in enumerate(dtypes):
            whole = slice_params(ckpt, name, device)
            replicated_bytes = param_bytes(whole)
            pipe = _slice_pipeline(ckpt, whole, max_new, language, mesh)
            del whole
            _reset_launches()
            heads.clear()
            last = i == len(dtypes) - 1
            run = serve_on_mesh(pipe, req, streams if last else 0,
                                timed=not last)
            out["runs"][name] = {
                "param_share": param_bytes(pipe.params) / replicated_bytes,
                "heads": sorted(set(heads)), "launches": launch_counts(),
                **run}
            del pipe
            if device == "cuda":
                torch.cuda.empty_cache()
        for mode in assistants:
            pipe = _slice_pipeline(ckpt, slice_params(ckpt, dtypes[-1],
                                                      device),
                                   max_new, language, mesh, assistant=mode)
            _reset_launches()
            run = serve_on_mesh(pipe, req, 0)
            out["assistants"][mode] = {"launches": launch_counts(), **run}
            del pipe
    finally:
        whisper.fused_attention = inner
    return out


def _raises(fn, match: str) -> bool:
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def parallel_scenarios(ckpt: str, inputs: str, out: str, model: int
                       ) -> dict:
    """Every CPU scenario of tests/test_torch_parallel.py on one rank of a
    gloo world of CPU ranks, on a (world / model) x model mesh, at TINY
    f32. ``inputs``: an .npz with "mel" [4, 80, 500], "audio" and the JAX
    package's init_params tree ("jax/<path>" keys). Writes this rank's
    sharded and unsharded encoder states to ``out``/enc_<rank>.npz."""
    from dataclasses import replace
    import torch.distributed as dist
    from .hub import load_pipeline
    from .models.loader import params_from_jax
    from .models.quantize import fuse_decoder_qkv, quantize_decoder_weights
    from .models.whisper import encode, init_cache
    from .ops import decode_step as step_kernel
    from .decoding.longform import _check_agreement, generate
    from .parallel import (data_sharding, host_local_array, make_mesh,
                           make_serving_mesh, process_local_batch,
                           shard_params)
    from .pipeline.asr import ASRPipeline
    rank, world = dist.get_rank(), dist.get_world_size()
    data = world // model
    arch = WhisperArch(**TINY)
    npz = np.load(inputs)
    mel = npz["mel"]
    tree = unflatten({k[4:]: npz[k] for k in npz.files
                      if k.startswith("jax/")})
    params = params_from_jax(tree, arch)
    mesh = make_mesh(data, model, device="cpu")
    r: dict = {"rank": rank, "world": world}

    # the partitioning audit of dryrun_multichip, and the tensor-parallel
    # encoder against the unsharded one on this rank's rows
    sharded = shard_params(params, mesh)
    r["param_share"] = param_bytes(sharded) / param_bytes(params)
    mine = torch.from_numpy(rows_of(mel, mesh))
    enc_tp, enc_one = encode(sharded, arch, mine), encode(params, arch, mine)
    np.savez(os.path.join(out, f"enc_{rank}.npz"), tp=enc_tp.numpy(),
             one=enc_one.numpy(), rows=rows_of(np.arange(len(mel)), mesh))

    # greedy decode, plain and int8 (unfused) weights with an int8 cross
    # cache, on the mesh and on this rank alone
    r["greedy"] = mesh_greedy(sharded, arch, mel, mesh, 8)
    r["greedy_one"] = mesh_greedy(params, arch, mel, None, 8)
    q8 = quantize_decoder_weights(params)
    r["int8"] = mesh_greedy(shard_params(q8, mesh), arch, mel, mesh, 8,
                            "int8")
    r["int8_one"] = mesh_greedy(q8, arch, mel, None, 8, "int8")

    # kernel 5's gate: the fused serving tree on one rank passes its
    # weight test, a mesh's serving tree (unfused) and a fused tree sharded
    # over the mesh do not
    serving = load_pipeline(ckpt, dtype=torch.float32, mesh=mesh,
                            quantize="serving")
    one = quantize_decoder_weights(fuse_decoder_qkv(params, arch.head_dim))
    cache = init_cache(params, arch, encode(params, arch, mine[:1]),
                       cache_len=8, cross_dtype="int4", self_dtype="int8")
    r["gate"] = {
        "one_rank_fused": step_kernel._quantized(one, cache),
        "mesh_serving": step_kernel._quantized(serving.params, cache),
        "mesh_fused": step_kernel._quantized(shard_params(one, mesh), cache)}
    del serving

    # the mesh and multihost helpers' errors and results
    r["needs"] = _raises(lambda: make_mesh(world, 2, device="cpu"),
                         f"needs {2 * world} devices")
    r["device_mismatch"] = _raises(
        lambda: load_pipeline(ckpt, device="cuda:1", mesh=mesh), "device=")
    r["divide"] = _raises(lambda: make_serving_mesh(model=3, device="cpu"),
                          "must divide")
    r["data_axis"] = _raises(
        lambda: make_serving_mesh(model=2, data=data + 1, device="cpu"),
        "data axis")
    r["multiple"] = _raises(lambda: ASRPipeline(
        params, arch, None, specials=TINY_SPECIALS,
        pipe_opts=replace(tiny_mesh_options()[1], batch_size=2 * data + 1),
        mesh=mesh), "multiple") if data > 1 else None
    smesh = make_serving_mesh(model=2, device="cpu")
    r["serving_mesh"] = {"shape": list(smesh.shape),
                         "names": list(smesh.mesh_dim_names),
                         "model_group": dist.get_process_group_ranks(
                             smesh.get_group("model"))}
    r["local_batch"] = process_local_batch(8, smesh)
    local = np.full((process_local_batch(2 * data, smesh), 8), rank + 1,
                    np.float32)
    arr = host_local_array(local, smesh)
    total = arr.to_local().sum()
    dist.all_reduce(total)
    r["host_local"] = {"shape": list(arr.shape), "sum": float(total)}
    r["serving_mesh_greedy"] = mesh_greedy(
        shard_params(params, smesh), arch, mel, smesh, 6)

    # the user-facing pipeline on the mesh: rank 0 makes the calls
    gen, po = tiny_mesh_options()
    pipe = load_pipeline(ckpt, dtype=torch.float32, mesh=mesh,
                         gen_opts=gen, pipe_opts=po)
    request = {"raw": npz["audio"], "sampling_rate": SR}
    got = serve_on_mesh(pipe, request)
    # speculative decoding on the mesh: prompt lookup (per-row ring writes
    # into local-head rings) and a self-draft of the sharded tree's first
    # layer
    for mode in ("prompt_lookup", "self:1"):
        spec = serve_on_mesh(load_pipeline(
            ckpt, dtype=torch.float32, mesh=mesh, gen_opts=gen,
            pipe_opts=po, assistant=mode), request, streams=0)
        if rank == 0:
            r[f"assistant_{mode}"] = spec["direct"][0]
    # temperature fallback on the mesh: every window fails the log-prob
    # gate until the last temperature, so the sampled windows decode. Each
    # rank is handed a generator of its own seed; the mesh must draw what
    # one process with rank 0's generator draws
    fb = replace(gen, temperatures=(0.0, 0.5, 1.0), logprob_threshold=0.0)

    def sampled(tree, seed, sharding):
        out = generate(tree, arch, TINY_SPECIALS, fb, torch.from_numpy(mel),
                       generator=torch.Generator().manual_seed(seed),
                       batch_sharding=sharding)
        return {"sequences": out.sequences.tolist(),
                "token_timestamps": out.token_timestamps.tolist()}

    r["fallback"] = {"mesh": sampled(sharded, 11 + rank, data_sharding(mesh)),
                     "one": sampled(params, 11, None),
                     "other_seed": sampled(params, 12, None)}
    # the agreement check after each window: silent on equal tokens, a
    # RuntimeError on every rank when one rank's differ
    same = (np.zeros((2, 3), np.int64), np.full((2,), 3))
    _check_agreement(same, torch.device("cpu"))
    try:
        _check_agreement((same[0] + (rank == world - 1), same[1]),
                         torch.device("cpu"))
        r["divergence_raises"] = False
    except RuntimeError as e:
        r["divergence_raises"] = "different tokens" in str(e)
    fb_pipe = serve_on_mesh(load_pipeline(
        ckpt, dtype=torch.float32, mesh=mesh, gen_opts=fb, pipe_opts=po),
        request, streams=0)
    if rank == 0:
        ref = load_pipeline(ckpt, dtype=torch.float32, device="cpu",
                            gen_opts=gen, pipe_opts=po)
        r["pipeline"] = got
        r["pipeline_one"] = ref(request, return_timestamps="word")
        ref.gen_opts = fb
        r["fallback"]["pipeline"] = fb_pipe["direct"][0]
        r["fallback"]["pipeline_one"] = ref(request, return_timestamps="word")
    return r
