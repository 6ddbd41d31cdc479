"""ctypes bindings for the native C++ helpers (native/cwtpu.cpp).

Builds libcwtpu.so on first use (g++ -O2 -shared); every consumer has a
pure-Python fallback, so a missing compiler degrades gracefully.

Components (SURVEY.md §2.7 native plan):
  * fast BPE decode        — replaces the reference's Rust `tokenizers`
  * WAV/PCM reader         — replaces the ffmpeg subprocess for WAV input
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_build")
_SO_PATH = os.path.join(_NATIVE_DIR, "libcwtpu.so")
_SRC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                         "cwtpu.cpp")


def _build() -> bool:
    try:
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", _SO_PATH, _SRC_PATH],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        if not os.path.exists(_SO_PATH) or (
                os.path.exists(_SRC_PATH)
                and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_SO_PATH)):
            if not os.path.exists(_SRC_PATH) or not _build():
                _LIB_FAILED = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _LIB_FAILED = True
            return None
        lib.cw_vocab_load.restype = ctypes.c_void_p
        lib.cw_vocab_load.argtypes = [ctypes.c_char_p]
        lib.cw_vocab_free.argtypes = [ctypes.c_void_p]
        lib.cw_decode.restype = ctypes.c_int64
        lib.cw_decode.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
        lib.cw_encoder_load.restype = ctypes.c_void_p
        lib.cw_encoder_load.argtypes = [ctypes.c_char_p]
        lib.cw_encoder_free.argtypes = [ctypes.c_void_p]
        lib.cw_encode.restype = ctypes.c_int64
        lib.cw_encode.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
        lib.cw_wav_decode.restype = ctypes.c_int64
        lib.cw_wav_decode.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
        lib.cw_wav_info.restype = ctypes.c_int
        lib.cw_wav_info.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int32)] * 4 \
            + [ctypes.POINTER(ctypes.c_int64)] * 2
        _LIB = lib
        return _LIB


def _token_bytes(bpe, tok: str) -> bytes:
    """Resolve a vocab token's raw bytes through the byte-level map.
    A character outside the 256 byte-level units means the vocab is not
    pure byte-level BPE — mapping it to an arbitrary byte would silently
    COLLAPSE distinct tokens to identical byte strings (wrong ids with
    no error); raise instead, which makes the native codec unavailable
    and keeps the pure-Python path (whose KeyError matches HF's slow
    tokenizer) authoritative."""
    try:
        return bytes(bpe.byte_decoder[c] for c in tok)
    except KeyError as e:
        raise ValueError(
            f"vocab token {tok!r} is not byte-level (char {e}) — "
            f"native codec disabled") from e


class NativeBPEDecoder:
    """id-sequence -> utf-8 text through the C++ codec.

    The vocab blob resolves the GPT-2 byte-level indirection ahead of time
    (id -> raw bytes), written once per tokenizer as 'vocab.cwvb'.
    """

    def __init__(self, bpe, cache_path: str | None = None):
        self.lib = get_lib()
        self.handle = None
        if self.lib is None:
            return
        blob = self._build_blob(bpe)
        import hashlib
        digest = hashlib.sha256(blob).hexdigest()
        if cache_path is None:
            cache_dir = os.path.join(
                os.path.expanduser("~"), ".cache", "crisperwhisper_tpu")
            os.makedirs(cache_dir, mode=0o700, exist_ok=True)
            cache_path = os.path.join(cache_dir, f"vocab_{digest[:32]}.cwvb")
        # Validate any pre-existing file byte-for-byte against the vocab we
        # were handed — the cache is keyed by content, never trusted blindly
        # (stale/colliding/planted files are simply rewritten).
        valid = False
        if os.path.exists(cache_path):
            try:
                with open(cache_path, "rb") as f:
                    valid = hashlib.sha256(f.read()).hexdigest() == digest
            except OSError:
                valid = False
        if not valid:
            tmp = cache_path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, cache_path)
        self.handle = self.lib.cw_vocab_load(cache_path.encode())

    @staticmethod
    def _build_blob(bpe) -> bytes:
        n = max(bpe.decoder.keys()) + 1 if bpe.decoder else 0
        chunks: list[bytes] = []
        offsets = np.zeros(n + 1, np.uint32)
        total = 0
        for i in range(n):
            tok = bpe.decoder.get(i, "")
            raw = _token_bytes(bpe, tok)
            chunks.append(raw)
            total += len(raw)
            offsets[i + 1] = total
        return (b"CWVB" + np.uint32(n).tobytes() + offsets.tobytes()
                + b"".join(chunks))

    @property
    def available(self) -> bool:
        return self.handle is not None

    def decode(self, ids) -> str:
        ids = np.ascontiguousarray(np.asarray(ids, np.int32))
        cap = max(len(ids) * 16, 64)
        for _ in range(4):       # grow until it fits; never return short
            out = np.empty(cap, np.uint8)
            written = self.lib.cw_decode(self.handle, ids, len(ids), out,
                                         cap)
            if written >= 0:
                return out[:written].tobytes().decode(
                    "utf-8", errors="replace")
            cap *= 8
        raise RuntimeError(
            "native BPE decode failed (output exceeds retry capacity)")

    def __del__(self):
        if self.lib is not None and self.handle:
            try:
                self.lib.cw_vocab_free(self.handle)
            except Exception:
                pass


def _unicode_class_ranges() -> np.ndarray:
    """[first, last, cls] rows classifying every codepoint the way
    tokenizer/bpe.py::gpt2_pre_tokenize does (3 space via bpe._is_ws —
    str.isspace MINUS U+001C-001F, matching the regex \\s White_Space
    semantics; 1 \\p{L}, 2 \\p{N} via unicodedata category; 0 rows
    omitted — the C++ side defaults unknown codepoints to class 0).
    Exported from the running Python so native pre-tokenization matches
    the oracle by construction."""
    import unicodedata
    from .tokenizer.bpe import _is_ws
    cat = unicodedata.category
    rows: list[tuple[int, int, int]] = []
    start = 0
    prev = 0
    for cp in range(0x110000):
        ch = chr(cp)
        if _is_ws(ch):
            cls = 3
        else:
            k = cat(ch)[0]
            cls = 1 if k == "L" else 2 if k == "N" else 0
        if cls != prev:
            if prev:
                rows.append((start, cp - 1, prev))
            start = cp
            prev = cls
    if prev:
        rows.append((start, 0x10FFFF, prev))
    return np.asarray(rows, np.uint32)


@functools.lru_cache(maxsize=1)
def _unicode_ranges_blob() -> bytes:
    rows = _unicode_class_ranges()
    out = [np.uint32(len(rows)).tobytes()]
    for first, last, cls in rows:
        out.append(np.uint32(first).tobytes())
        out.append(np.uint32(last).tobytes())
        out.append(bytes([int(cls)]))
    return b"".join(out)


class NativeBPEEncoder:
    """utf-8 text -> vocab ids through the C++ codec (pre-tokenize + BPE
    merges), closing the encode half of the fast-tokenizer replacement
    (SURVEY.md §2.7; hf models/whisper/tokenization_whisper_fast.py is the
    Rust-backed original). Blob "CWEB1" — see native/cwtpu.cpp."""

    def __init__(self, bpe, cache_path: str | None = None):
        self.lib = get_lib()
        self.handle = None
        if self.lib is None:
            return
        # Cache keyed by a CHEAP identity digest (vocab + merges +
        # unicodedata version) so a warm start skips blob CONSTRUCTION
        # entirely — the expensive part is the 1.1M-codepoint class
        # sweep, not the file write. A sidecar records the full-file
        # sha256 at write time; reuse requires BOTH the key match
        # (identity) and the sidecar hash match (integrity). The cache
        # dir is 0700 user-owned, same trust as the decode blob.
        import hashlib
        import unicodedata
        key = hashlib.sha256(
            repr(sorted(bpe.encoder.items())).encode()
            + repr(sorted(bpe.bpe_ranks.items(),
                          key=lambda kv: kv[1])).encode()
            + unicodedata.unidata_version.encode()).hexdigest()
        if cache_path is None:
            cache_dir = os.path.join(
                os.path.expanduser("~"), ".cache", "crisperwhisper_tpu")
            os.makedirs(cache_dir, mode=0o700, exist_ok=True)
            cache_path = os.path.join(cache_dir,
                                      f"encoder_{key[:32]}.cweb")
        sidecar = cache_path + ".sha"
        valid = False
        if os.path.exists(cache_path) and os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    rec_key, rec_sha = f.read().split()
                with open(cache_path, "rb") as f:
                    valid = (rec_key == key and
                             hashlib.sha256(f.read()).hexdigest()
                             == rec_sha)
            except (OSError, ValueError):
                valid = False
        if not valid:
            blob = self._build_blob(bpe)
            tmp = cache_path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, cache_path)
            tmp = sidecar + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"{key} {hashlib.sha256(blob).hexdigest()}")
            os.replace(tmp, sidecar)
        self.handle = self.lib.cw_encoder_load(cache_path.encode())

    @staticmethod
    def _build_blob(bpe) -> bytes:
        # token table: id -> raw bytes (byte-level indirection pre-resolved)
        n = max(bpe.decoder.keys()) + 1 if bpe.decoder else 0
        chunks: list[bytes] = []
        offsets = np.zeros(n + 1, np.uint32)
        total = 0
        for i in range(n):
            tok = bpe.decoder.get(i, "")
            raw = _token_bytes(bpe, tok)
            chunks.append(raw)
            total += len(raw)
            offsets[i + 1] = total
        # merges in rank order, as raw-byte left/right strings
        merges = sorted(bpe.bpe_ranks.items(), key=lambda kv: kv[1])
        mparts: list[bytes] = []
        moff = np.zeros(2 * len(merges) + 1, np.uint32)
        mtotal = 0
        for k, ((left, right), _rank) in enumerate(merges):
            for j, part in enumerate((left, right)):
                raw = _token_bytes(bpe, part)
                mparts.append(raw)
                mtotal += len(raw)
                moff[2 * k + j + 1] = mtotal
        return (b"CWEB" + np.uint32(1).tobytes()
                + np.uint32(n).tobytes() + offsets.tobytes()
                + b"".join(chunks)
                + np.uint32(len(merges)).tobytes() + moff.tobytes()
                + b"".join(mparts)
                + _unicode_ranges_blob())

    @property
    def available(self) -> bool:
        return self.handle is not None

    def encode(self, text: str) -> list[int]:
        data = np.frombuffer(text.encode("utf-8"), np.uint8)
        data = np.ascontiguousarray(data)
        cap = max(len(data), 1)
        out = np.empty(cap, np.int32)
        n = self.lib.cw_encode(self.handle, data, len(data), out, cap)
        if n < 0:
            # -2: symbol without a vocab id — surface to the Python path,
            # which raises the same KeyError HF's slow tokenizer would
            raise RuntimeError(f"native BPE encode failed (rc={n})")
        return out[:n].tolist()

    def __del__(self):
        if self.lib is not None and self.handle:
            try:
                self.lib.cw_encoder_free(self.handle)
            except Exception:
                pass


def native_read_wav(payload: bytes) -> tuple[int, np.ndarray] | None:
    """WAV bytes -> (sample_rate, f32 mono) via C++; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    isf = ctypes.c_int32()
    off = ctypes.c_int64()
    dlen = ctypes.c_int64()
    rc = lib.cw_wav_info(buf, len(buf), ctypes.byref(sr), ctypes.byref(ch),
                         ctypes.byref(bits), ctypes.byref(isf),
                         ctypes.byref(off), ctypes.byref(dlen))
    if rc != 0:
        return None
    bytes_per = (bits.value // 8) * ch.value
    if bytes_per <= 0:
        return None
    frames = dlen.value // bytes_per
    out = np.empty(frames, np.float32)
    n = lib.cw_wav_decode(buf, len(buf), out, frames)
    if n < 0:
        return None
    return sr.value, out[:n]
