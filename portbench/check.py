"""The comparison that decides ``correct``.

After the window has closed, the benchmark draws from the seed a sample
of the windows that the timed path served (the longest recording's first
and last windows always among them) and runs the plain reference
(``reference/``) once over each window's audio with the prompt and the
served tokens. Three numbers are compared:

* ``logit_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best among the tokens the traffic allows: a
  greedy decoder that computed what the model says serves the best
  token, up to rounding;
* ``ts_err_s``: the median over the sample's tokens of the gap between
  each served token time and the time the reference's alignment
  (``reference/align.py``: the alignment heads' cross attention, median
  filter, DTW) gives it;
* ``stitch_mismatch``: of the recordings the sampled windows belong to,
  those whose text and words differ in any way from what the reference's
  stitcher (``reference/stitch.py``) makes of the served tokens and
  token times, the pause adjustment included.

A mix without word times (``return_token_timestamps`` false) has no
token times: ``compare`` reads no ``ts`` and ``stitch_mismatch``
compares the text alone. With a control (``control.py``) the same
numbers are read for the tokens and times a lower-precision reference
puts first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .generator import SR, STRIDE, WINDOW
from .reference import align, model, stitch

TS_FRAME = 0.02


@dataclass
class Window:
    call: int
    recording: int
    start: int                     # sample offset in the recording
    length: int                    # samples
    tokens: np.ndarray             # served tokens (int64)
    times: np.ndarray              # served token times, s in the window
    max_new: int


def served_windows(traffic, calls: list, batches: list,
                   batch_size: int) -> list[Window]:
    """Each completed call's windows with what the program served for
    them: ``batches`` holds the capture of every generate() call in
    order; a call of W windows took ceil(W / batch_size) of them (a
    short last batch's padding rows come last and are dropped)."""
    out, bi = [], 0
    for ci, call in enumerate(calls):
        wins = traffic.windows(call)
        nb = math.ceil(len(wins) / batch_size)
        rows = [row for b in batches[bi:bi + nb] for row in b][:len(wins)]
        bi += nb
        if len(rows) != len(wins):
            raise RuntimeError(f"call {ci}: {len(rows)} served windows for "
                               f"{len(wins)} sent")
        for (r, s, n), (toks, times) in zip(wins, rows):
            out.append(Window(ci, r, s, n, toks, times, call.max_new))
    return out


def sample(windows: list[Window], k: int, seed: int,
           lengths: list[int]) -> list[Window]:
    """k windows drawn from the seed: the first and the last window of
    the longest recording served, then others at random."""
    if len(windows) <= k:
        return list(windows)
    longest = max({w.recording for w in windows}, key=lambda r: lengths[r])
    first_call = min(w.call for w in windows if w.recording == longest)
    mine = [i for i, w in enumerate(windows)
            if w.recording == longest and w.call == first_call]
    picked = sorted({mine[0], mine[-1]})
    rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
    rest = [i for i in range(len(windows)) if i not in picked]
    picked += [int(i) for i in rng.choice(rest, k - len(picked),
                                          replace=False)]
    return [windows[i] for i in picked]


def _window_audio(audio: list, w: Window) -> np.ndarray:
    x = np.zeros(WINDOW, np.float32)
    x[:w.length] = audio[w.recording][w.start:w.start + w.length]
    return x


def _deltas(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


def ts_stats(deltas: list) -> dict:
    """The per-token |time gaps| (s) over the sample: ``p50``, their
    median (compared as ``ts_err_s``), and ``share``, the share more than
    one frame apart (informative)."""
    d = np.concatenate(deltas) if deltas else np.zeros(1)
    return {"p50": float(np.quantile(d, 0.5)),
            "share": float(np.mean(d > TS_FRAME + 1e-6))}


def wrong_heads(align_heads: list, n_heads: int) -> list:
    """The planted fault ``heads``: each alignment head's neighbour in its
    layer."""
    return [[layer, (head + 1) % n_heads] for layer, head in align_heads]


def compare(params: dict, arch, windows: list[Window], audio: list,
            prompt: list[int], allowed_below: int | None,
            align_heads: list | None, median_width: int, mode: str, device,
            control: str | None = None, block: int = 4) -> dict:
    """The reference's readings over ``windows``:

    * ``logit_gap``: max over served tokens of the best allowed logit
      minus the served token's;
    * ``ts``, with ``align_heads`` (None: no word times): statistics
      (``ts_stats``) of |served token time - the reference's| (s), and
      ``ts_err_s``, their ``p50``, the number compared;
    * ``tokens``, ``distinct_tokens`` and ``median_margin`` (the
      reference's median lead of its best token over the second):
      how much the sample can tell, informative;
    * with ``control``, ``control``: ``logit_gap``, ``ts`` and
      ``ts_err_s`` of the tokens and times a reference in that mode puts
      first; and, with
      ``align_heads``, ``faults``: the ``ts`` statistics of three planted
      faults of the alignment tail: ``heads`` (the reference with
      ``wrong_heads``), ``shift`` (each served time replaced by the next
      token's) and ``reversed`` (a window's served times in reverse
      order).
    """
    ref = model.Reference(params, arch, mode)
    ctl = model.Reference(params, arch, control) if control else None
    word = align_heads is not None
    n_align = len(align_heads) if word else 0
    heads = [list(h) for h in align_heads] if word else None
    if word and ctl is not None:
        heads += wrong_heads(align_heads, arch.decoder_attention_heads)
    p = len(prompt)
    gap = ctl_gap = 0.0
    n_tok = 0
    served, ctl_d = [], []
    faults = {"heads": [], "shift": [], "reversed": []}
    margins, distinct = [], set()
    with model.no_tf32(), torch.no_grad():
        for i in range(0, len(windows), block):
            part = windows[i:i + block]
            wave = torch.from_numpy(np.stack(
                [_window_audio(audio, w) for w in part])).to(device)
            feats = model.log_mel(wave, arch.num_mel_bins)
            enc = ref.encode(feats)
            enc_c = ctl.encode(feats) if ctl else None
            for j, w in enumerate(part):
                n = len(w.tokens)
                if n == 0:
                    continue
                ids = torch.tensor([prompt + [int(t) for t in w.tokens]],
                                   device=device)
                logits, probs = ref.decode(enc[j:j + 1], ids, heads)
                logits = logits[0, p - 1:p - 1 + n]
                if allowed_below is not None:
                    logits[:, allowed_below:] = float("-inf")
                top2 = logits.topk(2, dim=-1).values
                best = top2[:, 0]
                margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
                distinct.update(int(t) for t in w.tokens)
                tok = torch.as_tensor(w.tokens, device=device)
                g = best - logits.gather(1, tok[:, None])[:, 0]
                gap = max(gap, float(g.max()))
                n_tok += n
                if word:
                    n_frames = max(min(w.length // 160 // 2,
                                       arch.max_source_positions), 1)
                    rows = probs[0, :, p:p + n - 1].cpu().numpy()

                    def times(r):
                        return align.token_times(r, n - 1, n_frames,
                                                 median_width, n)

                    ref_t = times(rows[:n_align])
                    mine = np.asarray(w.times[:n], np.float64)
                    served.append(_deltas(mine, ref_t))
                if ctl is not None:
                    if word:
                        faults["heads"].append(_deltas(
                            times(rows[n_align:]), ref_t))
                        faults["shift"].append(_deltas(
                            np.append(mine[1:], mine[-1:]), ref_t))
                        faults["reversed"].append(_deltas(mine[::-1],
                                                          ref_t))
                    c_logits, c_probs = ctl.decode(enc_c[j:j + 1], ids,
                                                   align_heads)
                    c_logits = c_logits[0, p - 1:p - 1 + n]
                    if allowed_below is not None:
                        c_logits[:, allowed_below:] = float("-inf")
                    pick = c_logits.argmax(dim=-1)
                    cg = best - logits.gather(1, pick[:, None])[:, 0]
                    ctl_gap = max(ctl_gap, float(cg.max()))
                    if word:
                        ctl_d.append(_deltas(times(
                            c_probs[0, :, p:p + n - 1].cpu().numpy()),
                            ref_t))
    out = {"logit_gap": gap}
    if word:
        out["ts"] = ts_stats(served)
        out["ts_err_s"] = out["ts"]["p50"]
    out.update(tokens=n_tok, distinct_tokens=len(distinct),
               median_margin=float(np.median(np.concatenate(margins)))
               if margins else 0.0)
    if ctl is not None:
        out["control"] = {"logit_gap": ctl_gap}
        if word:
            out["control"]["ts"] = ts_stats(ctl_d)
            out["control"]["ts_err_s"] = out["control"]["ts"]["p50"]
            out["faults"] = {k: ts_stats(v) for k, v in faults.items()}
    return out


def stitch_mismatches(traffic, calls: list, results: list,
                      windows: list[Window], picked: list[Window],
                      pause_threshold: float | None, pieces: list[bytes],
                      word: bool) -> tuple[int, int]:
    """(results differing, results compared): each recording that a
    picked window belongs to, in the call that served it, stitched again
    by the reference (``reference/stitch.py``, over the vocabulary's
    ``pieces``) from the served tokens and token times, and compared with
    the program's result exactly: text, every word and both of its times;
    without ``word`` times, the text of the tokens alone."""
    pairs = sorted({(w.call, w.recording) for w in picked})
    bad = 0
    for ci, r in pairs:
        mine = [w for w in windows if w.call == ci and w.recording == r]
        spans = []
        for k, w in enumerate(mine):
            left = 0 if w.start == 0 else STRIDE
            right = 0 if k == len(mine) - 1 else STRIDE
            spans.append((w.tokens, w.times,
                          (w.length / SR, left / SR, right / SR)))
        got = results[ci][calls[ci].recordings.index(r)]
        try:
            want = (stitch.transcribe(spans, pause_threshold, pieces) if word
                    else stitch.transcribe_text([w.tokens for w in mine],
                                                pieces))
        except ValueError:
            bad += 1
            continue
        bad += (got.get("text") != want["text"]
                or word and list(got.get("chunks", [])) != want["chunks"])
    return bad, len(pairs)


def audio_seconds(traffic, calls: list) -> float:
    return sum(traffic.lengths[r] for c in calls for r in c.recordings) / SR
