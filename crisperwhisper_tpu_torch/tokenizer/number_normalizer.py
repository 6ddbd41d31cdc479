"""Spelled-number normalization for English WER scoring.

From-scratch implementation of the observable behavior of the reference's
EnglishNumberNormalizer (hf english_normalizer.py:96-498), used by the
EnglishTextNormalizer during evaluation: spelled-out numbers become arabic
numerals while keeping suffixes (1960s, 32nd), currency words collapse
onto the amount as symbols (twenty dollars -> $20, with the $x and ¢y ->
$x.0y post-pass), "point" starts digit-wise decimals, "double/triple"
expand digits, successive single digits concatenate nominally (one oh one
-> 101), "per cent"/"percent" becomes %, and "<number> and a half"
becomes "<number> point five" in a pre-pass. Multipliers run through
decillion (10^33).

Parity is pinned by a randomized differential test against the installed
HF implementation (tests/test_number_normalizer.py) plus a pinned battery.
"""

from __future__ import annotations

import re
from fractions import Fraction

_NUMERIC = re.compile(r"^\d+(\.\d+)?$")

_ONES = {w: i for i, w in enumerate(
    ["one", "two", "three", "four", "five", "six", "seven", "eight",
     "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
     "sixteen", "seventeen", "eighteen", "nineteen"], start=1)}
_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
         "seventy": 70, "eighty": 80, "ninety": 90}
_MULT = {"hundred": 10 ** 2, "thousand": 10 ** 3, "million": 10 ** 6,
         "billion": 10 ** 9, "trillion": 10 ** 12,
         "quadrillion": 10 ** 15, "quintillion": 10 ** 18,
         "sextillion": 10 ** 21, "septillion": 10 ** 24,
         "octillion": 10 ** 27, "nonillion": 10 ** 30,
         "decillion": 10 ** 33}
_ZEROS = {"o", "oh", "zero"}

# suffixed forms: plural ("fours" -> 4s) and ordinal ("fourth" -> 4th)
_ONES_SUFFIXED: dict[str, tuple[int, str]] = {
    ("sixes" if w == "six" else w + "s"): (v, "s") for w, v in _ONES.items()}
_ONES_SUFFIXED.update({"zeroth": (0, "th"), "first": (1, "st"),
                       "second": (2, "nd"), "third": (3, "rd"),
                       "fifth": (5, "th"), "twelfth": (12, "th")})
_ONES_SUFFIXED.update({
    w + ("h" if w.endswith("t") else "th"): (v, "th")
    for w, v in _ONES.items() if v > 3 and v not in (5, 12)})
_TENS_SUFFIXED = {**{w.replace("y", "ies"): (v, "s")
                     for w, v in _TENS.items()},
                  **{w.replace("y", "ieth"): (v, "th")
                     for w, v in _TENS.items()}}
_MULT_SUFFIXED = {**{w + "s": (v, "s") for w, v in _MULT.items()},
                  **{w + "th": (v, "th") for w, v in _MULT.items()}}

_SIGNS = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
_CURRENCY = {"pound": "£", "pounds": "£", "euro": "€", "euros": "€",
             "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢"}
_PREFIX_SYMBOLS = set(_SIGNS.values()) | set(_CURRENCY.values())
_SPECIALS = {"and", "double", "triple", "point"}
_DECIMAL_WORDS = set(_ONES) | set(_TENS) | _ZEROS

_ALL_WORDS = (set(_ZEROS) | set(_ONES) | set(_ONES_SUFFIXED) | set(_TENS)
              | set(_TENS_SUFFIXED) | set(_MULT) | set(_MULT_SUFFIXED)
              | set(_SIGNS) | set(_CURRENCY) | {"per", "percent"}
              | _SPECIALS)


class EnglishNumberNormalizer:
    def __call__(self, text: str) -> str:
        text = self._pre(text)
        text = " ".join(w for w in self._fold(text.split()) if w is not None)
        return self._post(text)

    # -- pre/post regex passes --------------------------------------------

    @staticmethod
    def _pre(s: str) -> str:
        # "<number> and a half" -> "<number> point five" (only when the
        # preceding word really is numeric)
        pieces = re.split(r"\band\s+a\s+half\b", s)
        kept: list[str] = []
        for k, piece in enumerate(pieces):
            if not piece.strip():
                continue
            kept.append(piece)
            if k != len(pieces) - 1:
                tail = piece.rsplit(maxsplit=2)[-1]
                kept.append("point five"
                            if tail in _DECIMAL_WORDS or tail in _MULT
                            else "and a half")
        s = " ".join(kept)
        # split letter/digit boundaries, then re-glue ordinal suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    @staticmethod
    def _post(s: str) -> str:
        def glue_cents(m: re.Match) -> str:
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
                   glue_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b",
                   lambda m: f"¢{int(m.group(1))}", s)
        # keep "one(s)" spelled for readability
        return re.sub(r"\b1(s?)\b", r"one\1", s)

    # -- the word-stream fold ----------------------------------------------

    def _fold(self, words: list[str]):
        """Accumulator machine over the word stream.

        acc is the number being built: None, an int (arithmetic mode) or a
        string (nominal digit-concatenation mode). sym is a pending
        currency/sign symbol glued onto the next emission.
        """
        acc: int | str | None = None
        sym: str | None = None

        def emit(x) -> str:
            nonlocal acc, sym
            out = str(x) if sym is None else sym + str(x)
            acc, sym = None, None
            return out

        if not words:
            return

        n = len(words)
        eat_next = False
        for k, w in enumerate(words):
            if eat_next:
                eat_next = False
                continue
            prev = words[k - 1] if k else None
            nxt = words[k + 1] if k + 1 < n else None
            nxt_numeric = nxt is not None and _NUMERIC.match(nxt)

            symboled = w[:1] in _PREFIX_SYMBOLS
            bare = w[1:] if symboled else w
            if _NUMERIC.match(bare):
                # arabic number (possibly "$20" / "-3.5")
                if acc is not None:
                    if isinstance(acc, str) and acc.endswith("."):
                        acc = acc + str(w)   # decimal / ip-style continue
                        continue
                    yield emit(acc)
                if symboled:
                    sym = w[0]
                f = Fraction(bare)
                acc = f.numerator if f.denominator == 1 else bare
            elif w not in _ALL_WORDS:
                if acc is not None:
                    yield emit(acc)
                yield emit(w)
            elif w in _ZEROS:
                acc = str(acc or "") + "0"
            elif w in _ONES:
                v = _ONES[w]
                if acc is None:
                    acc = v
                elif isinstance(acc, str) or prev in _ONES:
                    if prev in _TENS and v < 10:   # "twenty one" -> 21
                        acc = str(acc)[:-1] + str(v)
                    else:
                        acc = str(acc) + str(v)
                elif v < 10:
                    acc = acc + v if acc % 10 == 0 else str(acc) + str(v)
                else:                              # eleven..nineteen
                    acc = acc + v if acc % 100 == 0 else str(acc) + str(v)
            elif w in _ONES_SUFFIXED:
                v, suf = _ONES_SUFFIXED[w]
                if acc is None:
                    yield emit(f"{v}{suf}")
                elif isinstance(acc, str) or prev in _ONES:
                    if prev in _TENS and v < 10:
                        yield emit(f"{str(acc)[:-1]}{v}{suf}")
                    else:
                        yield emit(f"{acc}{v}{suf}")
                elif v < 10:
                    yield emit(f"{acc + v}{suf}" if acc % 10 == 0
                               else f"{acc}{v}{suf}")
                else:
                    yield emit(f"{acc + v}{suf}" if acc % 100 == 0
                               else f"{acc}{v}{suf}")
                acc = None
            elif w in _TENS:
                v = _TENS[w]
                if acc is None:
                    acc = v
                elif isinstance(acc, str):
                    acc = str(acc) + str(v)
                else:
                    acc = acc + v if acc % 100 == 0 else str(acc) + str(v)
            elif w in _TENS_SUFFIXED:
                v, suf = _TENS_SUFFIXED[w]
                if acc is None:
                    yield emit(f"{v}{suf}")
                elif isinstance(acc, str):
                    yield emit(f"{acc}{v}{suf}")
                else:
                    yield emit(f"{acc + v}{suf}" if acc % 100 == 0
                               else f"{acc}{v}{suf}")
            elif w in _MULT:
                m = _MULT[w]
                if acc is None:
                    acc = m
                elif isinstance(acc, str) or acc == 0:
                    try:
                        p = Fraction(acc) * m
                    except ValueError:
                        p = None
                    if p is not None and p.denominator == 1:
                        acc = p.numerator
                    else:
                        yield emit(acc)
                        acc = m
                else:
                    # only the sub-thousand residual scales: "one hundred
                    # thousand" = 100*1000 but "one thousand hundred"
                    # keeps the completed thousands group intact
                    acc = acc // 1000 * 1000 + (acc % 1000) * m
            elif w in _MULT_SUFFIXED:
                m, suf = _MULT_SUFFIXED[w]
                if acc is None:
                    yield emit(f"{m}{suf}")
                elif isinstance(acc, str):
                    try:
                        p = Fraction(acc) * m
                    except ValueError:
                        p = None
                    if p is not None and p.denominator == 1:
                        yield emit(f"{p.numerator}{suf}")
                    else:
                        yield emit(acc)
                        yield emit(f"{m}{suf}")
                else:
                    yield emit(f"{acc // 1000 * 1000 + (acc % 1000) * m}"
                               f"{suf}")
                acc = None
            elif w in _SIGNS:
                if acc is not None:
                    yield emit(acc)
                if nxt in _ALL_WORDS or nxt_numeric:
                    sym = _SIGNS[w]
                else:
                    yield emit(w)
            elif w in _CURRENCY:
                if acc is not None:
                    sym = _CURRENCY[w]
                    yield emit(acc)
                else:
                    yield emit(w)
            elif w == "per":
                if acc is not None:
                    if nxt == "cent":
                        yield emit(f"{acc}%")
                        eat_next = True
                    else:
                        yield emit(acc)
                        yield emit(w)
                else:
                    yield emit(w)
            elif w == "percent":
                if acc is not None:
                    yield emit(f"{acc}%")
                else:
                    yield emit(w)
            elif w in _SPECIALS:
                if nxt not in _ALL_WORDS and not nxt_numeric:
                    if acc is not None:
                        yield emit(acc)
                    yield emit(w)
                elif w == "and":
                    # "one hundred and five": the glue word vanishes
                    if prev not in _MULT:
                        if acc is not None:
                            yield emit(acc)
                        yield emit(w)
                elif w in ("double", "triple"):
                    if nxt in _ONES or nxt in _ZEROS:
                        d = str(_ONES.get(nxt, 0))
                        acc = str(acc or "") + d * (2 if w == "double"
                                                    else 3)
                        eat_next = True
                    else:
                        if acc is not None:
                            yield emit(acc)
                        yield emit(w)
                elif w == "point":
                    if nxt in _DECIMAL_WORDS or nxt_numeric:
                        acc = str(acc or "") + "."
                    # else: dangling "point" before a non-decimal number
                    # word is swallowed (quirk)

        if acc is not None:
            yield emit(acc)
