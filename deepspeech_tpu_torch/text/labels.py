"""Character label codec.

Behavioral parity with the reference label codec (reference data/labels.py):

* ``labels`` is the ordered alphabet string; index 0 is the CTC blank ``_``,
  index of ``'2'`` is the "doubled character" escape code, ``' '`` is the word
  separator (indices 0/28/29 with the shipped labels.json).
* ``find_words`` text cleanup (reference data/labels.py:19-39): strip a
  trailing ``2`` escape from letter runs, map ``*``/``+`` to spaces, expand
  ``%`` to the word for "percent", fold ``ё``->``е``, convert Roman numerals
  II..XXXX to digits, expand digit tokens to words (via
  :mod:`deepspeech_tpu_torch.text.num2words` — the reference imported a missing
  ``num2word`` module for this), expand ``123-я``-style ordinal+suffix tokens,
  then drop characters outside the alphabet.
* ``parse`` (reference data/labels.py:41-58): ``!clean:`` prefix bypasses
  cleanup; repeated characters encode as the ``'2'`` escape; empty text
  becomes ``*`` (which cleans away to nothing in the usual alphabet).
* ``render_transcript`` (reference data/labels.py:60-61): ids -> string.
"""

from __future__ import annotations

import json
import re

from deepspeech_tpu_torch.text.num2words import num2words

# Roman numerals II..XXXX -> 2..40 (reference data/labels.py:5-11)
_ROMAN = """II III IV V VI VII VIII IX X
XI XII XIII XIV XV XVI XVII XVIII XIX XX
XXI XXII XXIII XXIV XXV XXVI XXVII XXVIII XXIX XXX
XXXI XXXII XXXIII XXXIV XXXV XXXVI XXXVII XXXVIII XXXIX XXXX
""".split()
_ROMAN_TO_NUM = {x: i for i, x in enumerate(_ROMAN, 2)}

PERCENT_WORD = {"ru": "процент", "en": "percent"}


def load_labels(path: str) -> str:
    """Load a labels.json (list of single characters) into an alphabet string."""
    with open(path) as f:
        return "".join(json.load(f))


class Labels:
    """char<->id codec with transcript normalization.

    ``num_lang`` selects the number-expansion language. The reference hardwired
    Russian (its missing ``num2word`` module); default is auto: Russian if the
    alphabet contains Cyrillic, else English.
    """

    def __init__(self, labels: str, num_lang: str | None = None):
        self.labels = labels
        self.labels_map = {ch: i for i, ch in enumerate(labels)}
        if num_lang is None:
            num_lang = "ru" if re.search(r"[А-Яа-я]", labels) else "en"
        self.num_lang = num_lang

    @property
    def blank_index(self) -> int:
        return self.labels_map.get("_", 0)

    @property
    def space_index(self) -> int:
        # Out-of-bounds sentinel when the alphabet has no space, matching the
        # reference decoder's convention (reference decoder.py:39-42).
        return self.labels_map.get(" ", len(self.labels))

    @property
    def double_index(self) -> int | None:
        return self.labels_map.get("2")

    def find_words(self, text: str, clean: bool = True) -> list[str]:
        text = re.sub(r"([^\W\d]+)2", r"\1", text)
        text = text.replace("*", " ").replace("+", " ")
        text = text.replace("%", PERCENT_WORD.get(self.num_lang, "percent") + "*")
        text = text.replace("ё", "е").replace("Ё", "Е")
        words = re.findall(r"-?\d+|-?\d+-\w+|\w+", text)
        final = []
        for w in words:
            if w in _ROMAN_TO_NUM:
                w = str(_ROMAN_TO_NUM[w])
            if w.isdigit():
                w = num2words(w, ordinal=False, lang=self.num_lang)
            elif "-" in w:
                w1, w2 = w.split("-", 1)
                if w1.isdigit() and not w2.isdigit():
                    w = num2words(w1, ordinal=True, lang=self.num_lang) + w2
            if clean:
                w = "".join(c for c in w if c.upper() in self.labels_map).strip()
            if w:
                final.append(w)
        return final

    def parse(self, text: str) -> list[int]:
        """Text -> id sequence with the doubled-char '2' escape."""
        if text.startswith("!clean:"):
            text = text.replace("!clean:", "", 1)
            return [self.labels_map[c] for c in text.strip()]

        transcript: list[int] = []
        chars = " ".join(self.find_words(text)).upper().strip()
        if not chars:
            # Reference used '*' as an empty sentinel (data/labels.py:50), which
            # would KeyError against the shipped alphabet; empty is the intent.
            return []
        for c in chars:
            code = self.labels_map[c]
            if transcript and transcript[-1] == code:
                code = self.labels_map["2"]  # doubled character escape
            transcript.append(code)
        return transcript

    def render_transcript(self, codes) -> str:
        return "".join(self.labels[int(i)] for i in codes)
