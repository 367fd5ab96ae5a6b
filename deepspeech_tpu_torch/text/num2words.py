"""Number -> words normalization for transcript parsing.

The reference's ``data/labels.py:3`` imports a ``num2word`` module that is
missing from its repo (a Russian number-to-words normalizer). This module
supplies a working implementation with the same call signature used there
(``num2words(digit_string, ordinal=bool)``, see reference data/labels.py:27-34),
for both Russian (the reference's language) and English (the shipped
labels.json alphabet).

Supports integers with |n| < 10**12. Ordinals inflect only the final word
(standard for compound ordinals in both languages).
"""

from __future__ import annotations

_EN_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]
_EN_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

_RU_UNITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
             "восемь", "девять", "десять", "одиннадцать", "двенадцать",
             "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
             "семнадцать", "восемнадцать", "девятнадцать"]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
            "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]
# scale word: (one-form, few-form, many-form); thousands take feminine units
_RU_SCALES = [
    (10 ** 9, ("миллиард", "миллиарда", "миллиардов"), False),
    (10 ** 6, ("миллион", "миллиона", "миллионов"), False),
    (10 ** 3, ("тысяча", "тысячи", "тысяч"), True),
]
_RU_ORDINALS = {
    "ноль": "нулевой", "один": "первый", "два": "второй", "три": "третий",
    "четыре": "четвертый", "пять": "пятый", "шесть": "шестой",
    "семь": "седьмой", "восемь": "восьмой", "девять": "девятый",
    "десять": "десятый", "одиннадцать": "одиннадцатый",
    "двенадцать": "двенадцатый", "тринадцать": "тринадцатый",
    "четырнадцать": "четырнадцатый", "пятнадцать": "пятнадцатый",
    "шестнадцать": "шестнадцатый", "семнадцать": "семнадцатый",
    "восемнадцать": "восемнадцатый", "девятнадцать": "девятнадцатый",
    "двадцать": "двадцатый", "тридцать": "тридцатый", "сорок": "сороковой",
    "пятьдесят": "пятидесятый", "шестьдесят": "шестидесятый",
    "семьдесят": "семидесятый", "восемьдесят": "восьмидесятый",
    "девяносто": "девяностый", "сто": "сотый", "двести": "двухсотый",
    "триста": "трехсотый", "четыреста": "четырехсотый", "пятьсот": "пятисотый",
    "шестьсот": "шестисотый", "семьсот": "семисотый",
    "восемьсот": "восьмисотый", "девятьсот": "девятисотый",
    "тысяча": "тысячный", "миллион": "миллионный", "миллиард": "миллиардный",
}


def _ru_plural_form(n: int) -> int:
    """0 = one-form, 1 = few-form (2-4), 2 = many-form."""
    if n % 10 == 1 and n % 100 != 11:
        return 0
    if 2 <= n % 10 <= 4 and not 12 <= n % 100 <= 14:
        return 1
    return 2


def _ru_under_1000(n: int, feminine: bool) -> list[str]:
    words = []
    if n >= 100:
        words.append(_RU_HUNDREDS[n // 100])
        n %= 100
    if n >= 20:
        words.append(_RU_TENS[n // 10])
        n %= 10
    if n > 0:
        if feminine and n == 1:
            words.append("одна")
        elif feminine and n == 2:
            words.append("две")
        else:
            words.append(_RU_UNITS[n])
    return words


def _ru_cardinal_words(n: int) -> list[str]:
    if n == 0:
        return ["ноль"]
    words = []
    if n < 0:
        words.append("минус")
        n = -n
    for scale, forms, feminine in _RU_SCALES:
        if n >= scale:
            count = n // scale
            n %= scale
            if count == 1 and feminine:
                words.append("одна")
            else:
                words.extend(_ru_under_1000(count, feminine))
            words.append(forms[_ru_plural_form(count)])
    if n > 0:
        words.extend(_ru_under_1000(n, False))
    return words


def _en_under_1000(n: int) -> list[str]:
    words = []
    if n >= 100:
        words.extend([_EN_UNITS[n // 100], "hundred"])
        n %= 100
    if n >= 20:
        if n % 10:
            words.append(_EN_TENS[n // 10] + " " + _EN_UNITS[n % 10])
        else:
            words.append(_EN_TENS[n // 10])
    elif n > 0:
        words.append(_EN_UNITS[n])
    return words


def _en_cardinal_words(n: int) -> list[str]:
    if n == 0:
        return ["zero"]
    words = []
    if n < 0:
        words.append("minus")
        n = -n
    for scale, name in _EN_SCALES:
        if n >= scale:
            words.extend(_en_under_1000(n // scale))
            words.append(name)
            n %= scale
    if n > 0:
        words.extend(_en_under_1000(n))
    return words


def _en_ordinalize(word: str) -> str:
    # Only the last space-separated token inflects ("twenty one" -> "twenty first")
    head, _, last = word.rpartition(" ")
    if last in _EN_ORD_IRREGULAR:
        last = _EN_ORD_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last.endswith("e") and last == "twelve":  # handled above, kept for safety
        last = last[:-2] + "fth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _ru_ordinalize(words: list[str]) -> list[str]:
    last = words[-1]
    if last in _RU_ORDINALS:
        words = words[:-1] + [_RU_ORDINALS[last]]
    elif last.endswith(("а", "и")) and last[:-1] in _RU_ORDINALS:  # тысяча forms
        words = words[:-1] + [_RU_ORDINALS[last[:-1]]]
    return words


def num2words(number, ordinal: bool = False, lang: str = "ru") -> str:
    """Render an integer (or digit string) as words.

    Mirrors the call contract of the reference's missing ``num2word.num2words``
    (reference data/labels.py:27-34): accepts a digit string, returns a
    space-separated word string; ``ordinal=True`` inflects the final word.
    """
    n = int(number)
    if abs(n) >= 10 ** 12:
        return str(number)  # out of supported range: pass through
    if lang == "en":
        words = _en_cardinal_words(n)
        if ordinal:
            return _en_ordinalize(" ".join(words))
        return " ".join(words)
    words = _ru_cardinal_words(n)
    if ordinal:
        words = _ru_ordinalize(words)
    return " ".join(words)
