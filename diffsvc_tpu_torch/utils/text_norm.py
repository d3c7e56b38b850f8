"""Chinese non-standard-word (NSW) normalization for TTS text frontends.

A copy of ``diffsvc_tpu/utils/text_norm.py``; ``tests/test_torch_standalone.py``
holds it against the original.

Behavior target: reference ``utils/text_norm.py`` (a 790-LoC vendored copy
of chn_text_norm) — turn numbers, dates, telephone numbers, fractions,
percentages and money amounts embedded in Chinese text into their spoken
Chinese-character reading, plus the ``num2chn``/``chn2num`` conversions it
exposes.  The reference never imports that module anywhere (legacy TTS
frontend, dead code for SVC); it is provided here for inventory
completeness as an ORIGINAL, compact implementation — same public surface
(``NSWNormalizer``, ``num2chn``, ``chn2num``), independently written rules.

Conventions (documented choices where the spoken form has variants):
- 10..19 read without the leading 一 (十五, not 一十五); larger numbers
  keep it (一百一十五).
- Decimal parts are read digit-by-digit after 点.
- Telephone digits read 1 as 幺; separators become short pauses (，).
- Years are read digit-by-digit (二零一九年); months/days as cardinals.
"""

from __future__ import annotations

import re

DIGITS = "零一二三四五六七八九"
DIGITS_BIG = "零壹贰叁肆伍陆柒捌玖"
UNITS_SMALL = ["", "十", "百", "千"]
UNITS_SMALL_BIG = ["", "拾", "佰", "仟"]
# mid-scale numbering: each group of 4 decimal digits gets one large unit
# (capped at 万亿 = 1e12 so every emitted string parses back via chn2num)
UNITS_LARGE = ["", "万", "亿", "万亿"]
UNITS_LARGE_BIG = ["", "萬", "億", "萬億"]

# punctuation tables kept for API parity with the reference module
CHINESE_PUNC_STOP = "！？｡。"
CHINESE_PUNC_NON_STOP = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃《》"
    "「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏"
)
CHINESE_PUNC_LIST = CHINESE_PUNC_STOP + CHINESE_PUNC_NON_STOP


def _group4(digits: str) -> str:
    """Read one 0000-9999 group with 千/百/十 units, collapsing zeros."""
    out = []
    n = len(digits)
    pending_zero = False
    for i, ch in enumerate(digits):
        d = int(ch)
        unit = UNITS_SMALL[n - 1 - i]
        if d == 0:
            if out:
                pending_zero = True
            continue
        if pending_zero:
            out.append("零")
            pending_zero = False
        out.append(DIGITS[d] + unit)
    return "".join(out)


def num2chn(number, big: bool = False, traditional: bool = False,
            alt_two: bool = False) -> str:
    """Render a number (int/float/str) as spoken Chinese characters.

    ``big``: financial (大写) digits/units, e.g. 123 -> 壹佰贰拾叁.
    ``traditional``: traditional-script large units (萬/億).
    ``alt_two``: read 2 as 两 before 百/千/万/亿 (colloquial cardinal).
    """
    s = str(number).strip()
    neg = s.startswith("-") or s.startswith("负")
    s = s.lstrip("+-负")
    if "." in s:
        int_part, frac_part = s.split(".", 1)
    else:
        int_part, frac_part = s, ""
    int_part = int_part.lstrip("0") or "0"
    if not int_part.isdigit() or (frac_part and not frac_part.isdigit()):
        raise ValueError(f"not a number: {number!r}")
    if len(int_part) > 4 * (len(UNITS_LARGE) - 1) + 4:
        raise ValueError(f"number too large: {number!r}")

    if int_part == "0":
        text = DIGITS[0]
    else:
        # split into 4-digit groups from the right; group i gets UNITS_LARGE[i]
        groups = []
        rest = int_part
        while rest:
            groups.append(rest[-4:])
            rest = rest[:-4]
        parts = []
        large = UNITS_LARGE_BIG if traditional else UNITS_LARGE
        for i in range(len(groups) - 1, -1, -1):
            g = groups[i]
            if int(g) == 0:
                continue
            read = _group4(g)
            # a skipped-zero boundary (e.g. 10005) or a group with leading
            # zeros after a higher group (e.g. 1000500) inserts one 零
            if parts and (len(g) < 4 or g[0] == "0"):
                read = "零" + read
            parts.append(read + large[i])
        text = "".join(parts)
        if text.startswith("一十"):
            text = text[1:]

    if frac_part:
        text += "点" + "".join(DIGITS[int(c)] for c in frac_part)
    if alt_two:
        text = re.sub("二(?=[百千万亿萬億])", "两", text)
    if big:
        trans = str.maketrans(
            DIGITS + "十百千万亿",
            DIGITS_BIG + "拾佰仟" + ("萬億" if traditional else "万亿"))
        text = text.translate(trans)
    return ("负" if neg else "") + text


def chn2num(text: str) -> int:
    """Parse a Chinese cardinal (一千二百三十四 / 两百 / 十五 …) to an int."""
    small = {"十": 10, "百": 100, "千": 1000,
             "拾": 10, "佰": 100, "仟": 1000}
    digit = {}
    for table in (DIGITS, DIGITS_BIG):
        digit.update({c: i for i, c in enumerate(table)})
    digit["两"] = digit["兩"] = 2
    digit["〇"] = 0
    digit["幺"] = 1

    neg = text.startswith("负") or text.startswith("負")
    text = text.lstrip("正负負")
    total = 0        # completed 万/亿 sections
    section = 0      # current section below the next large unit
    cur = 0          # pending digit
    for ch in text:
        if ch in digit:
            cur = digit[ch]
        elif ch in small:
            section += (cur if cur else 1) * small[ch]
            cur = 0
        elif ch in ("万", "萬"):
            section = (section + cur) * 10 ** 4
            cur = 0
        elif ch in ("亿", "億"):
            # additive collapse: 万亿-scale sections (五十九万亿…亿…) keep
            # earlier 亿-chunks intact in `total`
            total += (section + cur) * 10 ** 8
            section = cur = 0
        else:
            raise ValueError(f"not a Chinese numeral: {text!r}")
    value = total + section + cur
    return -value if neg else value


def _digits_spoken(s: str, alt_one: bool = True) -> str:
    """Digit-by-digit reading (phone numbers, years): 1 -> 幺 optionally."""
    out = []
    for c in s:
        if c.isdigit():
            out.append("幺" if (alt_one and c == "1") else DIGITS[int(c)])
    return "".join(out)


def _num_spoken_safe(s: str, **kw) -> str:
    """num2chn with graceful degradation: numbers whose integer part
    exceeds the unit table (>16 digits, possibly signed / with a decimal
    point) read digit-by-digit instead of raising — a text-normalization
    frontend must never crash on arbitrary input text."""
    try:
        return num2chn(s, **kw)
    except ValueError:
        out = "负" if str(s).startswith(("-", "负")) else ""
        ip, _, fp = str(s).lstrip("+-负").partition(".")
        out += _digits_spoken(ip)
        if fp:
            out += "点" + _digits_spoken(fp)
        return out


class NSWNormalizer:
    """Normalize non-standard words in Chinese text to spoken characters.

    Same call shape as the reference: ``NSWNormalizer(text).normalize()``.
    Rules are applied most-specific-first so e.g. a phone number is never
    half-eaten by the cardinal rule.
    """

    def __init__(self, raw_text: str):
        self.raw_text = raw_text

    # --- individual rules (each: match -> replacement string) -------------

    @staticmethod
    def _telephone(m: re.Match) -> str:
        return "，".join(_digits_spoken(p) for p in re.split(r"[-\s]", m.group(0)))

    @staticmethod
    def _date(m: re.Match) -> str:
        y, mo, d = m.group("y"), m.group("m"), m.group("d")
        out = ""
        if y:
            out += _digits_spoken(y[:-1], alt_one=False) + "年"
        if mo:
            out += num2chn(mo[:-1]) + "月"
        if d:
            out += num2chn(d[:-1]) + d[-1]
        return out

    @staticmethod
    def _fraction(m: re.Match) -> str:
        num, den = m.group(1), m.group(2)
        return _num_spoken_safe(den) + "分之" + _num_spoken_safe(num)

    @staticmethod
    def _percentage(m: re.Match) -> str:
        return "百分之" + _num_spoken_safe(m.group(1))

    @staticmethod
    def _money(m: re.Match) -> str:
        return _num_spoken_safe(m.group(1), alt_two=True) + m.group(2)

    @staticmethod
    def _cardinal(m: re.Match) -> str:
        s = m.group(0)
        # very long bare digit runs (ids, codes) read digit-by-digit
        if "." not in s and "-" not in s and len(s) > 12:
            return _digits_spoken(s)
        return _num_spoken_safe(s)

    def normalize(self) -> str:
        text = self.raw_text
        # telephone: 11-digit mobile, or area-code landline with separators
        text = re.sub(r"(?<!\d)1[3-9]\d{9}(?!\d)", self._telephone, text)
        text = re.sub(r"(?<!\d)0\d{2,3}[-\s]\d{7,8}(?!\d)",
                      self._telephone, text)
        # dates: 2019年5月29日 / 5月29日 / 29号
        text = re.sub(
            r"(?P<y>\d{2,4}年)?(?P<m>\d{1,2}月)?(?P<d>\d{1,3}[日号])",
            self._date, text)
        text = re.sub(r"(?P<y>\d{2,4}年)(?P<m>\d{1,2}月)?(?P<d>)",
                      self._date, text)
        # fraction before percentage/cardinal: 2/3
        text = re.sub(r"(?<![\d.])(\d+)/(\d+)(?![\d.])", self._fraction, text)
        # percentages: 95% / 3.5% / 百分之95
        text = re.sub(r"(\d+(?:\.\d+)?)[%％]", self._percentage, text)
        text = re.sub(r"百分之(\d+(?:\.\d+)?)",
                      lambda m: "百分之" + _num_spoken_safe(m.group(1)), text)
        # money: 13.5元 / 99块 / 5角 / ￥20
        text = re.sub(r"(\d+(?:\.\d+)?)(元|块钱|块|角|毛|分钱)",
                      self._money, text)
        text = re.sub(r"[￥¥](\d+(?:\.\d+)?)",
                      lambda m: _num_spoken_safe(m.group(1), alt_two=True) + "元",
                      text)
        # remaining numbers (optionally signed / decimal) as cardinals
        text = re.sub(r"-?\d+(?:\.\d+)?", self._cardinal, text)
        return text
