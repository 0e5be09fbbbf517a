"""Generate searchlite/analysis/_uax29_tables.py.

Extracts the Unicode Word_Break property intervals (plus
Extended_Pictographic, needed by rule WB3c) from the `regex` module's
bundled Unicode Character Database, so the runtime tokenizer needs no
third-party dependency and no per-character property probing. Rerun
when the environment's UCD version changes:

    python tools/gen_wb_table.py
"""

from __future__ import annotations

import sys
import unicodedata

import regex

CLASSES = [
    "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator",
    "Format", "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote",
    "Double_Quote", "MidNumLet", "MidLetter", "MidNum", "Numeric",
    "ExtendNumLet", "WSegSpace",
]

ALL_CHARS = "".join(
    chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF)


def intervals(pattern: str) -> list[tuple[int, int]]:
    pat = regex.compile(pattern + "+")
    out = []
    for m in pat.finditer(ALL_CHARS, concurrent=False):
        s = m.group(0)
        lo, hi = ord(s[0]), ord(s[-1])
        # the scan string skips surrogates, so a matched run can span
        # the gap; split it back into real codepoint intervals
        if lo < 0xD800 <= hi:
            out.append((lo, 0xD7FF))
            out.append((0xE000, hi))
        else:
            out.append((lo, hi))
    return out


def main():
    lines = [
        '"""Unicode Word_Break property intervals (GENERATED — do not',
        "edit; regenerate with tools/gen_wb_table.py).",
        "",
        f"Unicode {unicodedata.unidata_version} via regex "
        f"{regex.__version__}.",
        '"""',
        "",
        "# flake8: noqa",
        "",
    ]
    total = 0
    for name in CLASSES:
        ivs = intervals(rf"\p{{Word_Break={name}}}")
        total += len(ivs)
        lines.append(f"{name.upper()} = {ivs!r}")
        lines.append("")
    ivs = intervals(r"\p{Extended_Pictographic}")
    total += len(ivs)
    lines.append(f"EXTENDED_PICTOGRAPHIC = {ivs!r}")
    lines.append("")
    # Rust char::is_alphanumeric() = Alphabetic | Nd | Nl | No — the
    # word filter of unicode-segmentation's unicode_words()
    ivs = intervals(r"[\p{Alphabetic}\p{Nd}\p{Nl}\p{No}]")
    total += len(ivs)
    lines.append(f"ALPHANUMERIC = {ivs!r}")
    lines.append("")
    sys.stdout.write("\n".join(lines))
    sys.stderr.write(f"{total} intervals\n")


if __name__ == "__main__":
    main()
