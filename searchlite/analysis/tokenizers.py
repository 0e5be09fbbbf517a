"""Tokenizers: ``default``, ``unicode``, ``whitespace``.

Behavioral parity with the reference (searchlite-core
`analysis/tokenizer.rs:7-54`):

- ``default``: split on non-alphanumeric chars, ASCII-lowercase the rest.
- ``unicode``: NFKC normalize, split into words (UAX#29-style), lowercase.
- ``whitespace``: split on unicode whitespace, no normalization.

Tokens carry a position (index of the token in the stream), used for
phrase queries.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass


@dataclass
class Token:
    text: str
    position: int


def default_tokenize(text: str) -> list[Token]:
    tokens: list[Token] = []
    current: list[str] = []
    position = 0
    for ch in text:
        if ch.isalnum():
            # ASCII-lowercase only, matching the reference's
            # `to_ascii_lowercase` (non-ASCII kept as-is).
            o = ord(ch)
            current.append(chr(o + 32) if 65 <= o <= 90 else ch)
        elif current:
            tokens.append(Token("".join(current), position))
            current = []
            position += 1
    if current:
        tokens.append(Token("".join(current), position))
    return tokens


def unicode_tokenize(text: str) -> list[Token]:
    """NFKC + exact UAX#29 word segmentation + lowercase — parity with
    `analysis/tokenizer.rs:31-41` (nfkc → unicode_words → lowercase).
    The full Word_Break rule machine lives in analysis/uax29.py."""
    from searchlite.analysis.uax29 import unicode_words

    normalized = unicodedata.normalize("NFKC", text)
    return [
        Token(word.lower(), idx)
        for idx, word in enumerate(unicode_words(normalized))
    ]


def whitespace_tokenize(text: str) -> list[Token]:
    return [Token(word, idx) for idx, word in enumerate(text.split())]


TOKENIZERS = {
    "default": default_tokenize,
    "unicode": unicode_tokenize,
    "whitespace": whitespace_tokenize,
}
