"""UAX#29 word segmentation: spec-rule tests + tokenizer goldens.

The reference's `unicode` tokenizer is NFKC → unicode-segmentation
``unicode_words()`` → lowercase (`analysis/tokenizer.rs:31-41`). Each
case below is derived directly from a UAX#29 Word_Break rule (noted
inline), so the suite pins the exact rule machine in
analysis/uax29.py — not an approximation of it.
"""

import pytest

from searchlite.analysis.tokenizers import unicode_tokenize
from searchlite.analysis.uax29 import unicode_words, word_bounds, words


def toks(text):
    return [t.text for t in unicode_tokenize(text)]


class TestWordBreakRules:
    def test_spec_example_sentence(self):
        # the UAX#29 running example
        got = unicode_words(
            "The quick (“brown”) fox can't jump 32.3 feet, "
            "right?")
        assert got == ["The", "quick", "brown", "fox", "can't", "jump",
                       "32.3", "feet", "right"]

    def test_wb3_crlf(self):
        assert words("a\r\nb") == ["a", "\r\n", "b"]
        assert words("a\rb") == ["a", "\r", "b"]

    def test_wb3d_space_runs(self):
        assert words("a  b") == ["a", "  ", "b"]

    def test_wb5_letters_join(self):
        assert unicode_words("abcΔδ") == ["abcΔδ"]  # ALetter chain

    def test_wb6_wb7_midletter(self):
        assert unicode_words("can't") == ["can't"]
        assert unicode_words("a:b") == ["a:b"]  # U+003A is MidLetter
        assert unicode_words("a: b") == ["a", "b"]
        assert unicode_words("'a'") == ["a"]  # edge quotes break off

    def test_wb7a_hebrew_single_quote(self):
        # Hebrew_Letter × Single_Quote keeps the geresh
        assert unicode_words("א'") == ["א'"]
        # but a latin letter does not: trailing quote drops
        assert unicode_words("a'") == ["a"]

    def test_wb7b_wb7c_hebrew_double_quote(self):
        # Hebrew gershayim: א"ב is one word
        assert unicode_words('א"ב') == ['א"ב']
        assert unicode_words('a"b') == ["a", "b"]

    def test_wb8_to_wb12_numbers(self):
        assert unicode_words("1234") == ["1234"]
        assert unicode_words("a1b2") == ["a1b2"]       # WB9/WB10
        assert unicode_words("3.14") == ["3.14"]       # WB11/12 MidNumLet
        assert unicode_words("1,000,000.5") == ["1,000,000.5"]  # MidNum
        assert unicode_words("1, 2") == ["1", "2"]
        assert unicode_words("example.com") == ["example.com"]

    def test_wb13_katakana(self):
        assert unicode_words("カタカナ") == \
            ["カタカナ"]
        # Katakana × ALetter breaks (WB999)
        assert unicode_words("カa") == ["カ", "a"]

    def test_wb13a_wb13b_extendnumlet(self):
        assert unicode_words("a_b") == ["a_b"]
        assert unicode_words("snake_case_2") == ["snake_case_2"]
        assert unicode_words("_") == []  # no alphanumeric content

    def test_wb4_extend_attaches(self):
        # combining acute attaches to its base (WB4)
        assert unicode_words("étude") == ["étude"]
        # leading Extend after sot is its own segment (no absorption)
        assert words("́a")[0] == "́"

    def test_wb3c_zwj_emoji(self):
        # ZWJ × Extended_Pictographic: one segment, filtered (no alnum)
        seq = "\U0001F469‍\U0001F680"
        assert words(seq) == [seq]
        assert unicode_words(seq) == []
        # ZWJ × ALetter breaks (WB999): the letter survives alone
        assert unicode_words("‍a") == ["a"]

    def test_wb15_wb16_flags(self):
        us, fr = "\U0001F1FA\U0001F1F8", "\U0001F1EB\U0001F1F7"
        assert words(us + fr) == [us, fr]  # break between flag PAIRS

    def test_han_breaks_per_char(self):
        # Han is Word_Break=Other: each ideograph is its own word
        assert unicode_words("中文") == ["中", "文"]

    def test_bounds_cover_text(self):
        for t in ("", "x", "hello world", "á‍\U0001F600"):
            b = word_bounds(t)
            assert b[0] == 0 and b[-1] == len(t)
            assert b == sorted(set(b))


class TestUnicodeTokenizer:
    def test_nfkc_and_lowercase(self):
        # NFKC folds the ligature and fullwidth forms; lowercase after
        assert toks("ﬁle") == ["file"]          # ﬁ → fi
        assert toks("ＨＥＬＬＯ") == ["hello"]
        assert toks("Straße") == ["straße"]

    def test_positions_sequential(self):
        t = unicode_tokenize("один два три")
        assert [x.position for x in t] == [0, 1, 2]
        assert [x.text for x in t] == ["один", "два", "три"]

    def test_multilingual_golden(self):
        got = toks("Füße 北京 こんにちは קל\"ב don't 3.5kg — вот!")
        # NFKC keeps composed chars; こんにちは is Hiragana (WB=Other,
        # alphabetic → per-char words); 3.5kg joins via WB9/WB11
        assert got == ["füße", "北", "京", "こ", "ん", "に", "ち", "は",
                       "קל\"ב", "don't", "3.5kg", "вот"]

    def test_superscript_nfkc(self):
        # NFKC maps x² → x2 which then joins via WB9
        assert toks("x²") == ["x2"]
