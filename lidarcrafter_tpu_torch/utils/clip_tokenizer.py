"""CLIP's byte-level BPE tokenizer.

The port's copy of the JAX package's ``utils/clip_tokenizer.py``: it
tokenizes as OpenAI CLIP's ``SimpleTokenizer`` and ``clip.tokenize`` do
(start and end tokens, zero padding to the context, over-long texts
truncated with the last slot forced to the end token).  The merges table
(``bpe_simple_vocab_16e6.txt.gz``, shipped with the ``clip`` package) is
data the user supplies beside the CLIP weights; a plain or gzipped file is
read.  ``ftfy`` text fixing applies where it is installed; the scene-graph
vocabulary is plain ASCII, for which the fallback (HTML unescaping,
whitespace collapsed) is the same.

Words are split by a scanner of the alternatives of CLIP's pattern
(``PATTERN``, which CLIP matches with the ``regex`` package) over Python's
Unicode tables (``unicodedata``), so the port needs no ``regex``: the same
split on every code point those tables know.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from pathlib import Path

import numpy as np

SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
           r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")
# str.isspace() holds for the information separators U+001C..U+001F, which
# are not Unicode White_Space (the regex package's \s)
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte → printable character map (GPT-2 / CLIP): printable
    Latin-1 bytes map to themselves, the rest to 256 + n."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _is_space(c: str) -> bool:
    return c.isspace() and c not in _NOT_WHITE_SPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    """Runs of white space → one space (``\\s+`` → ' '), ends stripped."""
    out, prev = [], False
    for c in text:
        space = _is_space(c)
        if not (space and prev):
            out.append(" " if space else c)
        prev = space
    return "".join(out).strip()


def scan_words(text: str) -> list[str]:
    """``regex.findall(PATTERN, text, IGNORECASE)`` on lower-cased text: at
    each position the first alternative that matches, in the pattern's
    order (the special tokens, the contractions, a run of letters, one
    number, a run of anything else but white space); white space between
    matches is skipped."""
    out, i, n = [], 0, len(text)
    while i < n:
        head = next((s for s in SPECIALS + CONTRACTIONS if text.startswith(s, i)), None)
        if head is not None:
            j = i + len(head)
        elif _is_letter(text[i]):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(text[i]):
            j = i + 1
        elif not _is_space(text[i]):
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def _read_merges(bpe_path) -> list[str]:
    data = Path(bpe_path).read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data.decode("utf-8").split("\n")


class CLIPTokenizer:
    """Byte-level BPE with end-of-word markers, CLIP's vocabulary layout:
    256 byte characters, the same with ``</w>``, the merges (at most
    48,894), then the start and end tokens."""

    def __init__(self, bpe_path: str | Path):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = _read_merges(bpe_path)
        # line 0 is a version header; CLIP keeps merges up to vocab 49152-256-2
        merges = [tuple(m.split()) for m in raw[1: 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(SPECIALS)
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {s: s for s in SPECIALS}
        self.sot, self.eot = (self.encoder[s] for s in SPECIALS)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in scan_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77, truncate: bool = True) -> np.ndarray:
        """list[str] → (N, context_length) int32 (``clip.tokenize``)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
