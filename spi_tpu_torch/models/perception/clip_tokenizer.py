"""Byte-pair-encoding tokenizer for CLIP text prompts (a copy of
spi_tpu/models/perception/clip_tokenizer.py, which the port does not
import; tests hold the two to the same tokens).

Behavioral spec: the `clip.simple_tokenizer.SimpleTokenizer` the
reference calls through `clip.tokenize` (ZSSGAN/criteria/clip_loss.py:
74-75,100). The merges file (`bpe_simple_vocab_16e6.txt.gz`) ships with
every CLIP release; pass its path to `Tokenizer`. Host-side Python with
stdlib `re` and `gzip`: tokenization happens once per prompt set.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode-char table (GPT-2 scheme)."""
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


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


class Tokenizer:
    """BPE tokenizer; `bpe_path` points at bpe_simple_vocab_16e6.txt.gz."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # The upstream pattern uses \p{L}/\p{N} (regex module); stdlib
        # `re` equivalent below covers unicode letters via \w minus digits.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\W\d_]+|[0-9]|[^\s\w]+",
            re.IGNORECASE | re.UNICODE,
        )

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77) -> np.ndarray:
        """texts: str or list[str] -> (N, context_length) int32 array with
        SOT/EOT wrapping and zero padding (clip.tokenize semantics;
        over-long prompts are truncated with EOT preserved)."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [sot] + self.encode(text) + [eot]
            if len(tokens) > context_length:
                tokens = tokens[: context_length - 1] + [eot]
            result[i, : len(tokens)] = tokens
        return result
