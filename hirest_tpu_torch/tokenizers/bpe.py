"""CLIP byte-pair-encoding tokenizer (pure Python, NumPy output).

An own copy of hirest_tpu/tokenizers/bpe.py (the port imports nothing of the JAX package).

Implements the standard OpenAI CLIP BPE scheme (Radford et al. 2021) used by
the EVA-CLIP text tower: byte-to-unicode mapping, lowercasing + basic-clean,
word-final `</w>` markers, 48,894 merges, and the
`<|startoftext|>`/`<|endoftext|>` specials, for a 49,408-token vocabulary.
Reference surface: EVA_clip/clip.py:196-232 (`tokenize`) and
EVA_clip/simple_tokenizer.py.

The merges table ships as `assets/bpe_simple_vocab_16e6.txt.gz` (public
OpenAI CLIP vocabulary data).

Attribution: the merge loop and vocab construction follow the canonical
OpenAI CLIP `SimpleTokenizer` algorithm (github.com/openai/CLIP,
simple_tokenizer.py, MIT license) — byte-exact token-id parity requires the
published merge order and the `49152-256-2+1` vocab layout; the word-split
regex here is an independent stdlib-`re` derivation.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re

import numpy as np

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "bpe_simple_vocab_16e6.txt.gz",
)

def _compile_word_pattern():
    # The canonical CLIP pattern uses \p{L}/\p{N} (simple_tokenizer.py via
    # the `regex` module — ships with `transformers`); prefer it for exact
    # parity. stdlib-`re` fallback: letters -> [^\W\d_], numbers -> \d, and
    # the punctuation branch must explicitly include '_' ([^\s\w] excludes
    # it since _ is a word char) or underscores silently VANISH from the
    # token stream instead of tokenizing as punctuation.
    try:
        import regex

        return regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE)
    except ImportError:
        return re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE | re.UNICODE,
        )


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """Reversible mapping from bytes to printable unicode chars (GPT-2 scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in merge_lines[1: 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = _compile_word_pattern()

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipBPETokenizer:
    return ClipBPETokenizer()


def clip_tokenize(texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
    """Batch-tokenize to a fixed [N, context_length] int32 array.

    Same semantics as reference EVA_clip/clip.py:196-232: SOT + tokens + EOT,
    zero padding, raise on overflow unless `truncate` (which keeps EOT last).
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tok.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
        result[i, : len(tokens)] = tokens
    return result
