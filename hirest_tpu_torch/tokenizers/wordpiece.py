"""BERT WordPiece tokenizer (pure Python).

An own copy of hirest_tpu/tokenizers/wordpiece.py (the port imports nothing of the JAX package).

Implements the standard BERT basic+wordpiece tokenization pipeline
(Devlin et al. 2018) used by the caption decoder: unicode cleanup, CJK
spacing, lowercasing + accent stripping, punctuation splitting, then greedy
longest-match-first subword segmentation with "##" continuations.
Reference surface: clip4caption/modules/tokenization.py (BertTokenizer).

The 30,522-entry `bert-base-uncased` vocab file is NOT vendored (the
reference downloads it at runtime); pass its path explicitly or place
`vocab.txt` in the pretrained-weights directory.

Attribution: the cleaning/splitting rules and greedy longest-match-first
loop follow the canonical Google BERT `tokenization.py` algorithm
(github.com/google-research/bert, Apache-2.0) — token-id parity with BERT
checkpoints requires the published behavior exactly.
"""

from __future__ import annotations

import os
import unicodedata


def load_vocab(vocab_file: str) -> dict:
    vocab = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for index, line in enumerate(f):
            token = line.rstrip("\n")
            if not token and index > 0:
                continue
            vocab[token] = index
    return vocab


def _is_whitespace(char: str) -> bool:
    if char in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(char) == "Zs"


def _is_control(char: str) -> bool:
    if char in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(char).startswith("C")


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(char).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> list[str]:
        text = self._clean_text(text)
        text = self._tokenize_chinese_chars(text)
        orig_tokens = text.strip().split()
        split_tokens: list[str] = []
        for token in orig_tokens:
            if self.do_lower_case:
                token = token.lower()
                token = self._strip_accents(token)
            split_tokens.extend(self._split_on_punc(token))
        return " ".join(split_tokens).strip().split()

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(c for c in text if unicodedata.category(c) != "Mn")

    @staticmethod
    def _split_on_punc(text: str) -> list[str]:
        output: list[list[str]] = []
        start_new_word = True
        for char in text:
            if _is_punctuation(char):
                output.append([char])
                start_new_word = True
            else:
                if start_new_word:
                    output.append([])
                start_new_word = False
                output[-1].append(char)
        return ["".join(x) for x in output]

    @staticmethod
    def _tokenize_chinese_chars(text: str) -> str:
        out = []
        for char in text:
            if _is_cjk(ord(char)):
                out.append(f" {char} ")
            else:
                out.append(char)
        return "".join(out)

    @staticmethod
    def _clean_text(text: str) -> str:
        out = []
        for char in text:
            cp = ord(char)
            if cp == 0 or cp == 0xFFFD or _is_control(char):
                continue
            out.append(" " if _is_whitespace(char) else char)
        return "".join(out)


class WordPieceTokenizer:
    """BertTokenizer-compatible surface: tokenize / convert_tokens_to_ids /
    convert_ids_to_tokens / vocab."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 max_input_chars_per_word: int = 100, unk_token: str = "[UNK]"):
        if not os.path.isfile(vocab_file):
            raise FileNotFoundError(
                f"WordPiece vocab not found at {vocab_file}; supply the "
                "bert-base-uncased vocab.txt (30522 entries)")
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.basic = BasicTokenizer(do_lower_case=do_lower_case)
        self.max_input_chars_per_word = max_input_chars_per_word
        self.unk_token = unk_token

    @classmethod
    def from_pretrained(cls, path: str, do_lower_case: bool = True) -> "WordPieceTokenizer":
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        return cls(path, do_lower_case=do_lower_case)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, token: str) -> list[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        chars = list(token)
        sub_tokens: list[str] = []
        start = 0
        while start < len(chars):
            end = len(chars)
            cur = None
            while start < end:
                substr = "".join(chars[start:end])
                if start > 0:
                    substr = "##" + substr
                if substr in self.vocab:
                    cur = substr
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            sub_tokens.append(cur)
            start = end
        return sub_tokens

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for token in self.basic.tokenize(text):
            out.extend(self._wordpiece(token))
        return out

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        # ids outside the vocab (e.g. decoding with a truncated dev vocab)
        # map to [UNK] instead of raising
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]


def detokenize_caption(tokens: list[str]) -> str:
    """WordPiece detokenization with the reference's exact post-processing
    (modeling.py:615-626): cut at [SEP] / [PAD], join, merge "##" pieces."""
    if "[SEP]" in tokens:
        tokens = tokens[: tokens.index("[SEP]")]
    if "[PAD]" in tokens:
        tokens = tokens[: tokens.index("[PAD]")]
    text = " ".join(tokens)
    return text.replace(" ##", "").strip("##").strip()
