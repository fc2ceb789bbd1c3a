"""GPT-2 byte-level BPE — the Whisper English tokenizer.

An own copy of hirest_tpu/tokenizers/gpt2_bpe.py, byte for byte in what it
computes (the port imports nothing of the JAX package).

Implements the canonical byte-level BPE algorithm published by OpenAI
(gpt-2/src/encoder.py; also the tokenizer behind Whisper's *.en models,
reference extraction/whisper_ASR/extract_ASR.py relies on it via the
`whisper` package). The vocab/merges DATA is not derivable, so it loads
the standard HuggingFace asset pair (`vocab.json` + `merges.txt`) that
ships alongside every HF whisper checkpoint — the same files a user must
already have to supply decoder weights. No `whisper`/`tiktoken` import.

Special tokens for the `.en` models (public constants; base GPT-2 vocab is
ids 0..50256 with <|endoftext|> at 50256, then):
  <|startoftranscript|> 50257, 99 language tokens 50258..50356,
  <|translate|> 50357, <|transcribe|> 50358, <|startoflm|> 50359,
  <|startofprev|> 50360, <|nospeech|> 50361, <|notimestamps|> 50362,
  timestamps <|0.00|>..<|30.00|> at 50363..51863 (vocab size 51864).
"""

from __future__ import annotations

import json
from functools import lru_cache


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """The canonical GPT-2 reversible byte <-> unicode mapping: printable
    latin-1 bytes map to themselves, the rest shift into 256+."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class Gpt2BpeTokenizer:
    """Byte-level BPE over an HF vocab.json/merges.txt pair."""

    # the canonical GPT-2 pre-tokenization pattern (exact, via the `regex`
    # module's \p{L}/\p{N} classes — ships with `transformers`)
    _PAT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
            r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
    # `re` fallback: [^\W\d_] ~ \p{L} (underscore must then be matched by
    # the punctuation branch, hence the explicit |_), \d ~ \p{N} minus
    # No/Nl numerics — a documented approximation only used without `regex`.
    _PAT_RE = (r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+"
               r"| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+")

    def __init__(self, vocab_path: str, merges_path: str):

        with open(vocab_path, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                merges.append(tuple(line.split()))
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        try:
            import regex
            self.pat = regex.compile(self._PAT)
        except ImportError:
            import re
            self.pat = re.compile(self._PAT_RE)
        self.cache: dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
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
                if i < len(word) - 1 and word[i + 1] == second:
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
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) in self.decoder)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")


class WhisperEnTokenizer:
    """Whisper `.en` tokenizer surface over the GPT-2 BPE: text encode /
    decode plus the special-token constants and the non-speech token set
    used by the decoding rules (suppress_tokens='-1')."""

    EOT = 50256
    SOT = 50257
    TRANSLATE = 50357
    TRANSCRIBE = 50358
    SOT_LM = 50359
    SOT_PREV = 50360
    NO_SPEECH = 50361          # <|nospeech|> / <|nocaptions|>
    NO_TIMESTAMPS = 50362
    TIMESTAMP_BEGIN = 50363
    TIME_PRECISION = 0.02

    def __init__(self, vocab_path: str, merges_path: str):
        self.bpe = Gpt2BpeTokenizer(vocab_path, merges_path)

    def encode(self, text: str) -> list[int]:
        return self.bpe.encode(text)

    def decode(self, ids) -> str:
        return self.bpe.decode([i for i in ids if int(i) < self.EOT])

    def non_speech_tokens(self) -> list[int]:
        """Token ids suppressed by suppress_tokens='-1': symbols that never
        occur in real speech transcripts. Follows the published whisper
        algorithm: a symbol contributes its encoding (bare and
        space-prefixed) when it encodes to a single token; musical-notation
        symbols contribute their first token unconditionally; ' -' and
        \" '\" contribute their first tokens."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ "
            "♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for text in (" -", " '"):
            try:
                result.add(self.encode(text)[0])
            except KeyError:  # incomplete (test) vocab
                pass
        for symbol in symbols + list(miscellaneous):
            for text in (symbol, " " + symbol):
                try:
                    tokens = self.encode(text)
                except KeyError:  # incomplete (test) vocab
                    continue
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return sorted(result)

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.TIMESTAMP_BEGIN) * self.TIME_PRECISION
