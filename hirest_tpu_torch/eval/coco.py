"""Pure-Python COCO-style caption metrics: BLEU, ROUGE-L, CIDEr.

A copy of hirest_tpu/eval/coco.py: the port imports nothing of the JAX
package.

The reference scores step captions through `language_evaluation.CocoEvaluator`
(reference evaluate.py:299-301), which wraps the Java/C coco-caption
scorers. This module re-implements the published formulas in NumPy-free pure
Python so the framework has no JVM or external-binary dependency:

- BLEU-1..4: corpus-level, "closest" reference-length brevity penalty
  (Papineni et al. 2002, as configured by coco-caption).
- ROUGE-L: LCS-based F-measure with beta = 1.2, averaged over pairs
  (Lin 2004, coco-caption configuration).
- CIDEr: TF-IDF weighted n-gram cosine, n = 1..4, sigma = 6.0
  (Vedantam et al. 2015).
- METEOR: pure-Python exact+stem alignment scorer (hirest_tpu_torch.eval.meteor;
  see its docstring for the documented deviations from the METEOR-1.5 jar).

SPICE requires the Java scene-graph parser in the original; it is exposed
as an optional hook (`spice_fn`) and reported as absent rather than
silently zero.

Tokenization: the coco-caption pipeline first runs the PTB tokenizer
(lowercase + punctuation stripping); `tokenize()` reproduces that effect for
ordinary caption text.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict

_PUNCT = re.compile(r"[^\w\s]")
_WS = re.compile(r"\s+")


def tokenize(text: str) -> list[str]:
    text = text.lower()
    text = _PUNCT.sub(" ", text)
    return _WS.sub(" ", text).strip().split()


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def bleu(candidates: list[str], references: list[list[str]], max_n: int = 4) -> list[float]:
    """Corpus BLEU-1..max_n with closest-length brevity penalty."""
    assert len(candidates) == len(references)
    clipped = [0.0] * max_n
    totals = [0.0] * max_n
    cand_len = 0
    ref_len = 0

    for cand, refs in zip(candidates, references):
        c = tokenize(cand)
        rs = [tokenize(r) for r in refs]
        cand_len += len(c)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            c_ngrams = _ngrams(c, n)
            max_ref = Counter()
            for r in rs:
                for g, cnt in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in c_ngrams.items())
            totals[n - 1] += max(0, len(c) - n + 1)

    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    scores = []
    log_sum = 0.0
    tiny, small = 1e-15, 1e-9  # coco-caption's smoothing constants
    for n in range(1, max_n + 1):
        p_n = (clipped[n - 1] + tiny) / (totals[n - 1] + small)
        log_sum += math.log(p_n)
        scores.append(bp * math.exp(log_sum / n))
    return scores


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(candidates: list[str], references: list[list[str]], beta: float = 1.2) -> float:
    """Mean ROUGE-L F over pairs (max over multiple references)."""
    scores = []
    for cand, refs in zip(candidates, references):
        c = tokenize(cand)
        best = 0.0
        for ref in refs:
            r = tokenize(ref)
            lcs = _lcs_len(c, r)
            if lcs == 0 or not c or not r:
                continue
            prec = lcs / len(c)
            rec = lcs / len(r)
            f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
            best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------


def cider(candidates: list[str], references: list[list[str]],
          max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D style TF-IDF n-gram cosine (length-penalized), scaled x10."""
    assert len(candidates) == len(references)
    num_docs = len(references)

    # document frequency over reference sets
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    ref_ngrams = []
    for refs in references:
        per_ref = [[_ngrams(tokenize(r), n + 1) for n in range(max_n)] for r in refs]
        ref_ngrams.append(per_ref)
        for n in range(max_n):
            seen = set()
            for counters in per_ref:
                seen |= set(counters[n].keys())
            for g in seen:
                doc_freq[n][g] += 1

    def tfidf_vec(counters: list[Counter]):
        vecs, norms, lengths = [], [], 0
        for n in range(max_n):
            vec = {}
            norm = 0.0
            for g, cnt in counters[n].items():
                df = math.log(max(1.0, doc_freq[n][g]))
                w = cnt * (math.log(num_docs) - df)
                vec[g] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms

    scores = []
    for cand, refs, per_ref in zip(candidates, references, ref_ngrams):
        c_tokens = tokenize(cand)
        c_counters = [_ngrams(c_tokens, n + 1) for n in range(max_n)]
        c_vecs, c_norms = tfidf_vec(c_counters)
        cand_score = 0.0
        for ref, r_counters in zip(refs, per_ref):
            r_tokens = tokenize(ref)
            r_vecs, r_norms = tfidf_vec(r_counters)
            pair = 0.0
            for n in range(max_n):
                num = 0.0
                for g, w in c_vecs[n].items():
                    # CIDEr-D clips candidate counts to reference counts
                    num += min(w, r_vecs[n].get(g, 0.0)) * r_vecs[n].get(g, 0.0)
                denom = c_norms[n] * r_norms[n]
                s = num / denom if denom > 0 else 0.0
                delta = len(c_tokens) - len(r_tokens)
                s *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                pair += s * 10.0
            pair /= max_n
            cand_score += pair
        scores.append(cand_score / len(refs))
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# Composite evaluator (the CocoEvaluator surface used by the reference)
# ---------------------------------------------------------------------------


class CocoEvaluator:
    """Same call surface as language_evaluation.CocoEvaluator.run_evaluation:
    takes flat candidate/reference string lists, returns {metric: score}."""

    def __init__(self, coco_types=("BLEU", "METEOR", "ROUGE_L", "CIDEr"),
                 spice_fn=None, meteor_version="1.5", meteor_kwargs=None):
        self.coco_types = coco_types
        self.spice_fn = spice_fn
        # "1.5" scores with the METEOR-1.5 English model (the reference
        # jar's parameterization; see eval/meteor.py); meteor_kwargs can
        # inject the synonym/paraphrase data sources (synonyms=,
        # paraphrases=) when a WordNet db / paraphrase table is available
        self.meteor_version = meteor_version
        self.meteor_kwargs = meteor_kwargs or {}

    def run_evaluation(self, candidates: list[str], references: list[str]) -> dict:
        refs = [[r] if isinstance(r, str) else list(r) for r in references]
        results = {}
        if "BLEU" in self.coco_types:
            b = bleu(candidates, refs)
            for i, s in enumerate(b, 1):
                results[f"Bleu_{i}"] = s
        if "METEOR" in self.coco_types:
            from hirest_tpu_torch.eval.meteor import meteor
            results["METEOR"] = meteor(
                [tokenize(c) for c in candidates],
                [[tokenize(r) for r in rs] for rs in refs],
                version=self.meteor_version, **self.meteor_kwargs)
        if "ROUGE_L" in self.coco_types:
            results["ROUGE_L"] = rouge_l(candidates, refs)
        if "CIDEr" in self.coco_types:
            results["CIDEr"] = cider(candidates, refs)
        if "SPICE" in self.coco_types and self.spice_fn is not None:
            results["SPICE"] = self.spice_fn(candidates, refs)
        return results
