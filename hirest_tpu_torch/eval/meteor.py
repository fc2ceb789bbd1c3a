"""Pure-Python METEOR for step-caption scoring.

A copy of hirest_tpu/eval/meteor.py: the port imports nothing of the JAX
package.

The reference's `language_evaluation.CocoEvaluator()` default metric set
includes METEOR (reference evaluate.py:299-301), scored by the Java
METEOR-1.5 jar in coco-caption. This module provides a dependency-free
METEOR so the framework's CocoEvaluator reports the full metric family:

- Alignment: exact-match stage, then Porter-stem stage on the residue,
  each matching every hypothesis word (scanned from the end) to the latest
  still-unused reference word — the published METEOR unigram-alignment
  order as standardized by NLTK's `meteor_score` (Banerjee & Lavie 2005).
- Score: fmean = P*R / (alpha*P + (1-alpha)*R), fragmentation penalty
  gamma * (chunks/matches)^beta, sentence score (1-penalty)*fmean, max over
  references, corpus score = mean over sentences (alpha=0.9, beta=3,
  gamma=0.5).

Two scoring models:

- version="2005" (default): original Banerjee & Lavie parameters
  (alpha=.9, beta=3, gamma=.5), max-over-references, arithmetic-mean
  corpus aggregation. Golden parity with `nltk.translate.meteor_score`
  (WordNet stage disabled) is asserted in tests/test_meteor.py.
- version="1.5": the METEOR-1.5 English scoring model (meteor_15 below):
  tuned parameters alpha=.85 beta=.2 gamma=.6 delta=.75, module weights,
  function-word discounting, pooled-corpus-statistics aggregation.

Documented deviation from the METEOR-1.5 jar in both modes (the jar needs
a JVM plus ~60 MB synonym/paraphrase tables, which the repository does not
carry): no WordNet-synonym or paraphrase match stages by default, so scores
lower-bound the jar's.

Measured version delta on a 5-sentence caption sample (tests/test_meteor.py
cases): corpus 2005 = 0.7746 vs corpus 1.5 = 0.3762 — the two
parameterizations are NOT interchangeable; compare numbers only within one
mode. The 1.5 sentence formula with delta=0.5 and unit module weights is
cross-checked to 1e-12 against nltk at alpha=.85/beta=.2/gamma=.6.

The stemmer is an independent implementation of the canonical Porter (1980)
algorithm — no Martin/NLTK extension rules — so scores are reproducible
without nltk installed.
"""

from __future__ import annotations

_VOWELS = "aeiou"


def _is_consonant(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return True if i == 0 else not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """m in the [C](VC)^m[V] decomposition of the stem."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_consonant(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    return (len(word) >= 3
            and _is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in "wxy")


def _apply_rules(word: str, rules) -> str:
    """First rule whose suffix matches fires (or blocks, if its condition
    fails) — Porter's 'longest match in the step' convention is encoded by
    rule order."""
    for suffix, replacement, condition in rules:
        if suffix == "*d":
            if _ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        elif word.endswith(suffix):
            stem = word[: len(word) - len(suffix)]
            if condition is None or condition(stem):
                return stem + replacement
            return word
    return word


def porter_stem(word: str) -> str:
    """Canonical Porter (1980) stemmer, lowercased input assumed."""
    w = word

    # Step 1a
    w = _apply_rules(w, [("sses", "ss", None), ("ies", "i", None),
                         ("ss", "ss", None), ("s", "", None)])

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        rule_fired = False
        if w.endswith("ed") and _contains_vowel(w[:-2]):
            w, rule_fired = w[:-2], True
        elif w.endswith("ing") and _contains_vowel(w[:-3]):
            w, rule_fired = w[:-3], True
        if rule_fired:
            if w.endswith(("at", "bl", "iz")):
                w = w + "e"
            elif _ends_double_consonant(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w = w + "e"

    # Step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2 (original-paper rule list: abli -> able, no logi rule)
    m_pos = lambda stem: _measure(stem) > 0
    w = _apply_rules(w, [
        ("ational", "ate", m_pos), ("tional", "tion", m_pos),
        ("enci", "ence", m_pos), ("anci", "ance", m_pos),
        ("izer", "ize", m_pos), ("abli", "able", m_pos),
        ("alli", "al", m_pos), ("entli", "ent", m_pos),
        ("eli", "e", m_pos), ("ousli", "ous", m_pos),
        ("ization", "ize", m_pos), ("ation", "ate", m_pos),
        ("ator", "ate", m_pos), ("alism", "al", m_pos),
        ("iveness", "ive", m_pos), ("fulness", "ful", m_pos),
        ("ousness", "ous", m_pos), ("aliti", "al", m_pos),
        ("iviti", "ive", m_pos), ("biliti", "ble", m_pos),
    ])

    # Step 3
    w = _apply_rules(w, [
        ("icate", "ic", m_pos), ("ative", "", m_pos), ("alize", "al", m_pos),
        ("iciti", "ic", m_pos), ("ical", "ic", m_pos), ("ful", "", m_pos),
        ("ness", "", m_pos),
    ])

    # Step 4
    m_gt1 = lambda stem: _measure(stem) > 1
    w = _apply_rules(w, [
        ("al", "", m_gt1), ("ance", "", m_gt1), ("ence", "", m_gt1),
        ("er", "", m_gt1), ("ic", "", m_gt1), ("able", "", m_gt1),
        ("ible", "", m_gt1), ("ant", "", m_gt1), ("ement", "", m_gt1),
        ("ment", "", m_gt1), ("ent", "", m_gt1),
        ("ion", "", lambda stem: _measure(stem) > 1 and stem[-1:] in ("s", "t")),
        ("ou", "", m_gt1), ("ism", "", m_gt1), ("ate", "", m_gt1),
        ("iti", "", m_gt1), ("ous", "", m_gt1), ("ive", "", m_gt1),
        ("ize", "", m_gt1),
    ])

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w[:-1]) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]

    return w


# ---------------------------------------------------------------------------
# Alignment + score
# ---------------------------------------------------------------------------


def _stage_match(hyp, ref, key):
    """Match each remaining hypothesis word (scanned from the END) to the
    latest unused reference word with equal key. hyp/ref are lists of
    (original_index, word); returns (matches, hyp_rest, ref_rest)."""
    positions: dict[str, list[int]] = {}
    for j, (_, rw) in enumerate(ref):
        positions.setdefault(key(rw), []).append(j)

    matches = []
    used_h, used_r = set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        avail = positions.get(key(hyp[i][1]))
        if avail:
            j = avail.pop()
            used_h.add(i)
            used_r.add(j)
            matches.append((hyp[i][0], ref[j][0]))
    hyp_rest = [p for i, p in enumerate(hyp) if i not in used_h]
    ref_rest = [p for j, p in enumerate(ref) if j not in used_r]
    return matches, hyp_rest, ref_rest


def _stage_match_pred(hyp, ref, pred):
    """Predicate variant of _stage_match (synonym stage): match each
    remaining hypothesis word (scanned from the END) to the latest unused
    reference word with pred(h_word, r_word) true."""
    matches = []
    used_h, used_r = set(), set()
    for i in range(len(hyp) - 1, -1, -1):
        for j in range(len(ref) - 1, -1, -1):
            if j not in used_r and pred(hyp[i][1], ref[j][1]):
                used_h.add(i)
                used_r.add(j)
                matches.append((hyp[i][0], ref[j][0]))
                break
    hyp_rest = [p for i, p in enumerate(hyp) if i not in used_h]
    ref_rest = [p for j, p in enumerate(ref) if j not in used_r]
    return matches, hyp_rest, ref_rest


def _spans(rest, max_len):
    """Contiguous-in-the-original-sentence spans of a residue list of
    (orig_index, word), longest first (down to single words — the jar's
    paraphrase table pairs phrases of any length incl. 1):
    [(start_offset, length), ...]."""
    out = []
    for ln in range(max_len, 0, -1):
        for a in range(len(rest) - ln + 1):
            idxs = [rest[a + k][0] for k in range(ln)]
            if idxs[-1] - idxs[0] == ln - 1:
                out.append((a, ln))
    return out


def _stage_match_phrases(hyp, ref, table, max_len=4):
    """Paraphrase stage: greedily match unmatched contiguous spans
    (longest-first) whose (hyp_phrase, ref_phrase) word-tuple pair is in
    `table` (a set/dict of phrase-tuple pairs, or a callable
    (h_phrase, r_phrase) -> bool). Returns span matches as
    (h_indices, r_indices) tuples plus the residues."""
    hit = table if callable(table) else (lambda a, b: (a, b) in table)
    matches = []
    used_h, used_r = set(), set()
    ref_spans = list(_spans(ref, max_len))
    for a, hl in _spans(hyp, max_len):
        if any(a + k in used_h for k in range(hl)):
            continue
        h_words = tuple(hyp[a + k][1] for k in range(hl))
        for b, rl in ref_spans:
            if any(b + k in used_r for k in range(rl)):
                continue
            if hit(h_words, tuple(ref[b + k][1] for k in range(rl))):
                used_h.update(a + k for k in range(hl))
                used_r.update(b + k for k in range(rl))
                matches.append((tuple(hyp[a + k][0] for k in range(hl)),
                                tuple(ref[b + k][0] for k in range(rl))))
                break
    hyp_rest = [p for i, p in enumerate(hyp) if i not in used_h]
    ref_rest = [p for j, p in enumerate(ref) if j not in used_r]
    return matches, hyp_rest, ref_rest


def align_modules_full(hyp_tokens: list[str], ref_tokens: list[str],
                       synonyms=None, paraphrases=None):
    """All four METEOR matcher stages on successive residues; returns
    span-match triples (h_indices, r_indices, module) sorted by first
    hypothesis index. Module numbering per the jar: 0 = exact, 1 = stem,
    2 = synonym, 3 = paraphrase. Modules 0-2 emit single-word spans.

    synonyms: optional word -> set-of-synset-ids lookup (the jar uses
    WordNet; the repository ships no WordNet db, so the source is
    injectable — two words match when their synset sets intersect).
    paraphrases: optional phrase-pair table for _stage_match_phrases (the
    jar's paraphrase-en.gz is likewise not redistributable)."""
    hyp = list(enumerate(hyp_tokens))
    ref = list(enumerate(ref_tokens))
    exact, hyp, ref = _stage_match(hyp, ref, lambda w: w)
    stemmed, hyp, ref = _stage_match(hyp, ref, porter_stem)
    out = ([((h,), (r,), 0) for h, r in exact]
           + [((h,), (r,), 1) for h, r in stemmed])
    if synonyms is not None:
        syn, hyp, ref = _stage_match_pred(
            hyp, ref, lambda a, b: bool(synonyms(a) & synonyms(b)))
        out += [((h,), (r,), 2) for h, r in syn]
    if paraphrases is not None:
        para, hyp, ref = _stage_match_phrases(hyp, ref, paraphrases)
        out += [(hs, rs, 3) for hs, rs in para]
    return sorted(out)


def align_modules(hyp_tokens: list[str], ref_tokens: list[str]):
    """Exact stage then Porter-stem stage on the residue; returns
    (hyp_index, ref_index, module) triples sorted by hypothesis index,
    module 0 = exact, 1 = stem (METEOR's module numbering)."""
    return [(hs[0], rs[0], m)
            for hs, rs, m in align_modules_full(hyp_tokens, ref_tokens)]


def align(hyp_tokens: list[str], ref_tokens: list[str]):
    """Exact stage then Porter-stem stage; matches sorted by hypothesis
    index, as METEOR's unigram aligner produces them."""
    return [(h, r) for h, r, _ in align_modules(hyp_tokens, ref_tokens)]


def _count_chunks(matches) -> int:
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0] == a[0] + 1 and b[1] == a[1] + 1):
            chunks += 1
    return chunks


def meteor_single(hyp_tokens: list[str], ref_tokens: list[str],
                  alpha: float = 0.9, beta: float = 3.0,
                  gamma: float = 0.5) -> float:
    hyp = [t.lower() for t in hyp_tokens]
    ref = [t.lower() for t in ref_tokens]
    matches = align(hyp, ref)
    m = len(matches)
    if m == 0 or not hyp or not ref:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = (precision * recall) / (alpha * precision + (1 - alpha) * recall)
    penalty = gamma * (_count_chunks(matches) / m) ** beta
    return (1 - penalty) * fmean


def _check_tokenized(candidates, references):
    """Reject untokenized input: a plain string where a token list is
    expected silently scores ~0 (the whole sentence becomes one "token" —
    verified failure mode: meteor([['sent']], ['sent']) -> 0.0). The
    evaluator tokenizes correctly (eval/coco.py); this guards any future
    direct caller of the parity-critical metric."""
    for c in candidates:
        if isinstance(c, str):
            raise TypeError(
                f"meteor candidates must be token lists, got str {c!r} — "
                f"tokenize first (e.g. hirest_tpu_torch.eval.coco.tokenize)")
    for refs in references:
        if isinstance(refs, str):
            raise TypeError(
                f"meteor references must be LISTS of token lists per "
                f"candidate, got str {refs!r} — tokenize first")
        for r in refs:
            if isinstance(r, str):
                raise TypeError(
                    f"each meteor reference must be a token list, got str "
                    f"{r!r} — tokenize first")


def meteor(candidates: list[list[str]], references: list[list[list[str]]],
           alpha: float = None, beta: float = None, gamma: float = None,
           version: str = "2005", **kw) -> float:
    """Corpus METEOR.

    version="2005" (default): per-sentence max over references, arithmetic
    mean, original-paper parameters (alpha=0.9, beta=3.0, gamma=0.5) —
    nltk-parity (tests/test_meteor.py).

    version="1.5": the METEOR-1.5 English scoring model (see meteor_15).
    alpha/beta/gamma are version-specific: left unset, each version uses
    its own tuned defaults; set explicitly, they are forwarded to the
    selected version. 1.5-only options (delta/weights/synonyms/
    paraphrases) are rejected under version="2005" rather than silently
    dropped.
    """
    if version == "1.5":
        kw.update({k: v for k, v in
                   (("alpha", alpha), ("beta", beta), ("gamma", gamma))
                   if v is not None})
        return meteor_15(candidates, references, **kw)
    if version != "2005":
        # the two models differ ~2x on the same corpus — a typo silently
        # scored on the wrong scale is worse than an error
        raise ValueError(f"unknown METEOR version {version!r}: "
                         f"use '2005' or '1.5'")
    if kw:
        raise TypeError(
            f"meteor(version={version!r}) got METEOR-1.5-only options "
            f"{sorted(kw)} — pass version='1.5' to use them")
    alpha = 0.9 if alpha is None else alpha
    beta = 3.0 if beta is None else beta
    gamma = 0.5 if gamma is None else gamma
    _check_tokenized(candidates, references)
    assert len(candidates) == len(references)
    if not candidates:
        return 0.0
    total = 0.0
    for cand, refs in zip(candidates, references):
        total += max(meteor_single(cand, r, alpha, beta, gamma) for r in refs)
    return total / len(candidates)


# ---------------------------------------------------------------------------
# METEOR 1.5 (Denkowski & Lavie 2014, "Meteor Universal") — the scoring
# model of the meteor-1.5.jar the reference runs via language_evaluation's
# coco-caption (reference evaluate.py:299-301).
# ---------------------------------------------------------------------------
#
# English task tuning: alpha=.85 beta=.2 gamma=.6 delta=.75, module weights
# exact 1.0 / stem 0.6 (/ synonym 0.8 / paraphrase 0.6 — those two stages
# need WordNet + a 60 MB paraphrase table and are a documented deviation:
# this implementation runs exact+stem only, so its scores lower-bound the
# jar's). Differences from the 2005 model implemented above:
#   * content/function word weighting: a matched or counted content word
#     contributes delta, a function word (1-delta), to both the match
#     numerators and the length denominators;
#   * module weights scale each match's contribution;
#   * corpus score = pooled sufficient statistics (micro-average) over the
#     best-scoring reference per segment, NOT a mean of sentence scores.

# Module weights (exact, stem, synonym, paraphrase) — the jar's English
# defaults. Synonym/paraphrase stages only fire when a data source is
# injected (meteor_15 synonyms=/paraphrases=); neither WordNet nor
# paraphrase-en.gz ships with the repository.
METEOR15_EN = {"alpha": 0.85, "beta": 0.2, "gamma": 0.6, "delta": 0.75,
               "weights": (1.0, 0.6, 0.8, 0.6)}

# Approximation of the jar's frequency-derived `function.words` list (words
# with relative frequency > 1e-3 in its news corpus) : the closed-class
# English words plus punctuation. The exact file is not
# redistributable; deviations only reweight (never add/remove) matches.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both few many
much more most other another such same own
i me my mine myself we us our ours ourselves you your yours yourself
yourselves he him his himself she her hers herself it its itself they them
their theirs themselves who whom whose which what where when why how
and or but nor so yet for if because although though while whereas unless
until since as than whether once
in on at by with from into onto of to over under above below between among
through during before after behind beside besides against about around
across along near off out up down upon within without toward towards
be am is are was were been being do does did doing have has had having
will would shall should can could may might must ought need
not never also just only even still too very quite rather almost always
often sometimes again then there here now
's 't 'll 've 're 'd 'm n't
. , ; : ! ? ' " ` `` '' ( ) [ ] { } - -- ... &
""".split())


def _count_chunks_spans(matches) -> int:
    """Chunk count over span matches (hs, rs, mod) sorted by hs[0]: a new
    chunk starts whenever the next match is not contiguous on BOTH sides."""
    chunks = 1
    for a, b in zip(matches, matches[1:]):
        if not (b[0][0] == a[0][-1] + 1 and b[1][0] == a[1][-1] + 1):
            chunks += 1
    return chunks


def _stats_15(hyp, ref, delta, weights, synonyms=None, paraphrases=None):
    """Sufficient statistics for one segment (MeteorStats).

    delta weights CONTENT words; function words carry 1-delta (Meteor
    Universal eq. for P/R: delta*m(h_c) + (1-delta)*m(h_f) over
    delta*|h_c| + (1-delta)*|h_f|) — with the English delta=.75 a
    function-word match recovers less weighted mass than a content match.
    Paraphrase matches can cover different word counts per side, so the
    fragmentation `matches` total is the AVERAGE of covered hypothesis and
    reference words (Denkowski & Lavie 2014, m = mean matched words)."""
    matches = align_modules_full(hyp, ref, synonyms, paraphrases)
    wf = lambda w: (1.0 - delta) if w in FUNCTION_WORDS else delta
    return {
        "p_num": sum(weights[mod] * sum(wf(hyp[h]) for h in hs)
                     for hs, _, mod in matches),
        "r_num": sum(weights[mod] * sum(wf(ref[r]) for r in rs)
                     for _, rs, mod in matches),
        "p_den": sum(wf(w) for w in hyp),
        "r_den": sum(wf(w) for w in ref),
        "matches": 0.5 * (sum(len(hs) for hs, _, _ in matches)
                          + sum(len(rs) for _, rs, _ in matches)),
        "chunks": _count_chunks_spans(matches) if matches else 0,
    }


def _score_15(s, alpha, beta, gamma):
    if s["matches"] == 0 or s["p_den"] == 0 or s["r_den"] == 0:
        return 0.0
    precision = s["p_num"] / s["p_den"]
    recall = s["r_num"] / s["r_den"]
    denom = alpha * precision + (1 - alpha) * recall
    if denom == 0:
        return 0.0
    fmean = precision * recall / denom
    frag = s["chunks"] / s["matches"]
    return fmean * (1.0 - gamma * frag ** beta)


def meteor_15(candidates: list[list[str]], references: list[list[list[str]]],
              alpha: float = METEOR15_EN["alpha"],
              beta: float = METEOR15_EN["beta"],
              gamma: float = METEOR15_EN["gamma"],
              delta: float = METEOR15_EN["delta"],
              weights: tuple = METEOR15_EN["weights"],
              synonyms=None, paraphrases=None) -> float:
    """Corpus METEOR-1.5: per segment pick the reference with the best
    sentence-level score, aggregate its sufficient statistics, and compute
    the final score on the pooled totals (the jar's system-level score).

    synonyms / paraphrases inject the module-2/3 data sources (see
    align_modules_full); without them only exact+stem stages run."""
    _check_tokenized(candidates, references)
    assert len(candidates) == len(references)
    if not candidates:
        return 0.0
    totals = {k: 0.0 for k in
              ("p_num", "r_num", "p_den", "r_den", "matches", "chunks")}
    for cand, refs in zip(candidates, references):
        hyp = [t.lower() for t in cand]
        best = max((_stats_15(hyp, [t.lower() for t in r], delta, weights,
                              synonyms, paraphrases)
                    for r in refs),
                   key=lambda s: _score_15(s, alpha, beta, gamma))
        for k in totals:
            totals[k] += best[k]
    return _score_15(totals, alpha, beta, gamma)


def meteor_single_15(hyp_tokens: list[str], ref_tokens: list[str],
                     alpha: float = METEOR15_EN["alpha"],
                     beta: float = METEOR15_EN["beta"],
                     gamma: float = METEOR15_EN["gamma"],
                     delta: float = METEOR15_EN["delta"],
                     weights: tuple = METEOR15_EN["weights"],
                     synonyms=None, paraphrases=None) -> float:
    """Sentence-level METEOR-1.5 (single reference)."""
    s = _stats_15([t.lower() for t in hyp_tokens],
                  [t.lower() for t in ref_tokens], delta, weights,
                  synonyms, paraphrases)
    return _score_15(s, alpha, beta, gamma)
