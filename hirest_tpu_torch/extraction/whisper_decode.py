"""Whisper decoding rules: beam/sampling with temperature fallback, quality
gating, and timestamp rules — transcription-parity with the reference's
`whisper.transcribe` call (extraction/whisper_ASR/extract_ASR.py:42-104:
temperature schedule 0.15..0.95 step 0.2, beam 5, best_of 5,
compression_ratio 2.4 / logprob -1.0 / no_speech 0.6 gates,
condition_on_previous_text).

An own copy of hirest_tpu/extraction/whisper_decode.py (the port imports
nothing of the JAX package): the rules are host code on NumPy, copied as
they are, with the same `np.random.default_rng(options.seed)` draws. The
MODEL compute (encoder + KV-cached decoder step) runs on the device; the
decoding CONTROL FLOW (logit rules, beam bookkeeping, temperature
fallback, the 30 s seek loop) runs host-side in NumPy. An `adapter` object
supplies the model:

    adapter.encode(mel [T, 80]) -> enc
    adapter.init_state(enc, n_seq, max_len) -> state
    adapter.step(state, tokens [n], pos) -> (logits np [n, V], state)
    adapter.reorder(state, src [n]) -> state   (beam cache shuffling)

so the rules are unit-testable against scripted fake models, and
`TorchWhisperAdapter` plugs in the port's Whisper (models/whisper.py), in
the place of the JAX package's `JaxWhisperAdapter`.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from hirest_tpu_torch.extraction.mel import HOP_LENGTH, SAMPLE_RATE

N_FRAMES = 3000                 # mel frames per 30 s window (10 ms hop)
INPUT_STRIDE = 2                # mel frames per encoder position / ts unit
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100
TIME_PRECISION = INPUT_STRIDE / FRAMES_PER_SECOND  # 0.02 s per ts token


@dataclass(frozen=True)
class DecodeOptions:
    """Defaults = the reference's extract_ASR.py whisper_args (lines 46-90).

    The temperature schedule starts at 0.15 there, so the reference run is
    always sampling; t == 0.0 in the schedule selects beam search (the
    upstream whisper default schedule (0.0, 0.2, ..)) — both are supported.
    """

    temperature: tuple = (0.15, 0.35, 0.55, 0.75, 0.95)
    best_of: int = 5
    beam_size: int = 5
    patience: float = 1.0
    length_penalty: float | None = None    # reference: -0.05 -> None
    compression_ratio_threshold: float | None = 2.4
    logprob_threshold: float | None = -1.0
    no_speech_threshold: float | None = 0.6
    condition_on_previous_text: bool = True
    suppress_blank: bool = True
    suppress_tokens: str | tuple = "-1"
    without_timestamps: bool = False
    max_initial_timestamp: float | None = 1.0
    sample_len: int = 224                  # n_text_ctx // 2
    seed: int = 0


@dataclass
class DecodeResult:
    tokens: list          # sampled tokens (after the prompt, pre-EOT)
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float = float("nan")
    text: str = ""


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    return len(data) / len(zlib.compress(data)) if data else 0.0


# ---------------------------------------------------------------------------
# Logit rules (host-side, [n, V] logits + [n, L] grown sequences)
# ---------------------------------------------------------------------------


def suppress_tokens_rule(logits: np.ndarray, ids) -> None:
    logits[:, list(ids)] = -np.inf


def suppress_blank_rule(logits: np.ndarray, blank_id: int, eot_id: int) -> None:
    logits[:, [blank_id, eot_id]] = -np.inf


def timestamp_rules(logits: np.ndarray, seqs: list[list[int]], tok,
                    sample_begin: int,
                    max_initial_timestamp: float | None) -> None:
    """whisper's ApplyTimestampRules:
    - timestamps come in pairs, except directly before EOT;
    - timestamps must be non-decreasing;
    - the first sampled token must be a timestamp, bounded by
      max_initial_timestamp;
    - when the total timestamp probability mass beats every text token,
      sample a timestamp.
    Mutates `logits` in place."""
    ts_begin = tok.TIMESTAMP_BEGIN
    logits[:, tok.NO_TIMESTAMPS] = -np.inf

    for k, seq in enumerate(seqs):
        sampled = seq[sample_begin:]
        last_was_ts = len(sampled) >= 1 and sampled[-1] >= ts_begin
        penultimate_was_ts = len(sampled) < 2 or sampled[-2] >= ts_begin
        if last_was_ts:
            if penultimate_was_ts:          # has to be non-timestamp
                logits[k, ts_begin:] = -np.inf
            else:                           # cannot be a text token
                logits[k, : tok.EOT] = -np.inf
        timestamps = [t for t in sampled if t >= ts_begin]
        if timestamps:
            # timestamps must not decrease; a lone closing ts may repeat
            last_allowed = (timestamps[-1] if last_was_ts
                            and not penultimate_was_ts
                            else timestamps[-1] + 1)
            logits[k, ts_begin:last_allowed] = -np.inf

        if len(sampled) == 0:
            logits[k, : ts_begin] = -np.inf  # force an initial timestamp
            if max_initial_timestamp is not None:
                last = ts_begin + round(max_initial_timestamp / TIME_PRECISION)
                logits[k, last + 1:] = -np.inf

    # sum-of-timestamp-probability rule
    logprobs = log_softmax(logits)
    for k in range(logits.shape[0]):
        ts_logprob = logsumexp(logprobs[k, ts_begin:])
        max_text = np.max(logprobs[k, : ts_begin]) if np.any(
            np.isfinite(logprobs[k, : ts_begin])) else -np.inf
        if ts_logprob > max_text:
            logits[k, : ts_begin] = -np.inf


def log_softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    e = x - m
    with np.errstate(divide="ignore"):
        return e - np.log(np.sum(np.exp(e), axis=-1, keepdims=True))


def logsumexp(x: np.ndarray) -> float:
    m = np.max(x)
    if not np.isfinite(m):
        return float(m)
    return float(m + np.log(np.sum(np.exp(x - m))))


def build_suppress_list(tok, suppress_tokens="-1") -> list[int]:
    """whisper's _get_suppress_tokens: '-1' expands to the non-speech set;
    special tokens are always suppressed."""
    if isinstance(suppress_tokens, str):
        suppress = [int(t) for t in suppress_tokens.split(",") if t]
    else:
        suppress = list(suppress_tokens)
    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tok.non_speech_tokens())
    suppress.extend([tok.TRANSCRIBE, tok.TRANSLATE, tok.SOT, tok.SOT_PREV,
                     tok.SOT_LM, tok.NO_SPEECH])
    return sorted(set(suppress))


# ---------------------------------------------------------------------------
# One-segment decode (beam at t=0, sampling at t>0, greedy fallback)
# ---------------------------------------------------------------------------


def _length_penalty(length: int, penalty: float | None) -> float:
    if penalty is None:
        return float(max(length, 1))
    return float(((5 + length) / 6) ** penalty)  # Google NMT penalty


def decode_segment(adapter, enc, tok, options: DecodeOptions,
                   temperature: float, prompt_tokens=(),
                   rng: np.random.Generator | None = None) -> DecodeResult:
    """Decode one 30 s window at a fixed temperature."""
    rng = rng or np.random.default_rng(options.seed)
    use_beam = temperature == 0 and options.beam_size is not None
    n = options.beam_size if use_beam else (
        options.best_of if temperature > 0 else 1)

    sot_seq = [tok.SOT] + ([tok.NO_TIMESTAMPS] if options.without_timestamps
                           else [])
    if prompt_tokens:
        keep = 448 // 2 - 1
        initial = [tok.SOT_PREV] + list(prompt_tokens)[-keep:] + sot_seq
    else:
        initial = list(sot_seq)
    sot_index = initial.index(tok.SOT)
    sample_begin = len(initial)

    suppress = build_suppress_list(tok, options.suppress_tokens)
    try:
        blank_id = tok.encode(" ")[0]
    except Exception:
        blank_id = None

    # pad the KV-cache length to a 64-bucket, as the JAX package does for
    # its jitted step (sample_begin tracks the growing previous-text
    # prompt); rows past `pos` are masked in self-attention
    # (models/whisper.py step), so padding is identity
    max_len = sample_begin + options.sample_len
    max_len = -(-max_len // 64) * 64
    state = adapter.init_state(enc, n, max_len)

    seqs = [list(initial) for _ in range(n)]
    sum_logprobs = np.zeros(n)
    no_speech_prob = float("nan")

    # feed the prompt; capture no-speech probability at the SOT position
    logits = None
    for pos in range(sample_begin):
        step_tokens = np.array([seqs[0][pos]] * n, np.int32)
        logits, state = adapter.step(state, step_tokens, pos)
        if pos == sot_index:
            probs = np.exp(log_softmax(logits[0].astype(np.float64)))
            no_speech_prob = float(probs[tok.NO_SPEECH])

    if use_beam:
        finished: dict[tuple, float] = {}
        max_candidates = int(round(options.beam_size * options.patience))
        sum_logprobs = np.full(n, -np.inf)
        sum_logprobs[0] = 0.0  # all beams start identical; keep one live

    ended = np.zeros(n, bool)
    for i in range(options.sample_len):
        logits = logits.astype(np.float64)
        if i == 0 and options.suppress_blank and blank_id is not None:
            suppress_blank_rule(logits, blank_id, tok.EOT)
        suppress_tokens_rule(logits, suppress)
        if not options.without_timestamps:
            timestamp_rules(logits, seqs, tok, sample_begin,
                            options.max_initial_timestamp)
        logprobs = log_softmax(logits)

        if use_beam:
            # expand every live beam by its top (beam+1) candidates
            scores: dict[tuple, float] = {}
            sources: dict[tuple, int] = {}
            for j in range(n):
                if not np.isfinite(sum_logprobs[j]):
                    continue
                top = np.argsort(logprobs[j])[::-1][: options.beam_size + 1]
                for t_id in top:
                    cand = tuple(seqs[j]) + (int(t_id),)
                    scores[cand] = sum_logprobs[j] + logprobs[j, t_id]
                    sources[cand] = j
            next_seqs, next_logprobs, src = [], [], []
            for cand in sorted(scores, key=scores.get, reverse=True):
                if cand[-1] == tok.EOT:
                    if len(finished) < max_candidates:
                        finished[cand] = scores[cand]
                else:
                    next_seqs.append(list(cand))
                    next_logprobs.append(scores[cand])
                    src.append(sources[cand])
                if len(next_seqs) == n:
                    break
            while len(next_seqs) < n:    # degenerate: pad with the best beam
                next_seqs.append(list(next_seqs[0] if next_seqs else initial)
                                 + [tok.EOT])
                next_logprobs.append(-np.inf)
                src.append(src[0] if src else 0)
            seqs = next_seqs
            sum_logprobs = np.array(next_logprobs)
            state = adapter.reorder(state, np.array(src, np.int32))
            if len(finished) >= max_candidates:
                break
        else:
            if temperature > 0:
                probs = np.exp(logprobs / temperature
                               - logsumexp_rows(logprobs / temperature))
                next_tokens = np.array(
                    [rng.choice(len(p), p=p / p.sum()) for p in probs],
                    np.int32)
            else:
                next_tokens = np.argmax(logprobs, axis=-1).astype(np.int32)
            next_tokens[ended] = tok.EOT
            for j in range(n):
                if not ended[j]:   # the first EOT's logprob IS accumulated
                    sum_logprobs[j] += logprobs[j, next_tokens[j]]
                seqs[j].append(int(next_tokens[j]))
            ended |= next_tokens == tok.EOT
            if ended.all():
                break

        pos = len(seqs[0]) - 1
        step_tokens = np.array([s[-1] for s in seqs], np.int32)
        if pos >= max_len:
            break
        logits, state = adapter.step(state, step_tokens, pos)

    # ----- select the winning hypothesis -------------------------------
    if use_beam:
        if len(finished) < n:
            # BeamSearchDecoder.finalize semantics: whenever fewer than
            # beam_size sequences finished, top up with the live beams
            # (tokens + EOT, no extra EOT logprob added), best-first.
            # Exact parity (whisper eff383b): the assignment is
            # unconditional — a live beam OVERWRITES an already-finished
            # duplicate's logprob, and -inf beams are added too.
            # sorted exactly as the reference (np.argsort ascending,
            # reversed): on tied logprobs the fill ORDER matches too
            for j in list(np.argsort(sum_logprobs))[::-1]:
                if len(finished) >= n:
                    break
                finished[tuple(seqs[j]) + (tok.EOT,)] = sum_logprobs[j]
        def score(item):
            cand, lp = item
            length = len(cand) - sample_begin - 1   # sampled tokens, no EOT
            return lp / _length_penalty(length, options.length_penalty)
        best, best_lp = max(finished.items(), key=score)
        tokens = list(best[sample_begin:-1])
        avg = best_lp / (len(tokens) + 1)
    else:
        cut = []
        for s in seqs:
            sampled = s[sample_begin:]
            cut.append(sampled[: sampled.index(tok.EOT)]
                       if tok.EOT in sampled else sampled)
        norm = np.array([_length_penalty(len(c), options.length_penalty)
                         for c in cut])
        j = int(np.argmax(sum_logprobs / norm))
        tokens = cut[j]
        avg = sum_logprobs[j] / (len(tokens) + 1)

    return DecodeResult(tokens=tokens, avg_logprob=float(avg),
                        no_speech_prob=no_speech_prob,
                        temperature=temperature)


def logsumexp_rows(x: np.ndarray) -> np.ndarray:
    m = np.max(x, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return m + np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True))


def decode_with_fallback(adapter, enc, tok, options: DecodeOptions,
                         prompt_tokens=(), decode_fn=None,
                         rng=None) -> DecodeResult:
    """Try each temperature in the schedule; accept the first result that
    passes the compression-ratio and avg-logprob gates
    (whisper.transcribe's decode_with_fallback)."""
    decode_fn = decode_fn or decode_segment
    result = None
    for t in options.temperature:
        result = decode_fn(adapter, enc, tok, options, t,
                           prompt_tokens=prompt_tokens, rng=rng)
        result.text = tok.decode(result.tokens)
        result.compression_ratio = compression_ratio(result.text)

        needs_fallback = False
        if (options.compression_ratio_threshold is not None
                and result.compression_ratio > options.compression_ratio_threshold):
            needs_fallback = True      # too repetitive
        if (options.logprob_threshold is not None
                and result.avg_logprob < options.logprob_threshold):
            needs_fallback = True      # low confidence
        # NB: no silence short-circuit here — the whisper version the
        # reference pins (eff383b) has none; probable-silence segments still
        # escalate through the temperature schedule and are skipped (or not)
        # by the seek loop's should_skip gate afterwards.
        if not needs_fallback:
            return result
    return result


# ---------------------------------------------------------------------------
# The 30-second seek loop
# ---------------------------------------------------------------------------


def transcribe_with_rules(adapter, audio: np.ndarray, tok,
                          options: DecodeOptions = DecodeOptions()) -> dict:
    """Full-audio transcription with whisper.transcribe's segmentation
    semantics: sliding 30 s windows, seek advanced to the last complete
    timestamp pair, previous-text conditioning with reset after
    high-temperature fallbacks, no-speech skipping.

    Returns {"text", "segments": [{start, end, text, tokens, temperature,
    avg_logprob, compression_ratio, no_speech_prob}]}.
    """
    from hirest_tpu_torch.extraction.mel import log_mel_spectrogram

    rng = np.random.default_rng(options.seed)
    mel = log_mel_spectrogram(audio, pad_to_chunk=True)   # [frames, 80]
    content_frames = int(len(audio) / HOP_LENGTH)
    ts_begin = tok.TIMESTAMP_BEGIN

    seek = 0
    all_tokens: list[int] = []
    segments: list[dict] = []
    prompt_reset_since = 0

    while seek < content_frames:
        time_offset = seek * (1.0 / FRAMES_PER_SECOND)
        # pad_or_trim-on-mel semantics (pinned whisper eff383b): the window
        # is zero-padded immediately after the audio content, so slice only
        # content frames — mel past content_frames is silence-mel from the
        # chunk-rounding pad and must not leak into tail windows.
        window = mel[seek: min(seek + N_FRAMES, content_frames)]
        if window.shape[0] < N_FRAMES:
            window = np.pad(window, ((0, N_FRAMES - window.shape[0]), (0, 0)))
        segment_size = min(N_FRAMES, content_frames - seek)
        segment_duration = segment_size / FRAMES_PER_SECOND

        enc = adapter.encode(window)
        prompt = (all_tokens[prompt_reset_since:]
                  if options.condition_on_previous_text else [])
        result = decode_with_fallback(adapter, enc, tok, options,
                                      prompt_tokens=prompt, rng=rng)

        if options.no_speech_threshold is not None:
            should_skip = result.no_speech_prob > options.no_speech_threshold
            if (options.logprob_threshold is not None
                    and result.avg_logprob > options.logprob_threshold):
                should_skip = False   # confident despite no-speech signal
            if should_skip:
                seek += segment_size
                continue

        tokens = np.array(result.tokens, np.int64)

        def add_segment(start, end, seg_tokens):
            text_tokens = [t for t in seg_tokens if t < tok.EOT]
            if not text_tokens:
                return
            segments.append({
                "start": float(start), "end": float(end),
                "text": tok.decode(text_tokens),
                "tokens": [int(t) for t in seg_tokens],
                "temperature": result.temperature,
                "avg_logprob": result.avg_logprob,
                "compression_ratio": result.compression_ratio,
                "no_speech_prob": result.no_speech_prob,
            })

        if tokens.size:
            is_ts = tokens >= ts_begin
            single_ts_ending = (tokens.size >= 2 and bool(is_ts[-1])
                                and not bool(is_ts[-2]))
            consecutive = (np.where(is_ts[:-1] & is_ts[1:])[0] + 1).tolist()
        else:
            is_ts = np.zeros(0, bool)
            single_ts_ending = False
            consecutive = []

        # tokens actually consumed into segments this window — the prompt
        # conditioning below must see ONLY these (the reference extends
        # all_tokens from current_segments, i.e. tokens[:last_slice]; the
        # unconsumed tail past the last timestamp pair is re-decoded in the
        # next window and must not leak into its prompt)
        consumed: list = []
        if consecutive:
            slices = list(consecutive)
            if single_ts_ending:
                slices.append(len(tokens))
            last_slice = 0
            for cur in slices:
                sliced = tokens[last_slice:cur]
                start_pos = int(sliced[0]) - ts_begin
                end_pos = int(sliced[-1]) - ts_begin
                add_segment(time_offset + start_pos * TIME_PRECISION,
                            time_offset + end_pos * TIME_PRECISION,
                            sliced.tolist())
                consumed.extend(sliced.tolist())
                last_slice = cur
            if single_ts_ending:
                seek += segment_size   # window fully consumed
            else:
                # continue from the last complete timestamp pair
                last_ts_pos = int(tokens[last_slice - 1]) - ts_begin
                seek += last_ts_pos * INPUT_STRIDE
        else:
            duration = segment_duration
            ts = tokens[is_ts] if tokens.size else np.zeros(0, np.int64)
            if ts.size and int(ts[-1]) != ts_begin:
                duration = (int(ts[-1]) - ts_begin) * TIME_PRECISION
            add_segment(time_offset, time_offset + duration, tokens.tolist())
            consumed.extend(tokens.tolist())
            seek += segment_size

        all_tokens.extend(consumed)
        if not options.condition_on_previous_text or result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)

    return {"text": "".join(s["text"] for s in segments).strip(),
            "segments": segments}


# ---------------------------------------------------------------------------
# The port's model adapter
# ---------------------------------------------------------------------------


class TorchWhisperAdapter:
    """Adapts the port's Whisper (models/whisper.py) to the decode loop: the
    encoder and the KV-cached single-token step run eagerly on the modules'
    device, the logits come back to the host every step (the fetch the
    rules need, as in JAX); control flow stays on the host. A step writes
    its cache slot in place: the loop never reuses a state it has passed
    on."""

    def __init__(self, encoder, decoder):
        self.encoder, self.decoder = encoder, decoder
        self.device = decoder.embed_tokens.weight.device

    @torch.inference_mode()
    def encode(self, mel: np.ndarray):
        return self.encoder(torch.from_numpy(
            np.ascontiguousarray(mel[None], np.float32)).to(self.device))

    @torch.inference_mode()
    def init_state(self, enc, n_seq: int, max_len: int):
        return {"cross": self.decoder.cross_kv(
                    enc.repeat_interleave(n_seq, dim=0)),
                "cache": self.decoder.init_cache(n_seq, max_len)}

    @torch.inference_mode()
    def step(self, state, tokens: np.ndarray, pos: int):
        logits, cache = self.decoder.decode_step(
            torch.from_numpy(np.asarray(tokens, np.int32)).to(self.device),
            pos, state["cross"], state["cache"])
        return logits.cpu().numpy(), {"cross": state["cross"],
                                      "cache": cache}

    @torch.inference_mode()
    def reorder(self, state, src: np.ndarray):
        src = torch.from_numpy(np.asarray(src, np.int64)).to(self.device)
        return {"cross": state["cross"],
                "cache": tuple((k.index_select(0, src),
                                v.index_select(0, src))
                               for k, v in state["cache"])}
