"""ASR transcription + per-segment sentence embeddings.

Counterpart of hirest_tpu/extraction/asr.py. Reference surface:
extraction/whisper_ASR/extract_ASR.py (Whisper small.en, beam 5,
temperature-fallback schedule, .srt output) and extract_ASR_embedding.py
(MiniLM-L6-v2 384-d or CLIP text 512-d per subtitle segment).

    python -m hirest_tpu_torch.extraction.asr --audio_dir WAVS --asr_dir SRTS \
        --ckpt whisper.bin --vocab vocab.json --merges merges.txt \
        [--device cpu]
    python -m hirest_tpu_torch.extraction.asr --embed --asr_dir SRTS \
        --save_dir FEATS [--pretrained_dir DIR] [--device cpu]

`transcribe_audio_dir` calls the `openai-whisper` package and raises
without it, as the JAX function does; `transcribe_audio_dir_torch` runs the
port's own Whisper (models/whisper.py) with the decoding rules of
extraction/whisper_decode.py, on CUDA unless device="cpu" is given.
`embed_srt_dir` embeds with the port's MiniLM by default.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping

import numpy as np

from hirest_tpu_torch.data.srt import load_srt
# Public token-id constants of the Whisper *.en vocabulary — single source
# of truth is the tokenizer (tokenizers/gpt2_bpe.py); re-exported here
from hirest_tpu_torch.tokenizers.gpt2_bpe import WhisperEnTokenizer as _WT


def format_srt_timestamp(seconds: float) -> str:
    ms = int(round(seconds * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def segments_to_srt(segments) -> str:
    """[{start, end, text}] -> SRT document."""
    lines = []
    for i, seg in enumerate(segments, 1):
        lines.append(str(i))
        lines.append(f"{format_srt_timestamp(seg['start'])} --> "
                     f"{format_srt_timestamp(seg['end'])}")
        lines.append(seg["text"].strip())
        lines.append("")
    return "\n".join(lines)


def transcribe_audio_dir(audio_dir: str, srt_dir: str, model_name: str = "small.en",
                         beam_size: int = 5) -> int:
    """Whisper transcription with the reference's decoding config
    (beam 5, temperature fallback handled inside whisper.transcribe)."""
    try:
        import whisper
    except ImportError as e:
        raise ImportError(
            "openai-whisper is not installed; transcribe where it is, use "
            "transcribe_audio_dir_torch (the port's own Whisper), or bring "
            ".srt transcripts directly (the data pipeline only needs the "
            ".srt files)") from e

    model = whisper.load_model(model_name)
    audio_dir, srt_dir = Path(audio_dir), Path(srt_dir)
    srt_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for wav in sorted(audio_dir.glob("*.wav")):
        out = srt_dir / f"{wav.stem}.srt"
        if out.exists():
            continue
        result = model.transcribe(str(wav), beam_size=beam_size,
                                  temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0))
        out.write_text(segments_to_srt(result["segments"]))
        n += 1
    return n


# ---------------------------------------------------------------------------
# Transcription on the port's Whisper (hirest_tpu_torch.models.whisper)
# ---------------------------------------------------------------------------

EOT = _WT.EOT
SOT = _WT.SOT
NO_TIMESTAMPS = _WT.NO_TIMESTAMPS
TIMESTAMP_BEGIN = _WT.TIMESTAMP_BEGIN
TIME_PRECISION = _WT.TIME_PRECISION


def tokens_to_segments(tokens, decode_text_fn, chunk_offset: float = 0.0):
    """Split a decoded token stream into [{start, end, text}] segments at
    timestamp-token pairs; `decode_text_fn(ids) -> str` is the (externally
    supplied) Whisper text tokenizer."""
    segments = []
    start_ts = None
    text_ids: list[int] = []
    for tok in tokens:
        tok = int(tok)
        if tok == EOT:
            break
        if tok >= TIMESTAMP_BEGIN:
            ts = chunk_offset + (tok - TIMESTAMP_BEGIN) * TIME_PRECISION
            if start_ts is None:
                start_ts = ts
            else:
                if text_ids:
                    segments.append({"start": start_ts, "end": ts,
                                     "text": decode_text_fn(text_ids)})
                start_ts = None
                text_ids = []
        elif tok >= SOT:
            continue  # special tokens
        else:
            text_ids.append(tok)
    if text_ids and start_ts is not None:
        segments.append({"start": start_ts,
                         "end": chunk_offset + 30.0,
                         "text": decode_text_fn(text_ids)})
    return segments


class TorchWhisperTranscriber:
    """Transcription on the port's Whisper, on `device` (CUDA unless "cpu"
    is asked for). Two modes, as the JAX package's JaxWhisperTranscriber:

    - rules mode (default, `decode_options` or a tokenizer given): the full
      whisper.transcribe semantics — beam/sampling with the reference's
      temperature-fallback schedule, compression-ratio/logprob/no-speech
      gates, timestamp rules, sliding-window seek
      (hirest_tpu_torch.extraction.whisper_decode; reference
      extract_ASR.py:42-104);
    - greedy mode (`use_rules=False`): fixed 30 s chunks, the KV-cached
      greedy decode.

    Weights: an HF whisper checkpoint (state dict with
    `model.encoder.* / model.decoder.*` or bare keys), given as a path or
    as a loaded state dict, at `config` (small.en by default). Text
    decoding: pass `tokenizer` (a WhisperEnTokenizer, built from the
    checkpoint's vocab.json/merges.txt) or a bare `decode_text_fn`."""

    def __init__(self, ckpt_path, decode_text_fn=None, config=None,
                 max_new_tokens: int = 224, tokenizer=None,
                 decode_options=None, use_rules: bool = True, device=None):
        from hirest_tpu_torch.models.convert import load_torch_ckpt
        from hirest_tpu_torch.models.whisper import load_whisper
        from hirest_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.decode_text_fn = decode_text_fn or (
            tokenizer.decode if tokenizer is not None else None)
        if self.decode_text_fn is None:
            raise ValueError("need `tokenizer` (WhisperEnTokenizer) or "
                             "`decode_text_fn` to produce transcript text")
        if decode_options is not None and tokenizer is None:
            # the rules decoder (beam, temperature fallback, quality gates)
            # needs the tokenizer's special-token ids — silently dropping
            # the requested options onto the greedy path is the one thing
            # this flag must never do
            raise ValueError(
                "decode_options given but no tokenizer: the rules decode "
                "path needs a WhisperEnTokenizer (pass `tokenizer=` or use "
                "from_hf_dir, which builds one from vocab.json/merges.txt)")
        sd = (ckpt_path if isinstance(ckpt_path, Mapping)
              else load_torch_ckpt(ckpt_path))
        self.encoder, self.decoder = load_whisper(sd, config, self.device)
        self.cfg = self.encoder.cfg
        self.decode_options = decode_options
        self.use_rules = use_rules and tokenizer is not None
        self.max_new_tokens = max_new_tokens
        self._adapter = None

    @classmethod
    def from_hf_dir(cls, ckpt_dir: str, ckpt_name: str = "pytorch_model.bin",
                    **kw):
        """Build from an HF whisper checkpoint directory (weights +
        vocab.json/merges.txt), fully whisper-package-free."""
        from hirest_tpu_torch.tokenizers.gpt2_bpe import WhisperEnTokenizer

        d = Path(ckpt_dir)
        tok = WhisperEnTokenizer(str(d / "vocab.json"), str(d / "merges.txt"))
        return cls(str(d / ckpt_name), tokenizer=tok, **kw)

    @property
    def adapter(self):
        """The TorchWhisperAdapter the rules mode decodes through."""
        if self._adapter is None:
            from hirest_tpu_torch.extraction.whisper_decode import \
                TorchWhisperAdapter

            self._adapter = TorchWhisperAdapter(self.encoder, self.decoder)
        return self._adapter

    def transcribe(self, audio: np.ndarray) -> list[dict]:
        """16 kHz mono float audio -> [{start, end, text}] segments."""
        if self.use_rules:
            from hirest_tpu_torch.extraction.whisper_decode import (
                DecodeOptions, transcribe_with_rules)

            opts = self.decode_options or DecodeOptions()
            return transcribe_with_rules(self.adapter, audio,
                                         self.tokenizer, opts)["segments"]
        return self._transcribe_greedy(audio)

    def _transcribe_greedy(self, audio: np.ndarray) -> list[dict]:
        """Fixed 30 s chunks, the KV-cached greedy decode."""
        import torch

        from hirest_tpu_torch.extraction.mel import (N_SAMPLES,
                                                     log_mel_spectrogram)
        from hirest_tpu_torch.models.whisper import greedy_decode

        segments = []
        for chunk_idx in range(max(1, int(np.ceil(len(audio) / N_SAMPLES)))):
            chunk = audio[chunk_idx * N_SAMPLES: (chunk_idx + 1) * N_SAMPLES]
            mel = log_mel_spectrogram(chunk)  # [frames, 80]
            with torch.inference_mode():
                enc = self.encoder(torch.from_numpy(mel[None]).to(
                    self.device))
            prompt = np.array([[SOT]], dtype=np.int32)  # .en: no language token
            tokens = greedy_decode(self.decoder, enc, prompt,
                                   self.max_new_tokens, EOT)[0]
            segments.extend(tokens_to_segments(tokens[1:], self.decode_text_fn,
                                               chunk_offset=chunk_idx * 30.0))
        return segments


def read_wav_mono16k(path: str) -> np.ndarray:
    """16-bit PCM mono 16 kHz wav (extract_audio's output format) -> float32."""
    import wave

    with wave.open(str(path), "rb") as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit mono PCM")
        if w.getframerate() != 16_000:
            raise ValueError(f"{path}: expected 16 kHz")
        data = w.readframes(w.getnframes())
    return np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0


def transcribe_audio_dir_torch(audio_dir: str, srt_dir: str, ckpt_path,
                               decode_text_fn=None, config=None,
                               vocab_path: str | None = None,
                               merges_path: str | None = None,
                               decode_options=None, device=None) -> int:
    """The port's analogue of transcribe_audio_dir, on its own Whisper
    (`ckpt_path`: a path or a loaded HF state dict).

    With `vocab_path`/`merges_path` (the HF checkpoint's vocab.json /
    merges.txt) the full whisper decoding rules run, whisper-package-free;
    with only `decode_text_fn`, the greedy path is used."""
    tokenizer = None
    if vocab_path and merges_path:
        from hirest_tpu_torch.tokenizers.gpt2_bpe import WhisperEnTokenizer

        tokenizer = WhisperEnTokenizer(vocab_path, merges_path)
    transcriber = TorchWhisperTranscriber(ckpt_path, decode_text_fn,
                                          config=config, tokenizer=tokenizer,
                                          decode_options=decode_options,
                                          device=device)
    audio_dir, srt_dir = Path(audio_dir), Path(srt_dir)
    srt_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for wav in sorted(audio_dir.glob("*.wav")):
        out = srt_dir / f"{wav.stem}.srt"
        if out.exists():
            continue
        segments = transcriber.transcribe(read_wav_mono16k(str(wav)))
        out.write_text(segments_to_srt(segments))
        n += 1
    return n


MINILM_CKPTS = ("all-MiniLM-L6-v2.bin", "minilm.bin", "minilm.pt")


def embed_srt_dir(srt_dir: str, out_dir: str, encoder: str = "minilm_torch",
                  encode_text_fn=None,
                  pretrained_dir: str = "./pretrained_weights",
                  device=None) -> int:
    """Per-subtitle-segment sentence embeddings -> {video_id}.npy
    [n_segments, dim]. encoder:
      'minilm_torch' (384-d, the port's MiniLM on `device`; needs a MiniLM
      checkpoint + vocab.txt in pretrained_dir),
      'minilm' (sentence-transformers, network download),
      'fn' with an injected encode_text_fn (e.g. the CLIP text tower)."""
    if encoder == "minilm_torch":
        from hirest_tpu_torch.models.minilm import make_minilm_embedder
        from hirest_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)  # before any work
        ckpt = next((os.path.join(pretrained_dir, name)
                     for name in MINILM_CKPTS
                     if os.path.exists(os.path.join(pretrained_dir, name))),
                    None)
        if ckpt is None:
            raise FileNotFoundError(
                f"no MiniLM checkpoint in {pretrained_dir} "
                "(expected all-MiniLM-L6-v2.bin); or use encoder='fn'")
        encode = make_minilm_embedder(
            ckpt, os.path.join(pretrained_dir, "vocab.txt"), device=device)
    elif encoder == "minilm":
        from sentence_transformers import SentenceTransformer

        model = SentenceTransformer("all-MiniLM-L6-v2")
        encode = lambda texts: np.asarray(model.encode(texts))  # noqa: E731
    elif encoder == "fn":
        if encode_text_fn is None:
            raise ValueError("encoder='fn' needs encode_text_fn")
        encode = lambda texts: np.asarray(encode_text_fn(texts))  # noqa: E731
    else:
        raise ValueError(encoder)

    srt_dir, out_dir = Path(srt_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for srt_path in sorted(srt_dir.glob("*.srt")):
        out = out_dir / f"{srt_path.stem}.npy"
        if out.exists():
            continue
        subs = load_srt(str(srt_path))
        if not subs:
            continue
        embs = encode([s.text for s in subs]).astype(np.float32)
        np.save(out, embs)
        n += 1
    return n


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(
        description="ASR transcription / embedding (reference "
                    "extraction/whisper_ASR/extract_ASR[_embedding].py "
                    "parity; --embed switches to the embedding step)")
    p.add_argument("--audio_dir", type=str, help="input .wav dir (transcribe)")
    p.add_argument("--asr_dir", type=str, required=True,
                   help="SRT dir (output of transcribe, input of --embed)")
    p.add_argument("--save_dir", type=str, help="embedding output dir (--embed)")
    p.add_argument("--model", type=str, default="small.en",
                   help="whisper size (whisper-package path, without --ckpt)")
    p.add_argument("--ckpt", type=str, default="",
                   help="HF whisper checkpoint: use the port's own Whisper "
                        "(whisper-package-free)")
    p.add_argument("--vocab", type=str, default="",
                   help="vocab.json for the full decoding rules (with --ckpt)")
    p.add_argument("--merges", type=str, default="",
                   help="merges.txt for the full decoding rules (with --ckpt)")
    p.add_argument("--embed", action="store_true",
                   help="embed existing SRTs instead of transcribing")
    p.add_argument("--encoder", type=str, default="minilm_torch",
                   choices=["minilm_torch", "minilm"])
    p.add_argument("--pretrained_dir", type=str, default="./pretrained_weights")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    a = p.parse_args()

    if a.embed:
        if not a.save_dir:
            p.error("--embed needs --save_dir")
        n = embed_srt_dir(a.asr_dir, a.save_dir, encoder=a.encoder,
                          pretrained_dir=a.pretrained_dir, device=a.device)
        print(f"embedded {n} transcripts -> {a.save_dir}")
    else:
        if not a.audio_dir:
            p.error("transcription needs --audio_dir")
        if a.ckpt:
            n = transcribe_audio_dir_torch(a.audio_dir, a.asr_dir, a.ckpt,
                                           vocab_path=a.vocab or None,
                                           merges_path=a.merges or None,
                                           device=a.device)
        else:
            n = transcribe_audio_dir(a.audio_dir, a.asr_dir, model_name=a.model)
        print(f"transcribed {n} files -> {a.asr_dir}")
