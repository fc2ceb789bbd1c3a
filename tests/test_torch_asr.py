"""The port's ASR path against the JAX package on the CPU: the GPT-2 BPE
(both word-split branches), the log-mel frontend, Whisper (f32, weights
shared through `whisper_from_jax`), the decoding rules and their seek loop
behind `TorchWhisperAdapter`, the SRT and wav helpers, the transcription
and embedding directories end to end, and MiniLM."""

import json
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hirest_tpu.extraction.asr as jax_asr
import hirest_tpu.extraction.mel as jax_mel
import hirest_tpu.extraction.whisper_decode as jax_wd
import hirest_tpu.models.minilm as jax_minilm
import hirest_tpu.models.whisper as jax_whisper
import hirest_tpu.tokenizers.gpt2_bpe as jax_bpe
import hirest_tpu_torch.extraction.asr as asr
import hirest_tpu_torch.extraction.mel as mel
import hirest_tpu_torch.extraction.whisper_decode as wd
import hirest_tpu_torch.models.whisper as whisper
import hirest_tpu_torch.tokenizers.gpt2_bpe as bpe
from hirest_tpu_torch.models.convert import minilm_from_jax, whisper_from_jax
from hirest_tpu_torch.models.minilm import (MiniLmConfig, convert_minilm,
                                            load_minilm, make_minilm_embedder)
from hirest_tpu_torch.utils.init import random_minilm_state_dict

from test_whisper_decode import (FakeTok, ScriptAdapter,
                                 _write_tiny_vocab)
from torch_port_util import (QKV_GAIN, WHISPER_DECODE, WHISPER_TINY,
                             whisper_state_dict, write_byte_vocab)

TOL = 1e-5  # f32, of the reference's largest magnitude


def _close(got, want, rel=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), scale)


# -- GPT-2 BPE -----------------------------------------------------------------

TEXTS = ("lower lower", " low", "héllo ♪ a_b _ c", "x² ½ -- (( ))",
         "The quick brown fox, 42 times!", "  spaced\tout\nlines  ")


def _nonspeech_vocab(tmp_path):
    """tests/test_whisper_decode.py:78-97's vocabulary (the Ġ- / Ġ' / Ġâ
    merges of the real one)."""
    b2u = bpe.bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges = [("Ġ", "-"), ("Ġ", "'"), ("Ġ", "â")]
    tokens += [a + b for a, b in merges]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    vp, mp = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vp.write_text(json.dumps(vocab))
    mp.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(vp), str(mp)


@pytest.mark.parametrize("with_regex", [True, False])
@pytest.mark.parametrize("vocab", ["tiny", "nonspeech", "bytes"])
def test_gpt2_bpe_matches_jax(tmp_path, monkeypatch, with_regex, vocab):
    """encode, decode and non_speech_tokens byte for byte, under the `regex`
    module's \\p{L}/\\p{N} pattern and the stdlib `re` one."""
    if with_regex:
        pytest.importorskip("regex")
    else:
        monkeypatch.setitem(sys.modules, "regex", None)
    vp, mp = {"tiny": lambda: _write_tiny_vocab(tmp_path)[:2],
              "nonspeech": lambda: _nonspeech_vocab(tmp_path),
              "bytes": lambda: write_byte_vocab(tmp_path)}[vocab]()
    port, ref = bpe.WhisperEnTokenizer(vp, mp), jax_bpe.WhisperEnTokenizer(
        vp, mp)
    assert port.bpe.pat.pattern == ref.bpe.pat.pattern
    assert port.non_speech_tokens() == ref.non_speech_tokens()
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        ids = port.encode(text) + [port.EOT, port.TIMESTAMP_BEGIN]
        assert port.decode(ids) == ref.decode(ids)
        assert port.bpe.decode(ids) == ref.bpe.decode(ids)
    assert port.timestamp_to_seconds(50400) == ref.timestamp_to_seconds(50400)
    assert bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    for name in ("EOT", "SOT", "TRANSLATE", "TRANSCRIBE", "SOT_LM",
                 "SOT_PREV", "NO_SPEECH", "NO_TIMESTAMPS",
                 "TIMESTAMP_BEGIN", "TIME_PRECISION"):
        assert getattr(bpe.WhisperEnTokenizer, name) == getattr(
            jax_bpe.WhisperEnTokenizer, name)


# -- log-mel -------------------------------------------------------------------


@pytest.mark.parametrize("seconds", [3.0, 30.0, 41.5])
@pytest.mark.parametrize("pad", [True, False])
def test_log_mel_matches_jax_bytes(seconds, pad):
    audio = (np.random.default_rng(int(seconds)).normal(
        size=int(seconds * 16000)) * 0.1).astype(np.float32)
    got = mel.log_mel_spectrogram(audio, pad_to_chunk=pad)
    want = jax_mel.log_mel_spectrogram(audio, pad_to_chunk=pad)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert mel.mel_filters().tobytes() == jax_mel.mel_filters().tobytes()


# -- Whisper -------------------------------------------------------------------


def _whisper_pair(spec):
    """(JAX encoder params, decoder params, port encoder, decoder) on one
    seeded HF state dict: the JAX converters map it into flax, and
    whisper_from_jax carries that back into the port."""
    sd = whisper_state_dict(spec)
    jcfg = jax_whisper.WhisperConfig(**spec)
    enc_p = {"params": jax_whisper.convert_whisper_encoder(sd, jcfg)}
    dec_p = {"params": jax_whisper.convert_whisper_decoder(sd, jcfg)}
    back = whisper_from_jax(enc_p, dec_p)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    enc, dec = whisper.load_whisper(back, whisper.WhisperConfig(**spec),
                                    "cpu")
    return jcfg, enc_p, dec_p, enc, dec


@pytest.fixture(scope="module")
def tiny():
    return _whisper_pair(WHISPER_TINY)


def test_whisper_encoder_matches_jax(tiny):
    jcfg, enc_p, _, enc, _ = tiny
    x = np.random.default_rng(0).normal(
        size=(2, 2 * jcfg.max_source_positions, 80)).astype(np.float32)
    want = np.asarray(jax_whisper.WhisperEncoder(jcfg).apply(
        enc_p, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_whisper_decoder_matches_jax(tiny):
    jcfg, _, dec_p, _, dec = tiny
    rng = np.random.default_rng(1)
    enc_out = rng.normal(size=(2, 10, jcfg.d_model)).astype(np.float32)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    want = np.asarray(jax_whisper.WhisperDecoder(jcfg).apply(
        dec_p, jnp.asarray(ids), jnp.asarray(enc_out)))
    with torch.no_grad():
        got = dec(torch.from_numpy(ids), torch.from_numpy(enc_out))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_whisper_cached_step_matches_forward(tiny):
    """decode_step through the cache (slots past pos masked, a cache longer
    than the sequence) gives the uncached forward's logits, and JAX's
    decode_step's."""
    jcfg, _, dec_p, _, dec = tiny
    rng = np.random.default_rng(2)
    enc_out = rng.normal(size=(3, 10, jcfg.d_model)).astype(np.float32)
    ids = rng.integers(0, jcfg.vocab_size, size=(3, 9)).astype(np.int32)
    jdec = jax_whisper.WhisperDecoder(jcfg)
    jcross = jdec.apply(dec_p, jnp.asarray(enc_out),
                        method=jax_whisper.WhisperDecoder.cross_kv)
    jcache = jdec.apply(dec_p, 3, 16,
                        method=jax_whisper.WhisperDecoder.init_cache)
    with torch.no_grad():
        full = dec(torch.from_numpy(ids), torch.from_numpy(enc_out)).numpy()
        cross = dec.cross_kv(torch.from_numpy(enc_out))
        cache = dec.init_cache(3, 16)
        for t in range(ids.shape[1]):
            logits, cache = dec.decode_step(torch.from_numpy(ids[:, t]), t,
                                            cross, cache)
            want, jcache = jdec.apply(
                dec_p, jnp.asarray(ids[:, t]), t, jcross, jcache,
                method=jax_whisper.WhisperDecoder.decode_step)
            _close(logits.numpy(), full[:, t])
            _close(logits.numpy(), np.asarray(want))


def test_whisper_greedy_decode_matches_jax(tiny):
    jcfg, enc_p, dec_p, enc, dec = tiny
    x = np.random.default_rng(3).normal(
        size=(2, 2 * jcfg.max_source_positions, 80)).astype(np.float32)
    prompt = np.array([[5, 9, 11], [5, 2, 7]], dtype=np.int32)
    jenc = jax_whisper.WhisperEncoder(jcfg).apply(enc_p, jnp.asarray(x))
    for eot in (3, 150):  # 150: rows run to the end, 3: EOT held
        want = jax_whisper.greedy_decode(jax_whisper.WhisperDecoder(jcfg),
                                         dec_p, jenc, prompt, 12, eot)
        with torch.no_grad():
            got = whisper.greedy_decode(dec, enc(torch.from_numpy(x)),
                                        prompt, 12, eot)
        assert got.dtype == np.int32 and got.tolist() == want.tolist()


def test_whisper_hf_state_dict_loads_like_jax():
    """A synthetic HF state dict (under `model.`, with HF's stored encoder
    positions and proj_out): infer_whisper_config as JAX's, and the port's
    loader and the JAX converters give the same model."""
    sd = whisper_state_dict(WHISPER_TINY, seed=5)
    hf = {f"model.{k}": v for k, v in sd.items()}
    hf["model.encoder.embed_positions.weight"] = whisper.sinusoids(
        WHISPER_TINY["max_source_positions"], WHISPER_TINY["d_model"])
    hf["proj_out.weight"] = sd["decoder.embed_tokens.weight"]
    bare = {k[len("model."):]: v for k, v in hf.items()
            if k.startswith("model.")}
    cfg = whisper.infer_whisper_config(bare)
    jcfg = jax_whisper.infer_whisper_config(bare)
    assert vars(cfg) == vars(jcfg)
    # the universal head width of 64: one head at d=64
    assert cfg == whisper.WhisperConfig(**dict(WHISPER_TINY, heads=1))
    enc, dec = whisper.load_whisper(hf, cfg, "cpu")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 2 * jcfg.max_source_positions, 80)).astype(
        np.float32)
    ids = rng.integers(0, jcfg.vocab_size, size=(1, 5)).astype(np.int32)
    jenc = jax_whisper.WhisperEncoder(jcfg).apply(
        {"params": jax_whisper.convert_whisper_encoder(bare, jcfg)},
        jnp.asarray(x))
    want = jax_whisper.WhisperDecoder(jcfg).apply(
        {"params": jax_whisper.convert_whisper_decoder(bare, jcfg)},
        jnp.asarray(ids), jenc)
    with torch.no_grad():
        got = dec(torch.from_numpy(ids), enc(torch.from_numpy(x)))
    _close(got.numpy(), np.asarray(want))
    assert whisper.WhisperConfig() == whisper.WhisperConfig(
        **vars(jax_whisper.WhisperConfig()))


# -- decoding rules ------------------------------------------------------------


def test_rule_functions_match_jax():
    """The host rules are the JAX package's code: the same logits in, the
    same bits out."""
    tok = FakeTok()
    ts = tok.TIMESTAMP_BEGIN
    rng = np.random.default_rng(0)
    seqs = [[tok.SOT], [tok.SOT, ts, 65], [tok.SOT, ts, 65, ts + 100],
            [tok.SOT, ts + 50, 65, ts + 80, ts + 80, 66]]
    base = rng.normal(size=(len(seqs), FakeTok.VOCAB)) * 3
    base[:, ts: ts + 300] += 2.0
    for max_ts in (1.0, None):
        got, want = base.copy(), base.copy()
        wd.timestamp_rules(got, seqs, tok, 1, max_ts)
        jax_wd.timestamp_rules(want, seqs, tok, 1, max_ts)
        assert got.tobytes() == want.tobytes()
    for fn in ("log_softmax", "logsumexp_rows"):
        assert getattr(wd, fn)(got).tobytes() == getattr(jax_wd, fn)(
            got).tobytes()
    assert wd.logsumexp(got[1]) == jax_wd.logsumexp(got[1])
    for supp in ("-1", "3,9", (4, -1)):
        assert wd.build_suppress_list(tok, supp) == jax_wd.build_suppress_list(
            tok, supp)
    got, want = base.copy(), base.copy()
    wd.suppress_tokens_rule(got, [1, 5, 9])
    wd.suppress_blank_rule(got, 32, tok.EOT)
    jax_wd.suppress_tokens_rule(want, [1, 5, 9])
    jax_wd.suppress_blank_rule(want, 32, tok.EOT)
    assert got.tobytes() == want.tobytes()
    for text in ("ha" * 300, "The quick brown fox", ""):
        assert wd.compression_ratio(text) == jax_wd.compression_ratio(text)
    assert vars(wd.DecodeOptions()) == vars(jax_wd.DecodeOptions())
    for name in ("N_FRAMES", "INPUT_STRIDE", "FRAMES_PER_SECOND",
                 "TIME_PRECISION"):
        assert getattr(wd, name) == getattr(jax_wd, name)


SCRIPT_OPTIONS = {
    "greedy": dict(temperature=(0.0,), beam_size=None, best_of=1,
                   sample_len=24, compression_ratio_threshold=None,
                   logprob_threshold=None, no_speech_threshold=None),
    "beam": dict(temperature=(0.0,), beam_size=2, sample_len=8,
                 compression_ratio_threshold=None, logprob_threshold=None,
                 no_speech_threshold=None),
    "sampling": dict(temperature=(0.5, 0.9), best_of=3, sample_len=10),
    "defaults": dict(sample_len=24),  # every default but the length
}


def _result(r):
    """A DecodeResult's fields as text: its NaNs (no compression ratio
    before the fallback sets one) compare equal."""
    return repr((r.tokens, r.avg_logprob, r.no_speech_prob, r.temperature,
                 r.compression_ratio, r.text))


@pytest.mark.parametrize("mode", list(SCRIPT_OPTIONS))
def test_decode_on_scripted_adapters_matches_jax(mode):
    """decode_segment, decode_with_fallback and transcribe_with_rules on the
    scripted fake models of tests/test_whisper_decode.py (a script a
    window; a softer one for sampling), each package's rules on its own
    adapter instance: equal results and segments."""
    tok, ts = FakeTok(), FakeTok.TIMESTAMP_BEGIN
    script = [ts, 104, 105, ts + 100, ts + 100, 121, 111, ts + 1000,
              FakeTok.EOT]
    text_logit = 5.0 if mode in ("greedy", "beam") else -18.0
    opts = wd.DecodeOptions(**SCRIPT_OPTIONS[mode])
    jopts = jax_wd.DecodeOptions(**SCRIPT_OPTIONS[mode])
    got = wd.decode_segment(ScriptAdapter(script, text_logit=text_logit),
                            None, tok, opts, opts.temperature[0])
    want = jax_wd.decode_segment(ScriptAdapter(script, text_logit=text_logit),
                                 None, tok, jopts, jopts.temperature[0])
    assert _result(got) == _result(want)
    got = wd.decode_with_fallback(ScriptAdapter(script, text_logit=text_logit),
                                  None, tok, opts,
                                  rng=np.random.default_rng(1))
    want = jax_wd.decode_with_fallback(
        ScriptAdapter(script, text_logit=text_logit), None, tok, jopts,
        rng=np.random.default_rng(1))
    assert _result(got) == _result(want)
    audio = (0.1 * np.sin(np.arange(50 * 16000) / 16000 * 2 * np.pi * 440)
             ).astype(np.float32)
    got = wd.transcribe_with_rules(ScriptAdapter(script,
                                                 text_logit=text_logit),
                                   audio, tok, opts)
    want = jax_wd.transcribe_with_rules(ScriptAdapter(
        script, text_logit=text_logit), audio, tok, jopts)
    assert got == want and got["segments"]


def _decode_pair(spec):
    """(TorchWhisperAdapter, JaxWhisperAdapter) on shared seeded weights,
    each adapter's step also recording its logits."""
    _, enc_p, dec_p, enc, dec = _whisper_pair(spec)
    jcfg = jax_whisper.WhisperConfig(**spec)
    port = wd.TorchWhisperAdapter(enc, dec)
    ref = jax_wd.JaxWhisperAdapter(jax_whisper.WhisperEncoder(jcfg), enc_p,
                                   jax_whisper.WhisperDecoder(jcfg), dec_p)
    for a in (port, ref):
        a.logits = []
        step = a.step

        def recorded(state, tokens, pos, step=step, a=a):
            logits, state = step(state, tokens, pos)
            a.logits.append((np.asarray(tokens).copy(), pos, logits.copy()))
            return logits, state

        a.step = recorded
    return port, ref


RULE_OPTIONS = {
    "beam": dict(temperature=(0.0,), beam_size=3, sample_len=8,
                 compression_ratio_threshold=None, logprob_threshold=None,
                 no_speech_threshold=None),
    "fallback": dict(temperature=(0.15, 0.55), best_of=3, sample_len=8),
}


@pytest.mark.parametrize("mode", list(RULE_OPTIONS))
def test_transcribe_with_rules_matches_jax_adapter(tmp_path, mode):
    """transcribe_with_rules on 41 s of audio (two 30 s windows) through
    TorchWhisperAdapter against JaxWhisperAdapter, the tiny model on shared
    weights, a byte-level vocabulary. Every step's logits agree within
    1e-5 of their largest magnitude while both decodes are fed the same
    tokens; the segments (start, end, text, temperature and the rest)
    are then equal. Where the two logit roundings could put one token on
    either side of a sampling draw or an argmax, the decodes would part
    and the equality fail: the seed's draws keep clear of that by far more
    than the 1e-5 the logits are held to, so no tolerance is applied to
    the choices."""
    port, ref = _decode_pair(WHISPER_DECODE)
    tok = bpe.WhisperEnTokenizer(*write_byte_vocab(tmp_path))
    audio = (np.random.default_rng(0).normal(size=41 * 16000) * 0.1).astype(
        np.float32)
    opts = wd.DecodeOptions(**RULE_OPTIONS[mode])
    got = wd.transcribe_with_rules(port, audio, tok, opts)
    want = jax_wd.transcribe_with_rules(
        ref, audio, jax_bpe.WhisperEnTokenizer(*write_byte_vocab(tmp_path)),
        jax_wd.DecodeOptions(**RULE_OPTIONS[mode]))
    assert len(port.logits) == len(ref.logits) > 20
    for (gt, gp, gl), (wt, wp, wl) in zip(port.logits, ref.logits):
        assert gp == wp and np.array_equal(gt, wt)
        _close(gl, wl)
    _same_segments(got, want)
    assert len(got["segments"]) >= 2
    assert {s["start"] >= 30.0 for s in got["segments"]} == {True, False}


EXACT = ("start", "end", "text", "tokens", "temperature",
         "compression_ratio")


def _same_segments(got, want):
    """Equal segments: start, end, text, tokens, temperature and
    compression ratio exactly; avg_logprob and no_speech_prob, sums and
    softmaxes of logits held within 1e-5, within 1e-5 relative."""
    assert got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert sorted(g) == sorted(w)
        assert {k: g[k] for k in EXACT} == {k: w[k] for k in EXACT}
        for k in ("avg_logprob", "no_speech_prob"):
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (k, g[k], w[k])


# -- SRT, wav, the directories -------------------------------------------------


def test_srt_and_token_helpers_match_jax():
    ts = asr.TIMESTAMP_BEGIN
    toks = [ts, 10, ts + 75, ts + 75, 20, 50300, ts + 150, ts + 151, 30,
            asr.EOT, 40]
    fn = lambda ids: " ".join(f"w{i}" for i in ids)  # noqa: E731
    for offset in (0.0, 30.0, 3599.99):
        got = asr.tokens_to_segments(toks, fn, chunk_offset=offset)
        assert got == jax_asr.tokens_to_segments(toks, fn,
                                                 chunk_offset=offset)
        got[0]["text"] = "  padded  "
        assert asr.segments_to_srt(got) == jax_asr.segments_to_srt(got)
    for s in (0.0, 0.0005, 59.9996, 3600.5, 86399.999):
        assert asr.format_srt_timestamp(s) == jax_asr.format_srt_timestamp(s)
    for name in ("EOT", "SOT", "NO_TIMESTAMPS", "TIMESTAMP_BEGIN",
                 "TIME_PRECISION"):
        assert getattr(asr, name) == getattr(jax_asr, name)


def _write_wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(samples.astype(np.int16).tobytes())


def test_read_wav_matches_jax(tmp_path):
    samples = np.random.default_rng(0).integers(-32768, 32768, 16011)
    _write_wav(tmp_path / "a.wav", samples)
    got = asr.read_wav_mono16k(str(tmp_path / "a.wav"))
    want = jax_asr.read_wav_mono16k(str(tmp_path / "a.wav"))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_transcribe_audio_dir_without_whisper_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper", None)
    for fn in (asr.transcribe_audio_dir, jax_asr.transcribe_audio_dir):
        with pytest.raises(ImportError, match="openai-whisper"):
            fn(str(tmp_path), str(tmp_path / "srt"))


def _minilm_dir(root):
    """pretrained_dir with a seeded all-MiniLM-L6-v2-shaped checkpoint
    (`minilm.pt`) and a 30522-entry WordPiece vocabulary that holds the
    byte-level vocabulary's letters and digits."""
    import string

    root.mkdir(parents=True, exist_ok=True)
    sd = random_minilm_state_dict(MiniLmConfig(), seed=3)
    for k in sd:
        if k.endswith(("query.weight", "key.weight")):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               root / "minilm.pt")
    chars = list(string.ascii_lowercase + string.digits)
    words = chars + [f"##{c}" for c in chars]
    words += [f"w{i}" for i in range(30522 - 5 - len(words))]
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    return sd


def test_transcribe_and_embed_dirs_match_jax(tmp_path):
    """transcribe_audio_dir_torch and embed_srt_dir (the port's MiniLM at
    all-MiniLM-L6-v2's shape) end to end on the CPU against
    transcribe_audio_dir_jax and embed_srt_dir('minilm_jax') on the same
    checkpoint files: the same SRT bytes, embeddings within 1e-5, videos
    already done skipped."""
    from hirest_tpu.models.whisper import WhisperConfig as JaxCfg

    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(4)
    for name, seconds in (("v1", 12), ("v2", 33)):
        _write_wav(audio_dir / f"{name}.wav",
                   rng.normal(size=seconds * 16000) * 3000)
    sd = whisper_state_dict(WHISPER_DECODE, seed=2)
    ckpt = tmp_path / "whisper.bin"
    torch.save({f"model.{k}": torch.from_numpy(v) for k, v in sd.items()},
               ckpt)
    vp, mp = write_byte_vocab(tmp_path / "tok")
    opts = dict(temperature=(0.2, 0.6), best_of=2, sample_len=6)
    n = asr.transcribe_audio_dir_torch(
        str(audio_dir), str(tmp_path / "srt"), str(ckpt),
        config=whisper.WhisperConfig(**WHISPER_DECODE), vocab_path=vp,
        merges_path=mp, decode_options=wd.DecodeOptions(**opts),
        device="cpu")
    m = jax_asr.transcribe_audio_dir_jax(
        str(audio_dir), str(tmp_path / "jax_srt"), str(ckpt),
        config=JaxCfg(**WHISPER_DECODE), vocab_path=vp, merges_path=mp,
        decode_options=jax_wd.DecodeOptions(**opts))
    assert n == m == 2
    for name in ("v1", "v2"):
        got = (tmp_path / "srt" / f"{name}.srt").read_bytes()
        assert got == (tmp_path / "jax_srt" / f"{name}.srt").read_bytes()
        assert got.strip()
    assert asr.transcribe_audio_dir_torch(
        str(audio_dir), str(tmp_path / "srt"), str(ckpt),
        config=whisper.WhisperConfig(**WHISPER_DECODE), vocab_path=vp,
        merges_path=mp, device="cpu") == 0

    pre = tmp_path / "pretrained"
    _minilm_dir(pre)
    n = asr.embed_srt_dir(str(tmp_path / "srt"), str(tmp_path / "emb"),
                          pretrained_dir=str(pre), device="cpu")
    m = jax_asr.embed_srt_dir(str(tmp_path / "jax_srt"),
                              str(tmp_path / "jax_emb"),
                              pretrained_dir=str(pre))
    assert n == m == 2
    for name in ("v1", "v2"):
        got = np.load(tmp_path / "emb" / f"{name}.npy")
        want = np.load(tmp_path / "jax_emb" / f"{name}.npy")
        assert got.dtype == np.float32 and got.shape[1] == 384
        _close(got, want)
    assert asr.embed_srt_dir(str(tmp_path / "srt"), str(tmp_path / "emb"),
                             pretrained_dir=str(pre), device="cpu") == 0
    fn_out = tmp_path / "fn"
    asr.embed_srt_dir(str(tmp_path / "srt"), str(fn_out), encoder="fn",
                      encode_text_fn=lambda t: np.ones((len(t), 3)))
    assert np.load(fn_out / "v1.npy").shape[1] == 3
    with pytest.raises(FileNotFoundError):
        asr.embed_srt_dir(str(tmp_path / "srt"), str(tmp_path / "x"),
                          pretrained_dir=str(tmp_path / "none"),
                          device="cpu")


def test_greedy_transcriber_matches_jax(tmp_path):
    """The greedy mode (`use_rules=False`, fixed 30 s chunks) through a
    decode_text_fn: the same segments as JaxWhisperTranscriber's."""
    sd = whisper_state_dict(WHISPER_DECODE, seed=8)
    ckpt = tmp_path / "w.bin"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    audio = (np.random.default_rng(9).normal(size=35 * 16000) * 0.1).astype(
        np.float32)
    fn = lambda ids: ",".join(str(int(i)) for i in ids)  # noqa: E731
    cfg = whisper.WhisperConfig(**WHISPER_DECODE)
    port = asr.TorchWhisperTranscriber(str(ckpt), fn, config=cfg,
                                       max_new_tokens=12, device="cpu")
    ref = jax_asr.JaxWhisperTranscriber(
        str(ckpt), fn, config=jax_whisper.WhisperConfig(**WHISPER_DECODE),
        max_new_tokens=12)
    assert not port.use_rules
    assert port.transcribe(audio) == ref.transcribe(audio)
    with pytest.raises(ValueError, match="no tokenizer"):
        asr.TorchWhisperTranscriber(sd, fn, config=cfg, device="cpu",
                                    decode_options=wd.DecodeOptions())
    with pytest.raises(ValueError, match="decode_text_fn"):
        asr.TorchWhisperTranscriber(sd, config=cfg, device="cpu")


# -- MiniLM --------------------------------------------------------------------

MINILM_TINY = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=32)


@pytest.fixture(scope="module")
def minilm_pair():
    sd = random_minilm_state_dict(MiniLmConfig(**MINILM_TINY), seed=1)
    for k in sd:
        if k.endswith(("query.weight", "key.weight")):
            sd[k] = sd[k] * np.float32(QKV_GAIN)
    jcfg = jax_minilm.MiniLmConfig(**MINILM_TINY)
    params = {"params": jax_minilm.convert_minilm(sd, jcfg)}
    back = minilm_from_jax(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    hf = {f"0.auto_model.{k}": v for k, v in sd.items()}
    hf["0.auto_model.embeddings.position_ids"] = np.arange(32)[None]
    assert sorted(convert_minilm(hf)) == sorted(
        [*sd, "embeddings.position_ids"])
    model = load_minilm(hf, MiniLmConfig(**MINILM_TINY), "cpu")
    return jcfg, params, model


@pytest.mark.parametrize("types", [False, True])
def test_minilm_matches_jax(minilm_pair, types):
    jcfg, params, model = minilm_pair
    rng = np.random.default_rng(0)
    ids = rng.integers(1, jcfg.vocab_size, size=(3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    mask[2, 2:] = 0
    tt = (rng.integers(0, 2, size=(3, 10)).astype(np.int32) if types
          else None)
    jm = jax_minilm.MiniLmEncoder(jcfg)
    for pool in (False, True):
        want = np.asarray(jm.apply(params, jnp.asarray(ids),
                                   jnp.asarray(mask), pool=pool,
                                   token_type_ids=None if tt is None
                                   else jnp.asarray(tt)))
        with torch.no_grad():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                        pool=pool, token_type_ids=None if tt is None
                        else torch.from_numpy(tt)).numpy()
        _close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_minilm_embedder_rows_match_jax(tmp_path, n):
    """make_minilm_embedder at all-MiniLM-L6-v2's shape: the rows of a
    batch of 1, 5 and 9 texts (padded to 8, 8 and 16) within 1e-5 of the
    JAX embedder's."""
    sd = _minilm_dir(tmp_path)
    texts = [" ".join(f"w{(7 * i + j) % 90}" for j in range(3 + i % 4))
             + f" abc{i} x" for i in range(n)]
    embed = make_minilm_embedder(str(tmp_path / "minilm.pt"),
                                 str(tmp_path / "vocab.txt"), device="cpu")
    got = embed(texts)
    want = jax_minilm.make_minilm_embedder(str(tmp_path / "minilm.pt"),
                                           str(tmp_path / "vocab.txt"))(texts)
    assert got.shape == (n, 384) and got.dtype == np.float32
    _close(got, want)
    # a loaded state dict builds the same embedder
    again = make_minilm_embedder(sd, str(tmp_path / "vocab.txt"),
                                 device="cpu")(texts)
    assert np.array_equal(again, got)
