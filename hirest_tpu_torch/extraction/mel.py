"""Log-mel spectrogram frontend for Whisper (pure NumPy, on the host).

An own copy of hirest_tpu/extraction/mel.py, byte-equal in its outputs
(the port imports nothing of the JAX package). Replicates the standard
Whisper feature pipeline: 16 kHz audio -> 400-point hann STFT with hop 160
-> 80 slaney-normalized mel bins -> log10 with an 8-dB dynamic-range floor
-> (x + 4) / 4.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE


def hertz_to_mel(freq):
    """Slaney-style mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(freq >= min_log_hertz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
                    mels)


def mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)), freq)


def mel_filters(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                n_mels: int = N_MELS) -> np.ndarray:
    """[n_fft//2 + 1, n_mels] triangular filterbank, slaney-normalized."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_min = hertz_to_mel(0.0)
    mel_max = hertz_to_mel(sr / 2.0)
    mel_points = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_points = mel_to_hertz(mel_points)

    fdiff = np.diff(hz_points)
    slopes = hz_points[None, :] - fft_freqs[:, None]      # [freq, n_mels+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))            # [freq, n_mels]

    enorm = 2.0 / (hz_points[2: n_mels + 2] - hz_points[:n_mels])
    return (fb * enorm[None, :]).astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, pad_to_chunk: bool = True) -> np.ndarray:
    """float32 mono 16 kHz audio -> [n_frames, 80] log-mel features."""
    audio = np.asarray(audio, dtype=np.float32)
    if pad_to_chunk:
        n = ((len(audio) // N_SAMPLES) + 1) * N_SAMPLES if len(audio) % N_SAMPLES \
            else max(len(audio), N_SAMPLES)
        audio = np.pad(audio, (0, max(0, n - len(audio))))

    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    # reflect-pad like torch.stft(center=True)
    padded = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    n_frames = 1 + (len(padded) - N_FFT) // HOP_LENGTH
    idx = np.arange(N_FFT)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    frames = padded[idx] * window[None, :]
    stft = np.fft.rfft(frames, axis=-1)
    magnitudes = np.abs(stft[:-1]) ** 2                   # whisper drops the last frame

    mel = magnitudes.astype(np.float32) @ mel_filters()
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
