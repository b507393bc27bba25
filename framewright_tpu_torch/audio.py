"""Audio restoration chain: the port of ``framewright_tpu/audio.py``.

WAV I/O with stdlib ``wave``; ``HumRemover``, ``ClickRemover``,
``SpectralDenoiser`` and ``Normalizer`` are the JAX package's numpy,
copied, so their outputs are equal. ``WienerMaskDenoiser`` runs, as the
JAX one does on its device, the framing, window, ``rfft``, band matrix,
noise floor, gains and ``irfft`` on the card in f32 (``torch.fft``, TF32
off); the overlap-add stays on the host, in the JAX order. Its noise
floor is JAX's ``percentile(band_pow, 20, axis=0)``: a sort and JAX's
linear rule, for any size (``torch.quantile`` refuses an input of more
than 2**24 elements when it reduces all of them; a (T, 32) band track
holds that many after ~87 minutes at 48 kHz).

The ``ai`` backend reads the packaged ``audio_mask_v1.npz`` (or
``AudioEnhanceConfig.ai_checkpoint``) and raises ``InputError`` naming
the file, before any compute, when it is missing or unreadable; the JAX
enhancer falls back to the Wiener estimator without a word there.

``write_wav`` truncates toward zero (``astype(np.int16)``, as JAX's), so
a sample within ~1e-6 of an integer code flips by one LSB under any
difference in the FFTs.
"""

from __future__ import annotations

import logging
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from framewright_tpu_torch.hw import full_f32, resolve_device

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# WAV I/O (stdlib)
# ---------------------------------------------------------------------------

def read_wav(path: Path) -> Tuple[np.ndarray, int]:
    """-> (samples float32 [-1,1] shape (n, channels), sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch), sr


def write_wav(path: Path, samples: np.ndarray, sample_rate: int) -> None:
    """samples float32 [-1,1] (n,) or (n, ch) -> 16-bit PCM WAV."""
    if samples.ndim == 1:
        samples = samples[:, None]
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


# ---------------------------------------------------------------------------
# Filters (numpy, as JAX's)
# ---------------------------------------------------------------------------

class HumRemover:
    """Notch out mains hum (50/60 Hz) and harmonics."""

    def __init__(self, base_freq: float = 50.0, harmonics: int = 4, q: float = 35.0):
        self.base_freq = base_freq
        self.harmonics = harmonics
        self.q = q

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        from scipy.signal import iirnotch, sosfiltfilt, tf2sos

        out = x.copy()
        for k in range(1, self.harmonics + 1):
            f = self.base_freq * k
            if f >= sr / 2:
                break
            b, a = iirnotch(f, self.q, fs=sr)
            out = sosfiltfilt(tf2sos(b, a), out, axis=0)
        return out.astype(np.float32)


class ClickRemover:
    """Impulse repair: outliers against a median envelope are
    interpolated across."""

    def __init__(self, threshold: float = 6.0, window: int = 31):
        self.threshold = threshold
        self.window = window

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        from scipy.ndimage import median_filter

        out = x.copy()
        for c in range(x.shape[1]):
            s = x[:, c]
            med = median_filter(s, size=self.window, mode="nearest")
            resid = s - med
            mad = np.median(np.abs(resid)) + 1e-9
            bad = np.abs(resid) > self.threshold * mad * 1.4826
            if bad.any():
                idx = np.arange(len(s))
                good = ~bad
                out[:, c] = np.where(bad, np.interp(idx, idx[good], s[good]), s)
        return out.astype(np.float32)


class SpectralDenoiser:
    """Spectral subtraction of a noise floor estimated from the quietest
    frames."""

    def __init__(self, strength: float = 1.0, frame: int = 1024,
                 noise_percentile: float = 10.0):
        self.strength = strength
        self.frame = frame
        self.noise_percentile = noise_percentile

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        n, ch = x.shape
        f = self.frame
        hop = f // 2
        win = np.hanning(f).astype(np.float32)
        out = np.zeros_like(x)
        norm = np.zeros(n, np.float32)
        for c in range(ch):
            s = x[:, c]
            n_frames = max(1, (n - f) // hop + 1)
            specs = []
            for i in range(n_frames):
                seg = s[i * hop:i * hop + f]
                if len(seg) < f:
                    seg = np.pad(seg, (0, f - len(seg)))
                specs.append(np.fft.rfft(seg * win))
            specs = np.stack(specs)
            mags = np.abs(specs)
            noise = np.percentile(mags, self.noise_percentile, axis=0)
            sub = np.maximum(mags - self.strength * noise[None, :], 0.1 * mags)
            cleaned = sub * np.exp(1j * np.angle(specs))
            for i in range(n_frames):
                seg = np.fft.irfft(cleaned[i]).astype(np.float32) * win
                end = min(i * hop + f, n)
                out[i * hop:end, c] += seg[: end - i * hop]
                if c == 0:
                    norm[i * hop:end] += (win ** 2)[: end - i * hop]
        norm = np.maximum(norm, 1e-6)
        return (out / norm[:, None]).astype(np.float32)


def band_matrix(n_bins: int, bands: int = 32) -> np.ndarray:
    """(bands, bins) triangular ERB-spaced analysis matrix (JAX's
    ``WienerMaskDenoiser._band_matrix``)."""
    bins = np.arange(n_bins)
    erb = 21.4 * np.log10(1 + 0.00437 * bins * 24000.0 / n_bins)
    edges = np.linspace(0, erb[-1], bands + 2)
    centers_bin = np.interp(edges, erb, bins)
    m = np.zeros((bands, n_bins), np.float32)
    for b in range(bands):
        lo, mid, hi = centers_bin[b], centers_bin[b + 1], centers_bin[b + 2]
        up = (bins - lo) / max(mid - lo, 1e-3)
        dn = (hi - bins) / max(hi - mid, 1e-3)
        m[b] = np.clip(np.minimum(up, dn), 0, 1)
    # DC and Nyquist sit outside the triangle peaks: folded into the
    # first and last band
    uncovered = m.sum(axis=0) < 1e-6
    m[0, uncovered & (bins < n_bins // 2)] = 1.0
    m[-1, uncovered & (bins >= n_bins // 2)] = 1.0
    m /= np.maximum(m.sum(axis=1, keepdims=True), 1e-6)
    return m


def percentile_linear(x: torch.Tensor, q: float, dim: int = 0) -> torch.Tensor:
    """``jnp.percentile(x, q, axis=dim)`` (method "linear"): a sort along
    ``dim``, then JAX's f32 rule ``lo * (1 - w) + hi * w`` at position
    ``q / 100 * (n - 1)``, for any size."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    lo_i, hi_i = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(lo_i))
    lo = s.select(dim, min(max(lo_i, 0), n - 1))
    hi = s.select(dim, min(max(hi_i, 0), n - 1))
    return lo * float(np.float32(1.0) - hw) + hi * float(hw)


class WienerMaskDenoiser:
    """Spectral-masking denoiser on the card: STFT, ERB band powers, a
    per-band gain mask (``mask_fn``, the learned net, or a Wiener gain
    over a percentile noise floor), iSTFT.

    ``mask_fn(band_pow)`` takes the (T, bands) f32 tensor on the card and
    returns its gains there (``models.audio_net.make_mask_fn``); a numpy
    callable is accepted too."""

    def __init__(self, strength: float = 1.0, frame: int = 960, hop: int = 480,
                 bands: int = 32, mask_fn=None, gain_floor: float = 0.08,
                 device: Union[str, torch.device, None] = "auto"):
        self.strength = strength
        self.frame = frame
        self.hop = hop
        self.bands = bands
        self.mask_fn = mask_fn
        self.gain_floor = gain_floor
        self.device = device

    def _band_matrix(self, n_bins: int) -> np.ndarray:
        return band_matrix(n_bins, self.bands)

    def _gains(self, band_pow: torch.Tensor) -> torch.Tensor:
        if self.mask_fn is None:
            noise = percentile_linear(band_pow, 20.0, 0) * 1.2
            snr = torch.clamp(band_pow / torch.clamp(noise * self.strength, min=1e-12) - 1.0,
                              min=0.0)
            return snr / (snr + 1.0)
        g = self.mask_fn(band_pow)
        if isinstance(g, np.ndarray):
            g = torch.from_numpy(np.asarray(g, np.float32)).to(band_pow.device)
        return g.float()

    def prepare(self, n: int) -> tuple:
        """The device constants for a track of n samples: the frames'
        sample indices (clamped to the track), the window, the band
        matrix and its column-normalised transpose for the synthesis."""
        dev = resolve_device(self.device)
        f, hop = self.frame, self.hop
        n_frames = max(1, (n - f) // hop + 1)
        idx = np.minimum(np.arange(n_frames)[:, None] * hop + np.arange(f)[None, :], n - 1)
        bandm = torch.from_numpy(self._band_matrix(f // 2 + 1)).to(dev)
        synth = bandm / torch.clamp(bandm.sum(0), min=1e-6)[None, :]
        return (torch.from_numpy(idx).to(dev),
                torch.from_numpy(np.hanning(f).astype(np.float32)).to(dev), bandm, synth)

    def spectral_pass(self, s: torch.Tensor, consts: tuple):
        """One channel (a tensor on the device) -> (its windowed frames
        after the gains, (T, frame); its band power, (T, bands)): frame,
        window, rfft, band power, gains, irfft."""
        idx, win, bandm, synth = consts
        spec = torch.fft.rfft(s[idx] * win, dim=1)                  # (T, bins)
        band_pow = (spec.abs() ** 2) @ bandm.T                      # (T, bands)
        gains_b = torch.clamp(self._gains(band_pow), min=self.gain_floor)
        gains = torch.clamp(gains_b @ synth, max=1.0)
        return torch.fft.irfft(spec * gains, n=self.frame, dim=1) * win, band_pow

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        n, ch = x.shape
        f, hop = self.frame, self.hop
        win = np.hanning(f).astype(np.float32)
        out = np.zeros_like(x)
        norm = np.zeros(n, np.float32)
        with full_f32():
            consts = self.prepare(n)
            for c in range(ch):
                s = torch.from_numpy(np.ascontiguousarray(x[:, c], np.float32)).to(consts[0].device)
                segs = self.spectral_pass(s, consts)[0].cpu().numpy()
                # the overlap-add on the host, in JAX's order
                for i in range(len(segs)):
                    end = min(i * hop + f, n)
                    out[i * hop:end, c] += segs[i, : end - i * hop]
                    if c == 0:
                        norm[i * hop:end] += (win ** 2)[: end - i * hop]
        norm = np.maximum(norm, 1e-6)
        return (out / norm[:, None]).astype(np.float32)


class Normalizer:
    """Loudness normalization to a target RMS dBFS."""

    def __init__(self, target_dbfs: float = -18.0, peak_limit: float = 0.98):
        self.target_dbfs = target_dbfs
        self.peak_limit = peak_limit

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        rms = float(np.sqrt(np.mean(x ** 2)) + 1e-9)
        target = 10 ** (self.target_dbfs / 20.0)
        gain = target / rms
        peak = float(np.abs(x).max() + 1e-9)
        gain = min(gain, self.peak_limit / peak)
        return (x * gain).astype(np.float32)


@dataclass
class AudioEnhanceConfig:
    denoise: bool = True
    denoise_strength: float = 1.0
    # ai (learned mask net) | wiener (masking) | spectral (subtraction)
    denoise_model: str = "wiener"
    ai_checkpoint: Optional[Path] = None   # default: the packaged audio_mask_v1.npz
    hum_removal: bool = True
    hum_freq: float = 50.0
    click_removal: bool = True
    normalize: bool = True
    target_dbfs: float = -18.0
    device: str = "auto"                   # the Wiener and mask-net stage's


class AudioEnhancer:
    """Clicks, hum, denoise, loudness, in JAX's order."""

    def __init__(self, config: Optional[AudioEnhanceConfig] = None):
        self.config = config or AudioEnhanceConfig()

    def _mask_fn(self):
        """The learned mask net from its checkpoint: ``InputError`` naming
        the file when it is missing or unreadable."""
        from framewright_tpu_torch.models import audio_net

        path = Path(self.config.ai_checkpoint or audio_net.DEFAULT_CKPT)
        return audio_net.make_mask_fn(audio_net.load_params(path), device=self.config.device)

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        cfg = self.config
        mask_fn = self._mask_fn() if cfg.denoise and cfg.denoise_model == "ai" else None
        if cfg.click_removal:
            x = ClickRemover().process(x, sr)
        if cfg.hum_removal:
            x = HumRemover(cfg.hum_freq).process(x, sr)
        if cfg.denoise:
            if cfg.denoise_model in ("ai", "wiener"):
                x = WienerMaskDenoiser(cfg.denoise_strength, mask_fn=mask_fn,
                                       device=cfg.device).process(x, sr)
            else:
                x = SpectralDenoiser(cfg.denoise_strength).process(x, sr)
        if cfg.normalize:
            x = Normalizer(cfg.target_dbfs).process(x, sr)
        return x

    def process_file(self, src: Path, dst: Path) -> Path:
        x, sr = read_wav(src)
        write_wav(dst, self.process(x, sr), sr)
        return Path(dst)


# ---------------------------------------------------------------------------
# A/V sync (numpy, as JAX's)
# ---------------------------------------------------------------------------

class AudioSyncAnalyzer:
    """Constant offset and linear drift between two tracks by windowed
    cross-correlation."""

    def __init__(self, window_s: float = 2.0, step_s: float = 10.0):
        self.window_s = window_s
        self.step_s = step_s

    @staticmethod
    def _xcorr_offset(a: np.ndarray, b: np.ndarray, sr: int,
                      max_lag_s: float = 1.0) -> float:
        max_lag = int(max_lag_s * sr)
        n = min(len(a), len(b))
        a = a[:n] - a[:n].mean()
        b = b[:n] - b[:n].mean()
        size = int(2 ** np.ceil(np.log2(2 * n)))
        fa = np.fft.rfft(a, size)
        fb = np.fft.rfft(b, size)
        corr = np.fft.irfft(fa * np.conj(fb))
        corr = np.concatenate([corr[-max_lag:], corr[:max_lag + 1]])
        return float((np.argmax(corr) - max_lag) / sr)

    def analyze(self, ref: np.ndarray, test: np.ndarray, sr: int):
        mono_r = ref.mean(axis=1) if ref.ndim > 1 else ref
        mono_t = test.mean(axis=1) if test.ndim > 1 else test
        w = int(self.window_s * sr)
        step = int(self.step_s * sr)
        points = []
        pos = 0
        while pos + w < min(len(mono_r), len(mono_t)):
            off = self._xcorr_offset(mono_r[pos:pos + w], mono_t[pos:pos + w], sr)
            points.append((pos / sr, off))
            pos += step
        if not points:
            off = self._xcorr_offset(mono_r, mono_t, sr)
            return {"offset_s": off, "drift_s_per_s": 0.0, "points": 1}
        ts = np.array([p[0] for p in points])
        offs = np.array([p[1] for p in points])
        if len(points) >= 2 and np.ptp(ts) > 0:
            drift = float(np.polyfit(ts, offs, 1)[0])
        else:
            drift = 0.0
        return {"offset_s": float(np.median(offs)), "drift_s_per_s": drift,
                "points": len(points)}


class AudioSyncCorrector:
    """Apply offset (pad/trim) and drift (resample) corrections."""

    @staticmethod
    def correct(x: np.ndarray, sr: int, offset_s: float = 0.0,
                drift_s_per_s: float = 0.0) -> np.ndarray:
        out = x
        if abs(drift_s_per_s) > 1e-6:
            n = out.shape[0]
            new_n = int(round(n * (1.0 + drift_s_per_s)))
            idx = np.linspace(0, n - 1, new_n)
            cols = [np.interp(idx, np.arange(n), out[:, c]) for c in range(out.shape[1])]
            out = np.stack(cols, axis=1).astype(np.float32)
        shift = int(round(offset_s * sr))
        if shift > 0:
            out = np.concatenate([np.zeros((shift, out.shape[1]), np.float32), out])
        elif shift < 0:
            out = out[-shift:]
        return out
