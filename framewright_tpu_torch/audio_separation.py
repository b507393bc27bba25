"""Audio source separation (vocals / background) and dialog enhancement:
the port of ``framewright_tpu/audio_separation.py``.

``AudioSeparator`` combines, per channel, the REPET repetition mask and
the syllabic modulation gate (the JAX package's numpy, copied: equal
results) with the learned conv-GRU band mask (``audio_sep_v1.npz``),
which runs on the card as in JAX (``models.audio_net``). Stems are
complementary: vocals + background == the input. With ``backend="auto"``
a missing or unreadable separator checkpoint leaves the DSP mask, as in
JAX. ``DialogEnhancer`` (EQ, compressor, limiter) is JAX's numpy.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from framewright_tpu_torch.audio import band_matrix, read_wav, write_wav
from framewright_tpu_torch.errors import InputError

logger = logging.getLogger(__name__)

FRAME = 960
HOP = 480


def _stft(x: np.ndarray, frame: int = FRAME, hop: int = HOP) -> np.ndarray:
    n = len(x)
    win = np.hanning(frame).astype(np.float32)
    n_frames = max(1, (n - frame) // hop + 1)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    idx = np.minimum(idx, n - 1)
    return np.fft.rfft(x[idx] * win, axis=1)


def _istft(spec: np.ndarray, n: int, frame: int = FRAME, hop: int = HOP) -> np.ndarray:
    win = np.hanning(frame).astype(np.float32)
    segs = np.fft.irfft(spec, n=frame, axis=1).astype(np.float32) * win
    out = np.zeros(n, np.float32)
    norm = np.zeros(n, np.float32)
    for i in range(segs.shape[0]):
        end = min(i * hop + frame, n)
        out[i * hop:end] += segs[i, : end - i * hop]
        norm[i * hop:end] += (win ** 2)[: end - i * hop]
    return out / np.maximum(norm, 1e-6)


def _smooth_time(m: np.ndarray, w: int = 3) -> np.ndarray:
    if m.shape[0] < w:
        return m
    k = np.ones(w, np.float32) / w
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, m)


@dataclass
class SeparationConfig:
    backend: str = "auto"         # auto | learned | dsp
    mask_floor: float = 0.02
    mod_lo_hz: float = 2.0        # syllabic modulation band
    mod_hi_hz: float = 10.0
    checkpoint: Optional[Path] = None
    device: str = "auto"          # the learned mask's


class AudioSeparator:
    """2-stem (vocals / background) spectral-mask separation."""

    def __init__(self, config: Optional[SeparationConfig] = None):
        self.config = config or SeparationConfig()
        self._sep_fn = None

    def _repet_mask(self, power: np.ndarray) -> np.ndarray:
        """Per-bin median over time models the sustained background; the
        excess is the voice."""
        med = np.median(power, axis=0, keepdims=True)
        excess = np.maximum(power - med, 0.0)
        return excess / (excess + med + 1e-12)

    def _modulation_gate(self, power: np.ndarray, sr: int, hop: int = HOP) -> np.ndarray:
        """Per-bin gate in [0.2, 1] from the 2-10 Hz share of each bin's
        log-envelope modulation."""
        env = np.log10(power + 1e-10)
        env = env - env.mean(axis=0, keepdims=True)
        t_frames = env.shape[0]
        spec = np.fft.rfft(env, axis=0)
        fr = np.fft.rfftfreq(t_frames, d=hop / sr)
        band = (fr >= self.config.mod_lo_hz) & (fr <= self.config.mod_hi_hz)
        tot = (np.abs(spec[1:]) ** 2).sum(axis=0) + 1e-12  # skip DC
        mod = (np.abs(spec[band]) ** 2).sum(axis=0) / tot
        gate = 0.2 + 0.8 / (1.0 + np.exp(-(mod - 0.35) * 12.0))
        return gate[None, :]

    def vocal_mask(self, power: np.ndarray, sr: int) -> np.ndarray:
        cfg = self.config
        mask = self._repet_mask(power)
        mask = mask * self._modulation_gate(power, sr)
        if cfg.backend in ("auto", "learned"):
            bmask = self._learned_band_mask(power)
            if bmask is not None:
                mask = np.sqrt(np.maximum(mask, 1e-6) * np.maximum(bmask, 1e-6))
            elif cfg.backend == "learned":
                logger.warning("no separator checkpoint; using DSP mask")
        mask = _smooth_time(mask)
        return np.clip(mask, cfg.mask_floor, 1.0 - cfg.mask_floor)

    def _learned_band_mask(self, power: np.ndarray) -> Optional[np.ndarray]:
        from framewright_tpu_torch.models import audio_net

        if self._sep_fn is None:
            try:
                self._sep_fn = audio_net.make_sep_mask_fn(self.config.checkpoint,
                                                          self.config.device)
            except InputError as e:            # the checkpoint is optional
                logger.debug("learned separator unavailable: %s", e)
                return None
        bandm = band_matrix(power.shape[1], audio_net.BANDS)
        band_pow = power @ bandm.T
        gains_b = self._sep_fn(band_pow)                   # (T, BANDS) vocals
        col = np.maximum(bandm.sum(axis=0), 1e-6)
        return np.clip(gains_b @ (bandm / col[None, :]), 0.0, 1.0)

    def separate(self, x: np.ndarray, sr: int) -> Dict[str, np.ndarray]:
        """x (n,) or (n, ch) float32 -> {"vocals", "background"} stems of
        the same shape, summing to x."""
        mono = x.ndim == 1
        xs = x[:, None] if mono else x
        n, ch = xs.shape
        voc = np.zeros_like(xs, dtype=np.float32)
        for c in range(ch):
            spec = _stft(xs[:, c].astype(np.float32))
            mask = self.vocal_mask(np.abs(spec) ** 2, sr)
            voc[:, c] = _istft(spec * mask, n)
        bg = xs.astype(np.float32) - voc
        if mono:
            voc, bg = voc[:, 0], bg[:, 0]
        return {"vocals": voc, "background": bg}

    def separate_file(self, src: Path, out_dir: Path) -> Dict[str, Path]:
        x, sr = read_wav(Path(src))
        stems = self.separate(x, sr)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = {}
        for name, data in stems.items():
            p = out_dir / f"{name}.wav"
            write_wav(p, np.clip(data, -1.0, 1.0), sr)
            paths[name] = p
        return paths


@dataclass
class DialogConfig:
    boost_db: float = 4.0         # presence boost at 3 kHz
    deess_db: float = -3.0        # 7 kHz cut
    highpass_hz: float = 120.0
    comp_threshold_db: float = -20.0
    comp_ratio: float = 3.0
    attack_ms: float = 5.0
    release_ms: float = 50.0
    limit: float = 0.95


def _peak_response(freqs: np.ndarray, f0: float, gain_db: float, q: float = 2.0) -> np.ndarray:
    """Magnitude of a peaking band (applied linear-phase)."""
    g = 10.0 ** (gain_db / 20.0)
    bw = f0 / q
    resp = 1.0 + (g - 1.0) * np.exp(-0.5 * ((freqs - f0) / bw) ** 2)
    return resp.astype(np.float32)


class DialogEnhancer:
    """Speech clarity chain: EQ, compression, limiting."""

    def __init__(self, config: Optional[DialogConfig] = None):
        self.config = config or DialogConfig()

    def _eq(self, x: np.ndarray, sr: int) -> np.ndarray:
        cfg = self.config
        n = len(x)
        spec = _stft(x)
        freqs = np.fft.rfftfreq(FRAME, 1.0 / sr)
        h = np.ones_like(freqs, np.float32)
        below = freqs < cfg.highpass_hz
        h[below] = (freqs[below] / max(cfg.highpass_hz, 1e-3)) ** 2
        h *= _peak_response(freqs, 3000.0, cfg.boost_db, q=2.0)
        h *= _peak_response(freqs, 7000.0, cfg.deess_db, q=2.0)
        return _istft(spec * h[None, :], n)

    def _compress(self, x: np.ndarray, sr: int) -> np.ndarray:
        cfg = self.config
        blk = max(1, int(sr * 0.005))              # 5 ms envelope blocks
        n_blk = -(-len(x) // blk)
        pad = np.pad(x, (0, n_blk * blk - len(x)))
        rms = np.sqrt((pad.reshape(n_blk, blk) ** 2).mean(axis=1) + 1e-12)
        a_att = float(np.exp(-5.0 / max(cfg.attack_ms, 1e-3)))
        a_rel = float(np.exp(-5.0 / max(cfg.release_ms, 1e-3)))
        env = np.empty_like(rms)
        e = rms[0]
        for i, r in enumerate(rms):
            a = a_att if r > e else a_rel
            e = a * e + (1 - a) * r
            env[i] = e
        env_db = 20.0 * np.log10(env + 1e-9)
        over = np.maximum(env_db - cfg.comp_threshold_db, 0.0)
        gain_db = -over * (1.0 - 1.0 / cfg.comp_ratio)
        gain = (10.0 ** (gain_db / 20.0)).astype(np.float32)
        g = np.repeat(gain, blk)[: len(x)]
        return x * g

    def process(self, x: np.ndarray, sr: int) -> np.ndarray:
        mono = x.ndim == 1
        xs = x[:, None] if mono else x
        out = np.empty_like(xs, dtype=np.float32)
        for c in range(xs.shape[1]):
            y = self._eq(xs[:, c].astype(np.float32), sr)
            out[:, c] = self._compress(y, sr)
        peak = float(np.abs(out).max()) + 1e-9
        if peak > self.config.limit:
            out *= self.config.limit / peak
        return out[:, 0] if mono else out

    def process_file(self, src: Path, dst: Path) -> Path:
        x, sr = read_wav(Path(src))
        write_wav(Path(dst), np.clip(self.process(x, sr), -1.0, 1.0), sr)
        return Path(dst)
