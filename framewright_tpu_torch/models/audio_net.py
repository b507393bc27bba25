"""The learned spectral-mask audio net: the port of
``framewright_tpu/models/audio_net.py``'s forward and checkpoint I/O.

A temporal conv over the 32 ERB band features, a GRU over time and a
per-band sigmoid head: band power (T, 32) -> gains (T, 32) in (0, 1).
The packaged checkpoints ``audio_mask_v1.npz`` (denoise) and
``audio_sep_v1.npz`` (the separator's vocals mask) are read as data
from the JAX package's weights directory.

JAX runs the GRU with ``lax.scan``; here it is ``nn.GRU`` (cuDNN's on
the card), which computes the same function once its weights are
reordered: JAX orders the gates (z, r, n) and has no hidden bias,
``nn.GRU`` orders them (r, z, n) and adds ``b_hn`` inside ``r * (...)``;
``gru_module`` moves the gates and sets ``bias_hh`` to zero.

Training is JAX's ``:106-293``: the synthetic speech, noise and music
(``synth_clean``, ``synth_noise``, ``synth_music``) and the band-power
examples (``make_batch``, ``make_batch_sep``, the band matrix the port's
own ``audio.band_matrix``), copied; ``train_mask_net`` and
``train_separator`` reproduce ``audio_mask_v1.npz`` and
``audio_sep_v1.npz`` with JAX's manual Adam (a constant rate, bias
correction by step) on the card unless ``device="cpu"``, under
``hw.deterministic``. The GRU trains as ``nn.GRU`` in JAX's gate order;
``bias_hh`` stays zero and takes no gradient. Each returned tree is in
JAX's layout (``MaskNet.params``); ``save_params`` writes it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.hw import deterministic, full_f32, resolve_device
from framewright_tpu_torch.models.registry import packaged_weights_dir

BANDS = 32
HIDDEN = 48
CONV_W = 5  # temporal conv width

DEFAULT_CKPT = packaged_weights_dir() / "audio_mask_v1.npz"
SEP_CKPT = packaged_weights_dir() / "audio_sep_v1.npz"
_INV_LN10 = float(np.float32(0.4342944819032518))
_KEYS = ("conv_w", "conv_b", "gru_wi", "gru_wh", "gru_b", "out_w", "out_b")


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's ``init_params(seed)``: the same numpy draws."""
    rng = np.random.default_rng(seed)

    def glorot(*shape):
        fan = (shape[0] + shape[-1]) / 2.0
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    return {
        "conv_w": glorot(CONV_W, BANDS, HIDDEN),
        "conv_b": np.zeros(HIDDEN, np.float32),
        "gru_wi": glorot(HIDDEN, 3 * HIDDEN),
        "gru_wh": glorot(HIDDEN, 3 * HIDDEN),
        "gru_b": np.zeros(3 * HIDDEN, np.float32),
        "out_w": glorot(HIDDEN, BANDS),
        "out_b": np.zeros(BANDS, np.float32),
    }


def load_params(path: Optional[Path] = None) -> Dict[str, np.ndarray]:
    """A checkpoint's arrays; ``InputError`` naming the file when it is
    missing, unreadable or lacks a key."""
    path = Path(path or DEFAULT_CKPT)
    if not path.is_file():
        raise InputError(f"missing audio mask checkpoint: {path}")
    try:
        with np.load(path) as z:
            params = {k: np.asarray(z[k], np.float32) for k in _KEYS}
    except Exception as exc:  # noqa: BLE001 - zip, header or key faults
        raise InputError(f"unreadable audio mask checkpoint {path}: {exc}") from exc
    return params


def _reorder(m: np.ndarray) -> np.ndarray:
    """(..., 3H) gates z|r|n -> r|z|n, and back (the swap is its own inverse)."""
    nh = HIDDEN
    return np.concatenate([m[..., nh:2 * nh], m[..., :nh], m[..., 2 * nh:]], axis=-1)


def gru_module(params: Dict[str, np.ndarray], device: torch.device) -> torch.nn.GRU:
    """``nn.GRU`` carrying JAX's GRU: gates (z, r, n) -> (r, z, n),
    ``bias_ih`` JAX's bias, ``bias_hh`` zero."""
    nh = HIDDEN
    reorder = _reorder

    gru = torch.nn.GRU(nh, nh)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.from_numpy(reorder(params["gru_wi"]).T.copy()))
        gru.weight_hh_l0.copy_(torch.from_numpy(reorder(params["gru_wh"]).T.copy()))
        gru.bias_ih_l0.copy_(torch.from_numpy(reorder(params["gru_b"])))
        gru.bias_hh_l0.zero_()
    return gru.requires_grad_(False).to(device).eval()


class MaskNet:
    """The net's weights on a device, and its forward."""

    def __init__(self, params: Dict[str, np.ndarray],
                 device: Union[str, torch.device, None] = "auto"):
        self.device = resolve_device(device)

        def t(k):
            return torch.from_numpy(np.asarray(params[k], np.float32)).to(self.device)

        # (W, B, H) -> conv1d's (H, B, W)
        self.conv_w = t("conv_w").permute(2, 1, 0).contiguous()
        self.conv_b = t("conv_b")
        self.out_w, self.out_b = t("out_w"), t("out_b")
        self.gru = gru_module(params, self.device)

    def forward(self, band_pow: torch.Tensor) -> torch.Tensor:
        """band_pow (T, BANDS) -> gains (T, BANDS), keeping the graph."""
        with full_f32():
            # jnp.log10 and jnp.std as JAX computes them: log times the f32
            # 1 / ln 10, the root of the mean squared deviation (a band of
            # nearly constant power divides its ulps by a deviation ~1e-3)
            f = torch.log(band_pow.to(self.device, torch.float32) + 1e-10) * _INV_LN10
            mu = f.mean(dim=-2, keepdim=True)
            sd = ((f - mu) ** 2).mean(dim=-2, keepdim=True).sqrt() + 1e-3
            f = (f - mu) / sd                                       # (T, B)
            h = F.conv1d(f.T[None], self.conv_w, self.conv_b, padding=CONV_W // 2)[0].T
            hs, _ = self.gru(torch.relu(h)[:, None])                # (T, 1, H)
            return torch.sigmoid(hs[:, 0] @ self.out_w + self.out_b)

    @torch.no_grad()
    def __call__(self, band_pow: torch.Tensor) -> torch.Tensor:
        """band_pow (T, BANDS) -> gains (T, BANDS), on the net's device."""
        return self.forward(band_pow)

    def trainable(self) -> list:
        """The tensors training updates (``bias_hh`` is not one: JAX's GRU
        has no hidden bias)."""
        g = self.gru
        return [self.conv_w, self.conv_b, g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0,
                self.out_w, self.out_b]

    def params(self) -> Dict[str, np.ndarray]:
        """The weights in JAX's layout (``init_params``'s keys), f32 numpy."""
        def a(t):
            return t.detach().float().cpu().numpy()

        g = self.gru
        return {"conv_w": np.ascontiguousarray(a(self.conv_w).transpose(2, 1, 0)),
                "conv_b": a(self.conv_b),
                "gru_wi": np.ascontiguousarray(_reorder(a(g.weight_ih_l0).T)),
                "gru_wh": np.ascontiguousarray(_reorder(a(g.weight_hh_l0).T)),
                "gru_b": _reorder(a(g.bias_ih_l0)),
                "out_w": a(self.out_w), "out_b": a(self.out_b)}


def apply(params: Dict[str, np.ndarray], band_pow: torch.Tensor) -> torch.Tensor:
    """band_pow (T, BANDS) -> gains (T, BANDS) in (0, 1) (JAX's ``apply``),
    on band_pow's device."""
    return MaskNet(params, band_pow.device)(band_pow)


def make_mask_fn(params: Optional[Dict[str, np.ndarray]] = None,
                 device: Union[str, torch.device, None] = "auto"):
    """-> mask_fn(band_pow) -> gains for ``WienerMaskDenoiser(mask_fn=...)``:
    a tensor in, a tensor out on the net's device; numpy in, numpy out."""
    net = MaskNet(params if params is not None else load_params(), device)

    def mask_fn(band_pow):
        if isinstance(band_pow, np.ndarray):
            return net(torch.from_numpy(np.asarray(band_pow, np.float32))).cpu().numpy()
        return net(band_pow)

    return mask_fn


def make_sep_mask_fn(path: Optional[Path] = None,
                     device: Union[str, torch.device, None] = "auto"):
    """-> fn(band_pow (T, B)) -> vocals band gains, from the separator
    checkpoint (``InputError`` when it is absent)."""
    return make_mask_fn(load_params(path or SEP_CKPT), device)


# ---------------------------------------------------------------------------
# Synthetic training data (JAX's ``:106-228``, copied)
# ---------------------------------------------------------------------------

def synth_clean(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Speech-like synthetic clean audio: gliding harmonic stacks with AM
    envelopes and pauses."""
    t = np.arange(n) / sr
    x = np.zeros(n, np.float32)
    n_seg = max(1, n // (sr // 2))
    for _ in range(n_seg):
        f0 = rng.uniform(90, 280)
        glide = rng.uniform(-30, 30)
        start = rng.integers(0, max(1, n - sr // 4))
        dur = int(rng.uniform(0.15, 0.5) * sr)
        seg = slice(start, min(n, start + dur))
        ts = t[seg] - t[seg][0] if seg.stop > seg.start else t[seg]
        env = np.hanning(len(ts)) * rng.uniform(0.3, 1.0)
        partial = np.zeros(len(ts), np.float32)
        for k in range(1, 6):
            a = 1.0 / k ** rng.uniform(0.8, 1.5)
            partial += a * np.sin(2 * np.pi * (f0 + glide * ts) * k * ts
                                  + rng.uniform(0, 2 * np.pi))
        x[seg] += (env * partial).astype(np.float32)
    peak = np.abs(x).max() + 1e-6
    return 0.5 * x / peak


def synth_noise(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """White, pink and hum noise mixture."""
    white = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(rng.standard_normal(n))
    freq = np.maximum(np.fft.rfftfreq(n, 1 / sr), 1.0)
    pink = np.fft.irfft(spec / np.sqrt(freq), n=n).astype(np.float32)
    pink /= np.abs(pink).max() + 1e-6
    hum = np.zeros(n, np.float32)
    if rng.random() < 0.5:
        base = rng.choice([50.0, 60.0])
        t = np.arange(n) / sr
        for k in range(1, 4):
            hum += np.sin(2 * np.pi * base * k * t).astype(np.float32) / k
        hum *= 0.3
    w = rng.dirichlet([1.0, 1.0, 0.5])
    mix = w[0] * white / 3.0 + w[1] * pink + w[2] * hum
    return mix.astype(np.float32)


def synth_music(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Music-like background: sustained chord stacks with slow attacks and
    light vibrato."""
    t = np.arange(n) / sr
    x = np.zeros(n, np.float32)
    roots = rng.choice([110.0, 130.8, 146.8, 164.8], size=2, replace=False)
    for root in roots:
        for ratio in (1.0, 1.25, 1.5, 2.0):
            f = root * ratio * rng.uniform(0.998, 1.002)
            vib = 1.0 + 0.002 * np.sin(2 * np.pi * rng.uniform(4, 6) * t)
            amp = rng.uniform(0.1, 0.3) / ratio
            x += (amp * np.sin(2 * np.pi * f * vib * t
                               + rng.uniform(0, 2 * np.pi))).astype(np.float32)
    swell = 0.8 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.05, 0.2) * t)
    x *= swell.astype(np.float32)
    peak = np.abs(x).max() + 1e-6
    return 0.5 * x / peak


def _band_powers(target: np.ndarray, other: np.ndarray, frame: int, hop: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(band power of target + other (T, B), the target's IRM (T, B))."""
    from framewright_tpu_torch.audio import band_matrix

    win = np.hanning(frame).astype(np.float32)
    n_frames = (len(target) - frame) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    ts = np.abs(np.fft.rfft(target[idx] * win, axis=1)) ** 2
    os_ = np.abs(np.fft.rfft(other[idx] * win, axis=1)) ** 2
    mix = np.abs(np.fft.rfft((target + other)[idx] * win, axis=1)) ** 2
    bm = band_matrix(ts.shape[1], BANDS).T                  # (bins, B)
    tb, ob, mb = ts @ bm, os_ @ bm, mix @ bm
    irm = np.sqrt(tb / np.maximum(tb + ob, 1e-12)).astype(np.float32)
    return mb.astype(np.float32), irm


def make_batch(rng: np.random.Generator, sr: int = 48000, seconds: float = 1.5,
               frame: int = 960, hop: int = 480) -> Tuple[np.ndarray, np.ndarray]:
    """One training example: (noisy band power (T, B), IRM target (T, B))."""
    n = int(sr * seconds)
    clean = synth_clean(rng, n, sr)
    noise = synth_noise(rng, n, sr)
    snr_db = rng.uniform(-5, 20)
    cp = np.sqrt(np.mean(clean ** 2)) + 1e-9
    npow = np.sqrt(np.mean(noise ** 2)) + 1e-9
    noise = noise * (cp / npow) * 10 ** (-snr_db / 20)
    return _band_powers(clean, noise, frame, hop)


def make_batch_sep(rng: np.random.Generator, sr: int = 48000, seconds: float = 1.5,
                   frame: int = 960, hop: int = 480) -> Tuple[np.ndarray, np.ndarray]:
    """Separation example: (mixture band power (T, B), vocals IRM)."""
    n = int(sr * seconds)
    voc = synth_clean(rng, n, sr)
    mus = synth_music(rng, n, sr)
    smr_db = rng.uniform(-6, 12)
    vp = np.sqrt(np.mean(voc ** 2)) + 1e-9
    mp = np.sqrt(np.mean(mus ** 2)) + 1e-9
    mus = mus * (vp / mp) * 10 ** (-smr_db / 20)
    return _band_powers(voc, mus, frame, hop)


# ---------------------------------------------------------------------------
# Training (JAX's ``:229-293``: the manual Adam with a constant rate)
# ---------------------------------------------------------------------------

def fit(params: Dict[str, np.ndarray], example: Callable[[], Tuple[np.ndarray, np.ndarray]],
        weighted: bool, steps: int, lr: float, device="auto", log_every: int = 0,
        log_prefix: str = "", report: Optional[dict] = None) -> MaskNet:
    """Train the net from ``params`` on ``example()`` batches -> the
    ``MaskNet``: the squared error of the gains to the IRM (``weighted``:
    active-speech bands, IRM > 0.5, count twice), JAX's Adam (b1 0.9, b2
    0.999, eps 1e-8, bias correction by step, constant ``lr``)."""
    net = MaskNet(params, device)
    tensors = net.trainable()
    for t in tensors:
        t.requires_grad_(True)
    net.gru.train()                 # cuDNN's RNN backward runs in training mode
    m = [torch.zeros_like(t) for t in tensors]
    v = [torch.zeros_like(t) for t in tensors]
    losses = []
    with deterministic() as nondeterministic:
        for step in range(1, steps + 1):
            x, y = (torch.from_numpy(a).to(net.device) for a in example())
            with full_f32():
                err = (net.forward(x) - y) ** 2
                loss = ((1.0 + (y > 0.5).float()) * err if weighted else err).mean()
            for t in tensors:
                t.grad = None
            with full_f32():
                loss.backward()
            with torch.no_grad():
                for t, mk, vk in zip(tensors, m, v):
                    g = t.grad
                    mk.mul_(0.9).add_(0.1 * g)
                    vk.mul_(0.999).add_(0.001 * g * g)
                    mh = mk / (1 - 0.9 ** step)
                    vh = vk / (1 - 0.999 ** step)
                    t.sub_(lr * mh / (vh.sqrt() + 1e-8))
            losses.append(loss.detach())
            if log_every and step % log_every == 0:
                print(f"{log_prefix}step {step}: loss {float(loss.detach()):.4f}")
    for t in tensors:
        t.requires_grad_(False)
    net.gru.eval()
    if report is not None:
        report["losses"] = [float(x) for x in losses]
        report["nondeterministic_ops"] = nondeterministic
    return net


def train_mask_net(steps: int = 300, seed: int = 0, lr: float = 2e-3, log_every: int = 0,
                   device="auto", report: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """JAX's ``train_mask_net``: the denoise mask from ``init_params(seed)``
    on ``make_batch`` examples of ``default_rng(seed + 1)``, the loss
    weighting active speech twice -> the tree (``audio_mask_v1.npz``)."""
    rng = np.random.default_rng(seed + 1)
    return fit(init_params(seed), lambda: make_batch(rng), True, steps, lr, device,
               log_every, "", report).params()


def train_separator(steps: int = 400, seed: int = 0, lr: float = 2e-3, log_every: int = 0,
                    device="auto", report: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """JAX's ``train_separator``: the vocals band mask from
    ``init_params(seed + 100)`` on ``make_batch_sep`` examples of
    ``default_rng(seed + 101)`` -> the tree (``audio_sep_v1.npz``)."""
    rng = np.random.default_rng(seed + 101)
    return fit(init_params(seed + 100), lambda: make_batch_sep(rng), False, steps, lr, device,
               log_every, "sep ", report).params()


def save_params(params: Dict[str, np.ndarray], path: Path) -> Path:
    """Write a tree as JAX's ``save_params`` does (``np.savez`` of its keys;
    the path is the caller's: the packaged checkpoints are the JAX
    package's data)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **params)
    return path
