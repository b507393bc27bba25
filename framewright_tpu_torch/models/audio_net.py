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

Training (``train_mask_net``, ``train_separator``) is queued with the
rest of the on-device training (ROADMAP A16).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from framewright_tpu_torch.errors import InputError
from framewright_tpu_torch.hw import full_f32, resolve_device
from framewright_tpu_torch.models.registry import packaged_weights_dir

BANDS = 32
HIDDEN = 48
CONV_W = 5  # temporal conv width

DEFAULT_CKPT = packaged_weights_dir() / "audio_mask_v1.npz"
SEP_CKPT = packaged_weights_dir() / "audio_sep_v1.npz"
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


def gru_module(params: Dict[str, np.ndarray], device: torch.device) -> torch.nn.GRU:
    """``nn.GRU`` carrying JAX's GRU: gates (z, r, n) -> (r, z, n),
    ``bias_ih`` JAX's bias, ``bias_hh`` zero."""
    nh = HIDDEN

    def reorder(m: np.ndarray) -> np.ndarray:      # (..., 3H) z|r|n -> r|z|n
        return np.concatenate([m[..., nh:2 * nh], m[..., :nh], m[..., 2 * nh:]], axis=-1)

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

    @torch.no_grad()
    def __call__(self, band_pow: torch.Tensor) -> torch.Tensor:
        """band_pow (T, BANDS) -> gains (T, BANDS), on the net's device."""
        with full_f32():
            f = torch.log10(band_pow.to(self.device, torch.float32) + 1e-10)
            mu = f.mean(dim=-2, keepdim=True)
            sd = f.std(dim=-2, keepdim=True, unbiased=False) + 1e-3
            f = (f - mu) / sd                                       # (T, B)
            h = F.conv1d(f.T[None], self.conv_w, self.conv_b, padding=CONV_W // 2)[0].T
            hs, _ = self.gru(torch.relu(h)[:, None])                # (T, 1, H)
            return torch.sigmoid(hs[:, 0] @ self.out_w + self.out_b)


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
