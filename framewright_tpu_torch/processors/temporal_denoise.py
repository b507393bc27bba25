"""Motion-compensated temporal denoising: the port of
``framewright_tpu.processors.temporal_denoise`` (``TemporalDenoiser``,
``FlickerReducer``).

A sliding window of 2r + 1 frames, cut at scene changes: the 2r
neighbour slots are aligned to the centre by the alignment IFNet's flow
(centre -> neighbour) and ``flow_warp``, then blended with photometric
weights exp(-d / s2), d the mean squared colour difference and s2 =
max(2 sigma^2, 2 x the median d over the real neighbours); slots past a
short window's end hold the centre under a zero weight. ``nafnet`` runs
``FW_nafnet_dn`` on the blend; ``bilateral`` a 3x3 edge-preserving filter
of the centre alone. The result is blended with the centre by
``strength`` (``chroma_only`` restores the centre's BT.601 luma) and
rounded to uint8. ``auto`` profiles the first max(8, 2r + 1) frames with
``NoiseProfiler`` and picks ``none``, ``temporal``, ``nafnet`` or
``bilateral`` and the strength.

On the card: each uint8 frame is uploaded once and the window stays
there; the blend, the flow net and NAFNet run in f32 (TF32 off: the
restorer holds ``hw.full_f32`` for the whole restore), one centre per
step as the JAX denoiser runs without a mesh, and the denoised frame
comes back to the host as uint8. The scene-change score
(``frame_pair_scores``) and the profile stay numpy on the host.
``restormer`` and ``flow_model="raft"`` are not ported (ROADMAP.md A6);
the JAX denoiser's random NAFNet when ``FW_nafnet_dn`` is missing is not
copied: a missing checkpoint raises ``InputError``.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import asdict, dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.hw import resolve_device
from framewright_tpu_torch.ops.warp import flow_warp
from framewright_tpu_torch.processors.base import to_float, to_uint8
from framewright_tpu_torch.processors.scene_detection import frame_pair_scores

logger = logging.getLogger(__name__)

METHODS = ("auto", "temporal", "nafnet", "bilateral", "none")
_BT601 = (0.299, 0.587, 0.114)


@dataclass
class TemporalDenoiseConfig:
    radius: int = 3                 # window = 2r+1
    strength: float = 0.5           # blend of denoised vs original
    method: str = "temporal"        # auto | temporal | nafnet | bilateral | none
    flow_model: str = "ifnet"       # the alignment flow net
    similarity_sigma: float = 0.08  # photometric rejection width ([0,1] units)
    scene_change_threshold: float = 0.30
    chroma_only: bool = False       # denoise chroma, keep luma
    weights_dir: Optional[str] = None   # FW_nafnet_dn.npz here, else packaged
    device: str = "cuda"            # cuda | cpu


@dataclass
class TemporalDenoiseResult:
    frames: int = 0
    scene_resets: int = 0
    profile: Optional[dict] = None  # NoiseProfile.to_dict() in auto mode

    def to_dict(self) -> dict:
        return asdict(self)


def check_method(method: str, flow_model: str = "ifnet") -> None:
    """``ConfigError`` for a method or flow net the port does not run."""
    if method == "restormer":
        raise ConfigError("denoise method 'restormer' needs models/restormer, not ported "
                          "yet: ROADMAP.md A6")
    if method not in METHODS:
        raise ConfigError(f"denoise method must be one of {METHODS}, got {method!r}")
    if flow_model != "ifnet":
        raise ConfigError(f"flow_model {flow_model!r} (RAFT) is not ported yet: "
                          "ROADMAP.md A6; the port aligns with ifnet")


def nanmedian(v: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of finite values: the linear-interpolated middle
    of the sorted values, low x 0.5 + high x 0.5 for an even count (not
    ``torch.nanmedian``, which returns the lower one), 0-d f32."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return lo if n % 2 else lo * 0.5 + hi * 0.5


class TemporalDenoiser:
    """Streaming sliding-window denoiser (``denoise_stream``)."""

    def __init__(self, config: Optional[TemporalDenoiseConfig] = None):
        self.config = config or TemporalDenoiseConfig()
        check_method(self.config.method, self.config.flow_model)
        self.device = resolve_device(self.config.device)
        self.flow_net = None
        self.naf = None
        self._dims = (0, 0)
        self.result = TemporalDenoiseResult()

    def setup(self, height: int = 0, width: int = 0) -> None:
        """Load the nets the method runs (``auto``: after its profile)."""
        cfg = self.config
        self._dims = (height, width)
        if cfg.method in ("auto", "none"):
            return
        from framewright_tpu_torch.models import registry
        from framewright_tpu_torch.models.nafnet import NAFNet

        if cfg.method in ("temporal", "nafnet") and cfg.radius > 0 and self.flow_net is None:
            self.flow_net = registry.load_align_ifnet(self.device)
        if cfg.method == "nafnet" and self.naf is None:
            spec, sd, src = registry.load_weights("FW_nafnet_dn", cfg.weights_dir,
                                                  allow_random=False)
            self.naf = NAFNet.from_state_dict(spec.arch_config, sd, self.device)
            logger.info("denoise NAFNet: %s", src)

    # -- the device step ------------------------------------------------------
    def upload(self, frame: np.ndarray) -> torch.Tensor:
        """A uint8 (H, W, 3) frame on the denoiser's device."""
        return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)

    def _slots(self, window: List[torch.Tensor], center_idx: int):
        """-> centre (H,W,3) f32, neighbours (2r,H,W,3) f32 (short windows
        padded with the centre), real neighbour count."""
        k = 2 * self.config.radius
        c = to_float(window[center_idx])
        nb = [f for i, f in enumerate(window) if i != center_idx]
        n_real = len(nb)
        nbs = to_float(torch.stack(nb)) if nb else c.new_zeros((0,) + c.shape)
        if n_real < k:
            nbs = torch.cat([nbs, c.expand(k - n_real, *c.shape)])
        return c, nbs, n_real

    def align(self, c: torch.Tensor, nbs: torch.Tensor) -> torch.Tensor:
        """The neighbours warped onto the centre by the flow centre ->
        neighbour (the JAX ``estimate_flow(c_rep, neighbors)``)."""
        return flow_warp(nbs, self.flow_net.estimate_flow(c.expand_as(nbs), nbs))

    def blend(self, c: torch.Tensor, warped: torch.Tensor, n_real: int) -> torch.Tensor:
        """Photometric blend of the warped slots into the centre; slots
        from ``n_real`` on weigh nothing."""
        sigma2 = 2.0 * self.config.similarity_sigma ** 2
        diff = ((warped - c) ** 2).mean(-1, keepdim=True)
        # the median over the real neighbours' values: the noise floor
        floor = nanmedian(diff[:n_real]) if n_real else diff.new_zeros(())
        s2 = torch.clamp(2.0 * floor, min=sigma2)
        m = torch.zeros(len(warped), device=warped.device)
        m[:n_real] = 1.0
        wgt = torch.exp(-diff / s2) * m[:, None, None, None]
        return (c + (warped * wgt).sum(0)) / (1.0 + wgt.sum(0))

    @staticmethod
    def bilateral(x: torch.Tensor) -> torch.Tensor:
        """3x3 edge-preserving filter of x (B,H,W,3); the shifts wrap
        around the frame (``jnp.roll``)."""
        acc = torch.zeros_like(x)
        wacc = torch.zeros_like(x[..., :1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sh = torch.roll(x, (dy, dx), dims=(1, 2))
                d2 = ((sh - x) ** 2).mean(-1, keepdim=True)
                w = torch.exp(-d2 / 0.01) * float(np.float32(np.exp(-(dy * dy + dx * dx) / 2.0)))
                acc = acc + sh * w
                wacc = wacc + w
        return acc / wacc

    def denoise_window(self, window: List[torch.Tensor], center_idx: int) -> np.ndarray:
        """One centre: uint8 device frames -> the denoised uint8 frame on
        the host."""
        cfg = self.config
        c, nbs, n_real = self._slots(window, center_idx)
        out = c
        if cfg.method in ("temporal", "nafnet") and len(nbs):
            out = self.blend(c, self.align(c, nbs), n_real)
        if cfg.method == "nafnet":
            out = self.naf.apply_padded(out[None])[0]
        elif cfg.method == "bilateral":
            out = self.bilateral(c[None])[0]
        blended = cfg.strength * out + (1.0 - cfg.strength) * c
        if cfg.chroma_only:
            # keep the centre's luma: the luma delta added to every channel
            w = torch.tensor(_BT601, dtype=torch.float32, device=c.device)
            blended = blended + ((c - blended) * w).sum(-1, keepdim=True)
        return to_uint8(blended.clamp(0.0, 1.0)).cpu().numpy()

    # -- the stream ---------------------------------------------------------------
    def _auto_configure(self, head: List[np.ndarray]) -> None:
        """Profile the head frames; set method, strength, rejection width
        and chroma_only from the profile, then load the method's nets."""
        from framewright_tpu_torch.processors.noise_profiler import NoiseProfiler

        cfg = self.config
        prof = NoiseProfiler(sample_frames=len(head)).analyze_frames(head)
        cfg.method = prof.recommended_denoiser
        if cfg.method != "none":
            cfg.strength = max(0.1, prof.recommended_strength)
            cfg.similarity_sigma = max(cfg.similarity_sigma, prof.similarity_sigma)
            cfg.chroma_only = prof.chroma_only
        self.result.profile = prof.to_dict()
        logger.info("auto denoise: %s strength=%.2f (noise %s, sigma %.2f)",
                    cfg.method, cfg.strength, prof.dominant_type.value,
                    prof.characteristics.luma_sigma)
        self.setup(*self._dims)

    def denoise_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        """Every frame once, denoised with its window; a look-ahead of r
        frames, windows cut at scene changes."""
        cfg = self.config
        if cfg.method == "auto":
            head = list(itertools.islice(frames_iter, max(8, 2 * cfg.radius + 1)))
            self._auto_configure(head)
            frames_iter = itertools.chain(head, frames_iter)
        if cfg.method == "none":
            for frame in frames_iter:
                self.result.frames += 1
                yield frame
            return
        r = cfg.radius
        buf: List[Tuple[np.ndarray, torch.Tensor]] = []   # (host, device) frames
        out_idx = 0

        def denoise(center_pos: int) -> np.ndarray:
            lo = max(0, center_pos - r)
            hi = min(len(buf), center_pos + r + 1)
            self.result.frames += 1
            return self.denoise_window([f for _, f in buf[lo:hi]], center_pos - lo)

        prev: Optional[np.ndarray] = None
        for frame in frames_iter:
            if prev is not None:
                score = float(frame_pair_scores(prev[None], frame[None])[0])
                if score >= cfg.scene_change_threshold:
                    # every frame before the cut, then a fresh window
                    while out_idx < len(buf):
                        yield denoise(out_idx)
                        out_idx += 1
                    self.result.scene_resets += 1
                    buf, out_idx = [], 0
            buf.append((frame, self.upload(frame)))
            prev = frame
            # frames whose forward context is complete
            while out_idx + r < len(buf):
                yield denoise(out_idx)
                out_idx += 1
                if out_idx > r:              # drop frames no window needs
                    buf = buf[out_idx - r:]
                    out_idx = r
        while out_idx < len(buf):
            yield denoise(out_idx)
            out_idx += 1


class FlickerReducer:
    """Global-luma temporal smoothing (numpy, on the host): each frame's
    mean scaled toward the mean over a centred window of ``window``
    frames, by ``strength``."""

    def __init__(self, window: int = 9, strength: float = 0.8):
        self.window = window
        self.strength = strength

    def reduce_stream(self, frames_iter: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        hist: List[float] = []
        buf: List[np.ndarray] = []
        half = self.window // 2
        for frame in frames_iter:
            buf.append(frame)
            hist.append(float(frame.astype(np.float32).mean()))
            if len(buf) > half:
                yield self._correct(buf, hist, len(buf) - half - 1)
            if len(buf) > self.window:
                buf.pop(0)
                hist.pop(0)
        start = max(0, len(buf) - half)
        for i in range(start, len(buf)):
            yield self._correct(buf, hist, i)

    def _correct(self, buf, hist, idx) -> np.ndarray:
        target = float(np.mean(hist))
        cur = hist[idx]
        if cur < 1e-3:
            return buf[idx]
        gain = 1.0 + self.strength * (target / cur - 1.0)
        out = buf[idx].astype(np.float32) * gain
        return np.clip(out, 0, 255).astype(np.uint8)
