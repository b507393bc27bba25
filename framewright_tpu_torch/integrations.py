"""External integrations (the port of ``framewright_tpu.integrations``):
webhooks (generic, Slack, Discord) attached to the port's ``EventBus``,
media-server library refreshes (Plex, Jellyfin, Emby), CMX3600 EDL export
from scene boundaries, and 3D LUTs (``.cube``) applied to frames. Sends
go through ``urllib`` with retries and report failure instead of
raising; ``apply_lut`` is numpy on the host, as in JAX."""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from framewright_tpu_torch.events import EventBus, EventType
from framewright_tpu_torch.security import validate_url

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Webhooks
# ---------------------------------------------------------------------------

@dataclass
class WebhookConfig:
    url: str
    kind: str = "generic"          # generic | slack | discord
    events: tuple = (EventType.JOB_COMPLETED, EventType.JOB_FAILED)
    timeout_s: float = 5.0
    retries: int = 2


class WebhookNotifier:
    def __init__(self, config: WebhookConfig):
        validate_url(config.url)
        self.config = config
        self.sent: List[Dict] = []   # record for tests/inspection

    def payload_for(self, event) -> Dict:
        base = {"event": event.type.value, "timestamp": event.timestamp,
                **event.data}
        if self.config.kind == "slack":
            return {"text": f"framewright: {event.type.value} "
                            f"{json.dumps(event.data, default=str)[:500]}"}
        if self.config.kind == "discord":
            return {"content": f"framewright: {event.type.value} "
                               f"{json.dumps(event.data, default=str)[:500]}"}
        return base

    def send(self, event) -> bool:
        payload = self.payload_for(event)
        body = json.dumps(payload, default=str).encode()
        req = urllib.request.Request(
            self.config.url, data=body,
            headers={"Content-Type": "application/json"})
        for attempt in range(self.config.retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=self.config.timeout_s):
                    self.sent.append(payload)
                    return True
            except (urllib.error.URLError, OSError) as exc:
                logger.warning("webhook attempt %d failed: %s", attempt + 1, exc)
                time.sleep(0.5 * (attempt + 1))
        return False

    def attach(self, bus: EventBus) -> None:
        for ev in self.config.events:
            bus.subscribe(self.send, ev)


# ---------------------------------------------------------------------------
# Media server refresh (Plex/Jellyfin/Emby)
# ---------------------------------------------------------------------------

@dataclass
class MediaServerConfig:
    kind: str                       # plex | jellyfin | emby
    base_url: str
    token: str = ""
    library: str = ""


class MediaServerNotifier:
    """Trigger a library rescan after an output lands."""

    def __init__(self, config: MediaServerConfig):
        validate_url(config.base_url)
        self.config = config

    def refresh_url(self) -> str:
        c = self.config
        if c.kind == "plex":
            return f"{c.base_url}/library/sections/all/refresh?X-Plex-Token={c.token}"
        if c.kind in ("jellyfin", "emby"):
            return f"{c.base_url}/Library/Refresh?api_key={c.token}"
        raise ValueError(f"unknown media server {c.kind}")

    def refresh(self, timeout_s: float = 5.0) -> bool:
        try:
            req = urllib.request.Request(self.refresh_url(), method="POST")
            with urllib.request.urlopen(req, timeout=timeout_s):
                return True
        except (urllib.error.URLError, OSError, ValueError) as exc:
            logger.warning("media server refresh failed: %s", exc)
            return False


# ---------------------------------------------------------------------------
# EDL export
# ---------------------------------------------------------------------------

def export_edl(scene_boundaries: List[int], total_frames: int, fps: float,
               title: str = "framewright") -> str:
    """CMX3600-style EDL from scene boundaries: one event a scene."""

    def tc(frame: int) -> str:
        total_s = frame / fps
        h = int(total_s // 3600)
        m = int(total_s % 3600 // 60)
        s = int(total_s % 60)
        f = int(round((total_s - int(total_s)) * fps))
        return f"{h:02d}:{m:02d}:{s:02d}:{f:02d}"

    lines = [f"TITLE: {title}", "FCM: NON-DROP FRAME", ""]
    starts = [0] + list(scene_boundaries)
    ends = list(scene_boundaries) + [total_frames]
    for i, (s0, s1) in enumerate(zip(starts, ends), start=1):
        if s1 <= s0:
            continue
        lines.append(
            f"{i:03d}  AX       V     C        "
            f"{tc(s0)} {tc(s1)} {tc(s0)} {tc(s1)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# LUT (.cube) application
# ---------------------------------------------------------------------------

def parse_cube_lut(text: str):
    """Parse a .cube 3D LUT -> (N, N, N, 3) float array."""
    size = 0
    rows: List[List[float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.upper().startswith("TITLE"):
            continue
        if line.upper().startswith("LUT_3D_SIZE"):
            size = int(line.split()[-1])
            continue
        if line.upper().startswith(("DOMAIN_", "LUT_1D")):
            continue
        parts = line.split()
        if len(parts) == 3:
            rows.append([float(p) for p in parts])
    if size == 0 or len(rows) != size ** 3:
        raise ValueError(f"bad .cube LUT (size={size}, rows={len(rows)})")
    # cube order: R fastest
    arr = np.asarray(rows, np.float32).reshape(size, size, size, 3)  # [B][G][R]
    return arr


def apply_lut(frame: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply a 3D LUT (trilinear) to a uint8 frame."""
    n = lut.shape[0]
    f = frame.astype(np.float32) / 255.0 * (n - 1)
    i0 = np.clip(f.astype(np.int32), 0, n - 2)
    frac = f - i0
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fr, fg, fb = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]

    def at(rb, gb, bb):
        return lut[b0 + bb, g0 + gb, r0 + rb]

    c00 = at(0, 0, 0) * (1 - fr) + at(1, 0, 0) * fr
    c10 = at(0, 1, 0) * (1 - fr) + at(1, 1, 0) * fr
    c01 = at(0, 0, 1) * (1 - fr) + at(1, 0, 1) * fr
    c11 = at(0, 1, 1) * (1 - fr) + at(1, 1, 1) * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    out = c0 * (1 - fb) + c1 * fb
    return np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)
