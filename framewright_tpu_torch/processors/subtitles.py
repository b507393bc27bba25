"""Burnt-in subtitle analysis, SRT I/O, time sync and cleanup: the port
of ``framewright_tpu/processors/subtitles.py`` (the same numpy, so its
events, tracks and SRT text equal the JAX package's).

``SubtitleTimingExtractor`` segments subtitle on/off events from the
activity of the subtitle band, with an injectable ``ocr_fn`` for the
text (``processors.ocr``); ``export_srt``, ``parse_srt`` and
``format_srt`` write and read SRT; ``SubtitleTimeSync`` shifts, rescales
and re-times a track against detected events or speech onsets
(``speech_onsets``); ``SubtitleEnhancer`` cleans OCR text.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class SubtitleEvent:
    index: int
    start_frame: int
    end_frame: int
    text: str = ""

    def timing(self, fps: float):
        return self.start_frame / fps, self.end_frame / fps


def _crop_region(frame: np.ndarray, region: str) -> np.ndarray:
    """Select the text band (reference subtitle_region: bottom|top|full)."""
    h = frame.shape[0]
    if region == "top":
        return frame[: int(h * 0.28)]
    if region == "full":
        return frame
    return frame[int(h * 0.72):]


def _band_activity(frame: np.ndarray, region: str = "bottom") -> float:
    """Text-likeness of the subtitle band: bright high-contrast strokes."""
    band = _crop_region(frame, region).astype(np.float32).mean(-1)
    bright = band > 180
    gx = np.abs(np.diff(band, axis=1)).mean()
    return float(bright.mean() * 50 + gx / 8.0)


class SubtitleTimingExtractor:
    """Detect subtitle on/off segments from band activity."""

    def __init__(self, threshold: float = 1.0, min_frames: int = 6,
                 merge_gap: int = 3,
                 ocr_fn: Optional[Callable[[np.ndarray], str]] = None,
                 region: str = "bottom"):
        self.threshold = threshold
        self.min_frames = min_frames
        self.merge_gap = merge_gap
        self.ocr_fn = ocr_fn
        self.region = region

    def analyze(self, frames_iter: Iterator[np.ndarray]) -> List[SubtitleEvent]:
        activity: List[float] = []
        samples: dict = {}
        for i, f in enumerate(frames_iter):
            activity.append(_band_activity(f, self.region))
            if self.ocr_fn is not None:
                samples[i] = f
        if not activity:
            return []
        arr = np.asarray(activity)
        base = np.median(arr)
        on = arr > (base + self.threshold)
        events: List[SubtitleEvent] = []
        start = None
        for i, v in enumerate(on):
            if v and start is None:
                start = i
            elif not v and start is not None:
                events.append(SubtitleEvent(len(events) + 1, start, i))
                start = None
        if start is not None:
            events.append(SubtitleEvent(len(events) + 1, start, len(on)))
        # merge close events, drop blips
        merged: List[SubtitleEvent] = []
        for ev in events:
            if merged and ev.start_frame - merged[-1].end_frame <= self.merge_gap:
                merged[-1].end_frame = ev.end_frame
            else:
                merged.append(ev)
        merged = [e for e in merged if e.end_frame - e.start_frame >= self.min_frames]
        for k, e in enumerate(merged):
            e.index = k + 1
            if self.ocr_fn is not None:
                mid = (e.start_frame + e.end_frame) // 2
                frame = samples.get(mid)
                if frame is not None:
                    try:
                        e.text = self.ocr_fn(frame)
                    except Exception:  # noqa: BLE001 - OCR isolation
                        logger.exception("ocr failed for event %d", e.index)
        return merged


def _srt_time(seconds: float) -> str:
    ms = int(round(seconds * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def export_srt(events: List[SubtitleEvent], fps: float,
               placeholder: str = "[subtitle]") -> str:
    """Events -> SRT text (reference SRT export)."""
    blocks = []
    for e in events:
        t0, t1 = e.timing(fps)
        blocks.append(
            f"{e.index}\n{_srt_time(t0)} --> {_srt_time(t1)}\n"
            f"{e.text or placeholder}\n")
    return "\n".join(blocks)


def shift_events(events: List[SubtitleEvent], offset_frames: int) -> List[SubtitleEvent]:
    """Timing resync (reference SubtitleTimeSync)."""
    out = []
    for e in events:
        out.append(SubtitleEvent(
            e.index, max(0, e.start_frame + offset_frames),
            max(0, e.end_frame + offset_frames), e.text))
    return out


# ---------------------------------------------------------------------------
# Subtitle tracks (seconds domain), SRT round-trip, time sync, enhancer
# (reference subtitles.py: SubtitleLine/SubtitleTrack, SubtitleTimeSync:904,
#  SubtitleEnhancer:1103)
# ---------------------------------------------------------------------------

import re as _re


@dataclass
class SubtitleLine:
    index: int
    start: float               # seconds
    end: float
    text: str = ""
    position: Optional[tuple] = None   # (x, y) px when known (OCR box)


@dataclass
class SubtitleTrack:
    lines: List[SubtitleLine] = field(default_factory=list)
    language: str = ""
    title: str = ""

    def adjust_timing(self, factor: float, offset: float = 0.0
                      ) -> "SubtitleTrack":
        return SubtitleTrack(
            lines=[SubtitleLine(l.index, max(0.0, l.start * factor + offset),
                                max(0.0, l.end * factor + offset),
                                l.text, l.position) for l in self.lines],
            language=self.language, title=self.title)


_SRT_TIME = _re.compile(
    r"(\d+):(\d\d):(\d\d)[,.](\d{1,3})\s*-->\s*(\d+):(\d\d):(\d\d)[,.](\d{1,3})")


def parse_srt(text: str) -> SubtitleTrack:
    """SRT text -> SubtitleTrack (round-trips with format_srt)."""
    lines: List[SubtitleLine] = []
    blocks = _re.split(r"\n\s*\n", text.strip().replace("\r\n", "\n"))
    for block in blocks:
        rows = [r for r in block.split("\n") if r.strip()]
        if not rows:
            continue
        ti = 0
        if rows[0].strip().isdigit():
            ti = 1
        if ti >= len(rows):
            continue
        m = _SRT_TIME.search(rows[ti])
        if not m:
            continue
        g = [int(x) for x in m.groups()]
        start = g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000.0
        end = g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000.0
        lines.append(SubtitleLine(len(lines) + 1, start, end,
                                  "\n".join(rows[ti + 1:])))
    return SubtitleTrack(lines=lines)


def format_srt(track: SubtitleTrack) -> str:
    blocks = []
    for i, l in enumerate(track.lines, 1):
        blocks.append(f"{i}\n{_srt_time(l.start)} --> {_srt_time(l.end)}\n"
                      f"{l.text}\n")
    return "\n".join(blocks)


def events_to_track(events: List[SubtitleEvent], fps: float) -> SubtitleTrack:
    return SubtitleTrack(lines=[
        SubtitleLine(e.index, e.start_frame / fps, e.end_frame / fps, e.text)
        for e in events])


class SubtitleTimeSync:
    """Timing correction for processed video (reference
    SubtitleTimeSync, subtitles.py:904) plus DRIFT ESTIMATION against
    detected on-screen events or audio speech onsets — the track is
    re-timed per-event from a robust linear fit t_video = a*t_sub + b."""

    # -- direct adjustments ------------------------------------------------
    @staticmethod
    def apply_offset(track: SubtitleTrack, offset_s: float) -> SubtitleTrack:
        return track.adjust_timing(1.0, offset_s)

    @staticmethod
    def adjust_for_duration_change(track: SubtitleTrack, source_s: float,
                                   target_s: float) -> SubtitleTrack:
        if source_s <= 0 or target_s <= 0:
            raise ValueError("durations must be positive")
        return track.adjust_timing(target_s / source_s)

    @staticmethod
    def adjust_for_speed_change(track: SubtitleTrack,
                                speed: float) -> SubtitleTrack:
        if speed <= 0:
            raise ValueError("speed must be positive")
        return track.adjust_timing(1.0 / speed)

    @staticmethod
    def correct_drift(track: SubtitleTrack,
                      drift_per_minute: float) -> SubtitleTrack:
        """Progressive drift: t' = t * (1 - drift_s_per_s)."""
        return track.adjust_timing(1.0 - drift_per_minute / 60.0)

    # -- drift estimation ----------------------------------------------------
    @staticmethod
    def estimate_alignment(sub_times: List[float], video_times: List[float],
                           max_offset: float = 15.0, iters: int = 4
                           ) -> tuple:
        """Robust (rate a, offset b) with t_video ~= a*t_sub + b.

        Greedy nearest-neighbor matching between subtitle starts and
        detected event starts, then iteratively reweighted least
        squares with shrinking inlier window — tolerant of missed and
        spurious detections on either side."""
        if not sub_times or not video_times:
            return 1.0, 0.0, 0
        s = np.asarray(sorted(sub_times), np.float64)
        v = np.asarray(sorted(video_times), np.float64)
        a, b = 1.0, 0.0
        # initial offset guess: mode of pairwise (v - s) within window
        diffs = (v[None, :] - s[:, None]).ravel()
        diffs = diffs[np.abs(diffs) <= max_offset]
        if diffs.size:
            hist, edges = np.histogram(diffs, bins=60)
            b = float((edges[hist.argmax()] + edges[hist.argmax() + 1]) / 2)
        tol = max_offset / 2
        n_in = 0
        for _ in range(iters):
            pred = a * s + b
            j = np.searchsorted(v, pred)
            j = np.clip(j, 1, len(v) - 1) if len(v) > 1 else np.zeros(
                len(pred), int)
            left = v[np.maximum(j - 1, 0)]
            right = v[np.minimum(j, len(v) - 1)]
            nearest = np.where(np.abs(left - pred) <= np.abs(right - pred),
                               left, right)
            resid = nearest - pred
            inlier = np.abs(resid) <= tol
            n_in = int(inlier.sum())
            if n_in < 2:
                break
            x, y = s[inlier], nearest[inlier]
            xm, ym = x.mean(), y.mean()
            den = float(((x - xm) ** 2).sum())
            if den > 1e-9:
                a = float(((x - xm) * (y - ym)).sum()) / den
                # guard: physical drift rates are within a few percent
                a = float(np.clip(a, 0.8, 1.25))
            b = float(ym - a * xm)
            tol = max(0.25, tol * 0.5)
        return a, b, n_in

    @classmethod
    def sync_to_events(cls, track: SubtitleTrack,
                       events: List[SubtitleEvent], fps: float,
                       min_inliers: int = 3) -> SubtitleTrack:
        """Re-time the track against detected on-screen subtitle events
        (band-activity detection, SubtitleTimingExtractor)."""
        a, b, n = cls.estimate_alignment(
            [l.start for l in track.lines],
            [e.start_frame / fps for e in events])
        if n < min_inliers:
            logger.warning("subtitle sync: only %d matches; track "
                           "unchanged", n)
            return track
        logger.info("subtitle sync: rate %.5f offset %+.3fs (%d matches)",
                    a, b, n)
        return track.adjust_timing(a, b)

    @classmethod
    def sync_to_audio(cls, track: SubtitleTrack, audio: np.ndarray,
                      sample_rate: int, min_inliers: int = 3
                      ) -> SubtitleTrack:
        """Re-time against speech onsets from the audio track (energy
        envelope voice-activity rises)."""
        onsets = speech_onsets(audio, sample_rate)
        a, b, n = cls.estimate_alignment([l.start for l in track.lines],
                                         onsets)
        if n < min_inliers:
            return track
        logger.info("subtitle audio sync: rate %.5f offset %+.3fs "
                    "(%d matches)", a, b, n)
        return track.adjust_timing(a, b)


def speech_onsets(audio: np.ndarray, sample_rate: int,
                  frame_ms: float = 20.0, min_gap_s: float = 0.5
                  ) -> List[float]:
    """Speech-activity onset times from the energy envelope: rises
    above an adaptive threshold after >= min_gap_s of quiet."""
    x = np.asarray(audio, np.float32)
    if x.ndim > 1:
        x = x.mean(axis=-1)
    n = max(1, int(sample_rate * frame_ms / 1000.0))
    usable = len(x) // n * n
    if usable == 0:
        return []
    env = np.sqrt((x[:usable].reshape(-1, n) ** 2).mean(axis=1))
    thresh = max(float(np.median(env)) * 2.0, float(env.max()) * 0.1)
    active = env > thresh
    onsets: List[float] = []
    gap = int(min_gap_s * 1000.0 / frame_ms)
    quiet = gap
    for i, v in enumerate(active):
        if v and quiet >= gap:
            onsets.append(i * frame_ms / 1000.0)
        quiet = 0 if v else quiet + 1
    return onsets


class SubtitleEnhancer:
    """Text cleanup for OCR-extracted tracks (reference
    SubtitleEnhancer, subtitles.py:1103)."""

    _KEEP_SINGLE = set("aio")

    @classmethod
    def clean_ocr_artifacts(cls, track: SubtitleTrack) -> SubtitleTrack:
        out = []
        for l in track.lines:
            t = " ".join(l.text.split())
            # quotes first: ",," must not be read as punctuation runs
            t = t.replace(",,", '"').replace("''", '"')
            t = _re.sub(r"\s+([.,!?;:])", r"\1", t)
            t = _re.sub(r"([.,!?;:])(?=[A-Za-z])", r"\1 ", t)
            # 0/O and l/I confusions in letter context
            t = _re.sub(r"(?<=[A-Za-z])0(?=[a-z])", "o", t)
            t = _re.sub(r"\bl(?=[A-Z])", "I", t)
            words = [w for w in t.split()
                     if len(w) > 1 or not w.isalpha()
                     or w.lower() in cls._KEEP_SINGLE]
            t = " ".join(words).strip()
            if t:
                out.append(SubtitleLine(l.index, l.start, l.end, t,
                                        l.position))
        return SubtitleTrack(lines=out, language=track.language,
                             title=track.title)

    @staticmethod
    def standardize_formatting(track: SubtitleTrack) -> SubtitleTrack:
        out = []
        for l in track.lines:
            t = l.text
            if t and t[0].isalpha():
                t = t[0].upper() + t[1:]
            t = _re.sub(r"^-\s*", "- ", t, flags=_re.MULTILINE)
            t = _re.sub(r"\.{2,}", "...", t)
            out.append(SubtitleLine(l.index, l.start, l.end, t, l.position))
        return SubtitleTrack(lines=out, language=track.language,
                             title=track.title)

    @staticmethod
    def adjust_positions_for_scale(track: SubtitleTrack,
                                   scale: float) -> SubtitleTrack:
        if scale == 1.0:
            return track
        out = []
        for l in track.lines:
            pos = (tuple(int(round(p * scale)) for p in l.position)
                   if l.position else None)
            out.append(SubtitleLine(l.index, l.start, l.end, l.text, pos))
        return SubtitleTrack(lines=out, language=track.language,
                             title=track.title)

    @classmethod
    def enhance(cls, track: SubtitleTrack,
                scale: float = 1.0) -> SubtitleTrack:
        t = cls.clean_ocr_artifacts(track)
        t = cls.standardize_formatting(t)
        return cls.adjust_positions_for_scale(t, scale)
