"""OCR backends for subtitle text: the port of
``framewright_tpu/processors/ocr.py`` (the same code).

The tesseract binary runs only when it is on ``PATH`` (nothing is
installed for it): frames go to it as PPM over stdin and the text comes
back on stdout, one short process per subtitle event. Any callable
``frame -> str`` can stand in for it (``SubtitleTimingExtractor``'s
``ocr_fn``).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

OcrFn = Callable[[np.ndarray], str]


def find_tesseract() -> Optional[str]:
    """Path to the tesseract binary, or None (gated dependency)."""
    return shutil.which("tesseract")


def _to_ppm(frame: np.ndarray) -> bytes:
    """uint8 HxWx3 (or HxW) -> binary PPM/PGM bytes."""
    if frame.ndim == 2:
        h, w = frame.shape
        return b"P5\n%d %d\n255\n" % (w, h) + frame.tobytes()
    h, w, _ = frame.shape
    return b"P6\n%d %d\n255\n" % (w, h) + frame[:, :, :3].tobytes()


def preprocess_subtitle_band(frame: np.ndarray,
                             band_frac: float = 0.28) -> np.ndarray:
    """Crop the bottom band where subtitles live, boost contrast, and
    2x-upscale (small text OCRs far better upscaled) — the reference's
    preprocessing pipeline (subtitle_extraction.py) in numpy."""
    h = frame.shape[0]
    band = frame[int(h * (1.0 - band_frac)):]
    luma = (band.astype(np.float32) @ np.asarray([.299, .587, .114],
                                                 np.float32)
            if band.ndim == 3 else band.astype(np.float32))
    lo, hi = np.percentile(luma, (5, 99))
    luma = np.clip((luma - lo) * (255.0 / max(hi - lo, 1.0)), 0, 255)
    up = np.repeat(np.repeat(luma, 2, axis=0), 2, axis=1)
    return up.astype(np.uint8)


class TesseractOCR:
    """OCR via the tesseract binary (reference TesseractBackend,
    subtitle_extraction.py:254)."""

    def __init__(self, binary: Optional[str] = None, lang: str = "eng",
                 psm: int = 6, timeout: float = 20.0,
                 preprocess: bool = True):
        self.binary = binary or find_tesseract()
        if not self.binary:
            raise RuntimeError(
                "tesseract binary not found; install it or inject a "
                "custom ocr_fn")
        self.lang = lang
        self.psm = psm
        self.timeout = timeout
        self.preprocess = preprocess

    def __call__(self, frame: np.ndarray) -> str:
        img = preprocess_subtitle_band(frame) if self.preprocess else frame
        try:
            proc = subprocess.run(
                [self.binary, "stdin", "stdout", "-l", self.lang,
                 "--psm", str(self.psm)],
                input=_to_ppm(img), capture_output=True,
                timeout=self.timeout, check=False,
            )
        except (subprocess.TimeoutExpired, OSError) as exc:
            logger.warning("tesseract failed: %s", exc)
            return ""
        if proc.returncode != 0:
            logger.debug("tesseract rc=%d: %s", proc.returncode,
                         proc.stderr[:200])
            return ""
        return proc.stdout.decode("utf-8", "replace").strip()


def default_ocr_fn(lang: str = "eng") -> Optional[OcrFn]:
    """The best available recognizer, or None when no backend exists
    (timing-only SRT export still works — reference behavior when all
    OCR engines are missing)."""
    if find_tesseract():
        return TesseractOCR(lang=lang)
    logger.info("no OCR backend available (tesseract not installed); "
                "subtitle events will carry timing only")
    return None
