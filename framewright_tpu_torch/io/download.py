"""Source videos from URLs through yt-dlp (the port of
``framewright_tpu/io/download.py``): a validated argv, no shell. Without a
downloader on ``PATH`` the download raises ``FramewrightError`` (restore a
local file instead). When yt-dlp adds an extension to the output name,
the newest file that starts with that name is the download."""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

from framewright_tpu_torch.errors import FramewrightError
from framewright_tpu_torch.security import validate_url

logger = logging.getLogger(__name__)


def find_downloader() -> Optional[str]:
    for tool in ("yt-dlp", "youtube-dl"):
        path = shutil.which(tool)
        if path:
            return path
    return None


def build_command(tool: str, url: str, out_path: Path,
                  format_spec: str = "bestvideo+bestaudio/best",
                  rate_limit: str = "", playlist: bool = False) -> List[str]:
    """The downloader's argv for ``url`` (validated: http or https)."""
    url = validate_url(url)
    cmd = [tool, "--no-colors", "--no-progress", "-f", format_spec, "-o", str(out_path)]
    if not playlist:
        cmd.append("--no-playlist")
    if rate_limit:
        cmd += ["--limit-rate", rate_limit]
    cmd.append(url)
    return cmd


def download_video(url: str, out_path: Path, format_spec: str = "bestvideo+bestaudio/best",
                   rate_limit: str = "", timeout: float = 3600.0) -> Path:
    """Fetch a source video to ``out_path`` (or the newest sibling that
    starts with its name); the path written."""
    tool = find_downloader()
    if tool is None:
        raise FramewrightError("No downloader found (install yt-dlp to restore from URLs); "
                               "pass a local file path instead")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = build_command(tool, url, out_path, format_spec, rate_limit)
    logger.info("downloading %s -> %s", url, out_path)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise FramewrightError(f"download failed ({proc.returncode}): {proc.stderr[-500:]}")
    if not out_path.exists():
        matches = sorted(out_path.parent.glob(out_path.name + "*"),
                         key=lambda p: p.stat().st_mtime)
        if not matches:
            raise FramewrightError("downloader reported success but no file")
        return matches[-1]
    return out_path
