"""QA report of a restore: the port of ``framewright_tpu.reports``'s
``QAReport`` and ``build_qa_report`` (JSON or HTML). The quality trends
database and the cost estimate are not ported yet (ROADMAP.md A)."""

from __future__ import annotations

import html
import json
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List


@dataclass
class QAReport:
    source: str
    output: str
    created_at: float = field(default_factory=time.time)
    input_info: Dict = field(default_factory=dict)
    output_info: Dict = field(default_factory=dict)
    stages: List[Dict] = field(default_factory=list)
    quality: Dict = field(default_factory=dict)
    per_frame: Dict[str, List[float]] = field(default_factory=dict)
    errors: int = 0
    resumed_from: int = 0          # quality and errors cover the frames from here on
    duration_s: float = 0.0

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{html.escape(str(s.get('name')))}</td>"
            f"<td>{html.escape(str(s.get('status')))}</td>"
            f"<td>{s.get('duration_s', 0):.2f}s</td></tr>"
            for s in self.stages)
        q = self.quality or {}
        badge = ("PASSED" if q.get("passed") else "FAILED") if q else "N/A"
        color = "#2a7" if q.get("passed") else "#c33"
        return f"""<!doctype html><html><head><meta charset="utf-8">
<title>framewright QA report</title>
<style>body{{font-family:system-ui;margin:2rem;color:#222}}
table{{border-collapse:collapse}}td,th{{border:1px solid #ccc;padding:.4rem .8rem}}
.badge{{display:inline-block;padding:.2rem .6rem;border-radius:4px;color:#fff;
background:{color}}}</style></head><body>
<h1>QA Report</h1>
<p><b>Source:</b> {html.escape(self.source)}<br><b>Output:</b> {html.escape(self.output)}<br>
<b>Duration:</b> {self.duration_s:.1f}s &nbsp; <b>Errors:</b> {self.errors}
 &nbsp; <b>Resumed from frame:</b> {self.resumed_from}</p>
<h2>Quality <span class="badge">{badge}</span></h2>
<p>PSNR: {q.get('psnr', 'n/a')} dB &nbsp; SSIM: {q.get('ssim', 'n/a')}
 &nbsp; samples: {q.get('samples', 0)}</p>
<h2>Stages</h2><table><tr><th>Stage</th><th>Status</th><th>Time</th></tr>{rows}</table>
</body></html>"""

    def save(self, path: Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_html() if path.suffix == ".html" else self.to_json())
        return path


def build_qa_report(result, source: str) -> QAReport:
    """A QAReport from a ``restorer.RestoreResult``; ``per_frame`` holds
    the gate's per-frame PSNR and SSIM."""
    rep = QAReport(source=str(source), output=str(result.output_path))
    rep.duration_s = result.duration_s
    rep.errors = result.errors
    rep.resumed_from = result.resumed_from
    rep.stages = result.stage_summary.get("stages", [])
    if result.quality is not None:
        rep.quality = result.quality.to_dict()
        rep.per_frame = {"psnr": result.quality.per_sample_psnr,
                         "ssim": result.quality.per_sample_ssim}
    rep.output_info = {"frames": result.frames_out,
                       "fps_processing": round(result.fps, 2)}
    return rep
