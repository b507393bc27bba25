"""QA reports, quality trends and the job estimate: the port of
``framewright_tpu.reports``.

``QAReport`` and ``build_qa_report`` write a restore's report (JSON or
HTML). ``QualityTrends`` is JAX's SQLite log of runs, in JAX's schema (a
database either package writes reads in the other); nothing writes it
during a restore, as in JAX. ``estimate_cost`` keeps JAX's scaling law
(fps at a 1080p input over the pixel ratio, times the cards, the wall
times ``overhead_factor``) and its output keys, over a table of the
H100's own fps (``_FAMILY_FPS_1080P``: each figure names its
measurement). JAX's table holds TPU v5e figures and its prices TPU
rates; neither is kept: ``est_cost_usd`` has only ``reference_gpu``, JAX's
0.79 USD an hour a card."""

from __future__ import annotations

import html
import json
import sqlite3
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


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
    pre_sr: Dict = field(default_factory=dict)   # the pre-SR stream: deinterlace,
                                                 # long_form, denoise (its profile)
    faces_restored: Optional[int] = None   # face_restore: faces pasted back
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
    rep.pre_sr = result.pre_sr
    rep.faces_restored = result.faces_restored
    rep.stages = result.stage_summary.get("stages", [])
    if result.quality is not None:
        rep.quality = result.quality.to_dict()
        rep.per_frame = {"psnr": result.quality.per_sample_psnr,
                         "ssim": result.quality.per_sample_ssim}
    rep.output_info = {"frames": result.frames_out,
                       "fps_processing": round(result.fps, 2)}
    return rep


class QualityTrends:
    """SQLite quality-over-time log, JAX's table ``runs`` (ts, source,
    psnr, ssim, fps, frames, passed)."""

    def __init__(self, db_path: Path):
        self.db_path = Path(db_path)
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.db_path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS runs (ts REAL, source TEXT,"
                           " psnr REAL, ssim REAL, fps REAL, frames INTEGER, passed INTEGER)")
        self._conn.commit()

    def record(self, source: str, psnr: float, ssim: float, fps: float,
               frames: int, passed: bool) -> None:
        self._conn.execute("INSERT INTO runs VALUES (?,?,?,?,?,?,?)",
                           (time.time(), source, psnr, ssim, fps, frames, int(passed)))
        self._conn.commit()

    def history(self, limit: int = 100) -> List[Dict]:
        cur = self._conn.execute("SELECT ts, source, psnr, ssim, fps, frames, passed FROM runs"
                                 " ORDER BY ts DESC LIMIT ?", (limit,))
        keys = ("ts", "source", "psnr", "ssim", "fps", "frames", "passed")
        return [dict(zip(keys, row)) for row in cur.fetchall()]

    def summary(self) -> Dict:
        n, psnr, ssim, fps, passed = self._conn.execute(
            "SELECT COUNT(*), AVG(psnr), AVG(ssim), AVG(fps), SUM(passed) FROM runs").fetchone()
        return {"runs": n or 0, "avg_psnr": round(psnr or 0, 2),
                "avg_ssim": round(ssim or 0, 4), "avg_fps": round(fps or 0, 2),
                "pass_rate": round((passed or 0) / n, 3) if n else 0.0}

    def close(self) -> None:
        self._conn.close()


# Restore fps at a 1080p input on one H100 80GB HBM3 (nvidia-smi power
# limit 700.00 W), by model family; fps scales inversely with the input's
# pixels. rrdb and srvgg: the steady fps of the default restore of
# RealESRGAN_x2plus (bf16) and of `quick` (FW_fastvgg_x2), 1080p -> 4K,
# host I/O, the gate and the checkpoint included: the wall difference of
# 26- and 2-frame restores, chip_smoke.py phase "frontends". hat,
# basicvsr, tvsr, diffusion: the model's card time a frame at a 960x540
# input (PERF.md section 5: HAT_SRx4 1,339 ms, BasicVSR 115.0 and TVSR_x4
# 279.1 from chip_smoke.py phase "models", DiffusionSR_x4 1,921.5 at 8
# steps from phase "diffusion"), times 4 for a 1080p input, without the
# restore's host work.
_FAMILY_FPS_1080P = {
    "rrdb": 9.652,
    "srvgg": 16.648,
    "hat": 1000.0 / (4 * 1339.0),
    "basicvsr": 1000.0 / (4 * 115.0),
    "tvsr": 1000.0 / (4 * 279.1),
    "diffusion": 1000.0 / (4 * 1921.5),
}
# on-demand cloud GPU rate, USD an hour a card: JAX's ``cloud_gpu``
_GPU_USD_PER_HOUR = 0.79


@dataclass
class CostEstimate:
    frames: int
    est_fps: float
    est_seconds: float
    est_cost_usd: Dict[str, float]
    assumptions: Dict[str, object]

    def to_dict(self) -> Dict:
        return {"frames": self.frames,
                "est_fps_per_chip": round(self.est_fps, 2),
                "est_wall_time_s": round(self.est_seconds, 1),
                "est_wall_time_h": round(self.est_seconds / 3600.0, 2),
                "est_cost_usd": {k: round(v, 2) for k, v in self.est_cost_usd.items()},
                "assumptions": self.assumptions}


def estimate_cost(frames: int, width: int, height: int, model_family: str = "rrdb",
                  n_chips: int = 1, overhead_factor: float = 1.25) -> CostEstimate:
    """Wall time and cloud cost of a restore of ``frames`` frames of
    ``width`` x ``height`` on ``n_chips`` cards: the family's fps at a
    1080p input over the pixel ratio, times the cards (frames split
    over them), the wall times ``overhead_factor``. A family without a
    card figure raises ``ConfigError``."""
    from framewright_tpu_torch.errors import ConfigError

    if model_family not in _FAMILY_FPS_1080P:
        raise ConfigError(f"no card figure for model family {model_family!r}; "
                          f"known: {sorted(_FAMILY_FPS_1080P)}")
    base = _FAMILY_FPS_1080P[model_family]
    pixel_ratio = (width * height) / (1920.0 * 1080.0)
    fps = base / max(pixel_ratio, 1e-6) * n_chips
    seconds = frames / max(fps, 1e-6) * overhead_factor
    return CostEstimate(
        frames=frames, est_fps=fps, est_seconds=seconds,
        est_cost_usd={"reference_gpu": seconds / 3600.0 * _GPU_USD_PER_HOUR * n_chips},
        assumptions={"model_family": model_family, "n_chips": n_chips,
                     "resolution": f"{width}x{height}", "fps_base_1080p": base,
                     "overhead_factor": overhead_factor})
