"""Projects with versioned restores (the port of
``framewright_tpu.project``): a named project holds its source and one
directory a restore attempt (``v<N>/``: the config, the output, a work
directory), with each version's config hash, notes and quality metrics
in ``project.json`` (JAX's layout: either package reads the other's
project). A version restores with its config on that config's device."""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import InputError

logger = logging.getLogger(__name__)


@dataclass
class ProjectVersion:
    version: int
    created_at: float
    config_hash: str
    output: str
    notes: str = ""
    metrics: Dict = field(default_factory=dict)


class Project:
    """Directory layout:
    <root>/<name>/project.json        metadata + version index
    <root>/<name>/v<N>/               per-version outputs & configs
    """

    def __init__(self, root: Path, name: str):
        from framewright_tpu_torch.security import sanitize_filename

        self.name = sanitize_filename(name)
        self.dir = Path(root) / self.name
        self.meta_path = self.dir / "project.json"
        self._meta = {"name": self.name, "source": "", "versions": []}
        if self.meta_path.exists():
            self._meta = json.loads(self.meta_path.read_text())

    # ------------------------------------------------------------------
    @property
    def versions(self) -> List[ProjectVersion]:
        return [ProjectVersion(**v) for v in self._meta["versions"]]

    @property
    def source(self) -> str:
        return self._meta.get("source", "")

    def init(self, source: Path) -> "Project":
        if not Path(source).exists():
            raise InputError(f"source not found: {source}")
        self.dir.mkdir(parents=True, exist_ok=True)
        self._meta["source"] = str(source)
        self._save()
        return self

    def _save(self) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        self.meta_path.write_text(json.dumps(self._meta, indent=2))

    # ------------------------------------------------------------------
    def new_version_dir(self) -> Path:
        v = len(self._meta["versions"]) + 1
        d = self.dir / f"v{v}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def restore(self, config: Config, notes: str = "",
                output_name: str = "restored.y4m"):
        """Run a restoration as the next project version."""
        from framewright_tpu_torch.restorer import VideoRestorer

        if not self.source:
            raise InputError("project has no source; call init() first")
        vdir = self.new_version_dir()
        cfg = config.with_overrides(project_dir=str(vdir / "work"))
        out = vdir / output_name
        cfg.save(vdir / "config.json")
        result = VideoRestorer(cfg).restore_video(self.source, output=out)
        record = ProjectVersion(
            version=len(self._meta["versions"]) + 1,
            created_at=time.time(),
            config_hash=cfg.get_hash(),
            output=str(out),
            notes=notes,
            metrics=(result.quality.to_dict() if result.quality else {}),
        )
        self._meta["versions"].append(record.__dict__)
        self._save()
        return record, result

    def compare(self) -> List[Dict]:
        """Version comparison table (metrics side by side)."""
        return [
            {**v.metrics, "version": v.version, "notes": v.notes}
            for v in self.versions
        ]


def list_projects(root: Path) -> List[str]:
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(p.parent.name for p in root.glob("*/project.json"))
