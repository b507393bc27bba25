"""Named saved configs (the port's ``framewright_tpu/profiles.py``): JSON
files of ``Config.to_dict`` in ``$FRAMEWRIGHT_PROFILES_DIR``, else
``~/.framewright_tpu/profiles`` (JAX's directory and format, so a profile
either package saves loads in the other; fields only one of them has are
ignored by the other). The restore verb's ``--profile`` sits between the
CLI flags and the other layers, ``--save-profile`` writes the resolved
config."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List

from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.security import sanitize_filename


def profiles_dir() -> Path:
    env = os.environ.get("FRAMEWRIGHT_PROFILES_DIR")
    if env:
        return Path(env)
    return Path.home() / ".framewright_tpu" / "profiles"


def _path(name: str) -> Path:
    return profiles_dir() / f"{sanitize_filename(name)}.json"


def save_profile(name: str, config: Config) -> Path:
    path = _path(name)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(config.to_dict(), indent=2, sort_keys=True))
    return path


def load_profile(name: str) -> Config:
    path = _path(name)
    if not path.exists():
        raise ConfigError(f"Profile {name!r} not found; available: {list_profiles()}")
    return Config.from_dict(json.loads(path.read_text()))


def list_profiles() -> List[str]:
    d = profiles_dir()
    if not d.is_dir():
        return []
    return sorted(p.stem for p in d.glob("*.json"))


def delete_profile(name: str) -> bool:
    path = _path(name)
    if path.exists():
        path.unlink()
        return True
    return False
