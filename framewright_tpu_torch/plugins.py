"""Plugin manager (the port of ``framewright_tpu.plugins``): load user
hook modules from a plugins directory. A plugin is a ``*.py`` file (not
starting with ``_``) whose ``register(hooks)`` attaches callables to the
port's ``events.HookManager`` hook points; a plugin that fails to load
is recorded with its error and the others still load."""

from __future__ import annotations

import importlib.util
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from framewright_tpu_torch.events import HookManager

logger = logging.getLogger(__name__)


def default_plugins_dir() -> Path:
    """``$FRAMEWRIGHT_PLUGINS_DIR``, else ``~/.framewright_tpu/plugins``
    (JAX's directory: one plugin folder serves both packages)."""
    env = os.environ.get("FRAMEWRIGHT_PLUGINS_DIR")
    if env:
        return Path(env)
    return Path.home() / ".framewright_tpu" / "plugins"


@dataclass
class PluginInfo:
    name: str
    path: str
    loaded: bool = False
    error: str = ""


class PluginManager:
    def __init__(self, plugins_dir: Optional[Path] = None,
                 hooks: Optional[HookManager] = None):
        self.plugins_dir = Path(plugins_dir) if plugins_dir else default_plugins_dir()
        self.hooks = hooks or HookManager()
        self.plugins: Dict[str, PluginInfo] = {}

    def discover(self) -> List[PluginInfo]:
        if not self.plugins_dir.is_dir():
            return []
        found = []
        for p in sorted(self.plugins_dir.glob("*.py")):
            if p.name.startswith("_"):
                continue
            found.append(self.plugins.setdefault(p.stem, PluginInfo(p.stem, str(p))))
        return found

    def load_all(self) -> int:
        """Load every discovered plugin not loaded yet -> how many loaded."""
        return sum(1 for info in self.discover() if not info.loaded and self._load(info))

    def _load(self, info: PluginInfo) -> bool:
        try:
            spec = importlib.util.spec_from_file_location(f"framewright_plugin_{info.name}",
                                                          info.path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
            register = getattr(mod, "register", None)
            if register is None:
                raise AttributeError("plugin has no register(hooks) function")
            register(self.hooks)
            info.loaded = True
            logger.info("loaded plugin %s", info.name)
            return True
        except Exception as exc:  # noqa: BLE001 - a plugin's fault stays its own
            info.error = str(exc)
            logger.exception("failed to load plugin %s", info.name)
            return False

    def status(self) -> List[Dict]:
        return [{"name": p.name, "loaded": p.loaded, "error": p.error}
                for p in self.plugins.values()]
