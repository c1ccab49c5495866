"""Run-directory management: datastore, run manifest, error taxonomy.

Reference parity: ``tc_gan/execution.py`` (SURVEY.md §2 "Execution /
datastore"): creates the run directory, writes ``info.json`` with the full
config / git revision / library versions / timing, and defines the
``KnownError`` taxonomy for recoverable numerical failures (pervasive SSN
divergence aborts the run as a KnownError rather than a crash).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict


class KnownError(Exception):
    """A recoverable, expected failure mode (numerical divergence etc.).

    Drivers raise this (instead of crashing) when e.g. the fraction of
    diverging SSN samples stays above threshold — matching the reference's
    KnownError semantics (SURVEY.md §5.3).
    """


class PervasiveDivergenceError(KnownError):
    """Raised when SSN divergence exceeds the tolerated rate for several
    consecutive steps."""


def _git_revision(repo_root: Path) -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_root, capture_output=True,
            text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _library_versions() -> Dict[str, str]:
    versions = {"python": sys.version.split()[0]}
    for mod in ("jax", "jaxlib", "numpy", "optax"):
        try:
            m = __import__(mod)
            versions[mod] = getattr(m, "__version__", "unknown")
        except Exception:
            versions[mod] = "unavailable"
    return versions


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if isinstance(obj, type):
        return obj.__name__
    return repr(obj)


class DataStore:
    """A run directory holding recorder streams, checkpoints, and the run
    manifest (``info.json``)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()
        self._info: Dict[str, Any] = {}

    def subdir(self, name: str) -> Path:
        p = self.path / name
        p.mkdir(parents=True, exist_ok=True)
        return p

    def file(self, name: str) -> Path:
        return self.path / name

    def write_info(self, config: Any, extra: Dict[str, Any] | None = None):
        """Write the run manifest at start (and rewrite it at finalize)."""
        self._info = {
            "config": _jsonable(config),
            "git_revision": _git_revision(Path(__file__).resolve().parents[2]),
            "library_versions": _library_versions(),
            "argv": sys.argv,
            "started_unixtime": self._t0,
        }
        if extra:
            self._info.update(_jsonable(extra))
        self._flush_info()

    def finalize(self, status: str = "finished", extra: Dict[str, Any] | None = None):
        self._info["status"] = status
        self._info["elapsed_seconds"] = time.time() - self._t0
        if extra:
            self._info.update(_jsonable(extra))
        self._flush_info()

    def _flush_info(self):
        # atomic: eval default-loads the run config from info.json, so a
        # kill mid-write must not leave a truncated manifest behind
        import os

        tmp = self.path / "info.json.tmp"
        with open(tmp, "w") as fh:
            json.dump(self._info, fh, indent=2, default=str)
        os.replace(tmp, self.path / "info.json")
