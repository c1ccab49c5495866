"""NumPy checkpointing of the full training state.

Reference parity + upgrade: the reference only dumped per-step generator
params to CSV and critic params to ``.npz`` (SURVEY.md §5.4, no optimizer
state, no automatic resume). Here the WHOLE state pytree — generator params,
critic params, both optimizer states, step counter — is flattened into one
``ckpt_<step>.npz`` per checkpoint, each leaf keyed by its tree path, and
written atomically (a temp file in the same directory, then ``os.replace``).
``restore`` resumes training exactly.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any

import jax
import numpy as np

_FILE = re.compile(r"^ckpt_(\d+)\.npz$")
_PATHS = "__paths__"
# one step of a keystr path: .field, ['dict key'] or [sequence index]
_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _flatten(state: Any) -> dict[str, Any]:
    """{tree path string: leaf}; None subtrees hold no leaves."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): x for p, x in leaves}


def _top(path: str) -> str:
    """Top-level entry of a keystr path ('.gen_params['J']' -> 'gen_params')."""
    return re.match(r"^(\.\w+|\[[^\]]*\])", path).group(1)


def _like(saved: np.ndarray, like: Any):
    """A saved leaf in the dtype and placement of the template leaf."""
    dtype = np.dtype(getattr(like, "dtype", saved.dtype))
    if saved.dtype != dtype:
        # dtypes numpy does not know natively (bfloat16) load as raw void
        saved = (saved.view(dtype) if saved.dtype.kind == "V"
                 else saved.astype(dtype))
    if isinstance(like, jax.Array):
        return jax.device_put(saved, like.sharding)
    return saved


class CheckpointManager:
    """``save(step, state)`` / ``latest_step()`` / ``restore(state_like)``,
    keeping the newest ``max_to_keep`` checkpoints."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.npz"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _FILE.match(p.name)))

    def save(self, step: int, state: Any):
        flat = _flatten(state)
        arrays = {f"leaf_{i}": np.asarray(x)
                  for i, x in enumerate(flat.values())}
        arrays[_PATHS] = np.array(list(flat), dtype=str)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        for old in self.steps()[:-self.max_to_keep or None]:
            self._path(old).unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self.steps()
        if not steps and any(p.is_dir() and p.name.isdigit()
                             for p in self.directory.iterdir()):
            raise RuntimeError(
                f"{self.directory} holds only orbax checkpoints from an "
                "earlier version, which no longer resume; restart the run "
                "or re-init from generator.csv/disc_params.npz")
        return steps[-1] if steps else None

    def _load(self, step: int) -> dict[str, np.ndarray]:
        with np.load(self._path(step)) as data:
            paths = [str(p) for p in data[_PATHS]]
            return {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Restore into the structure of ``state_like`` (a concrete or
        abstract state pytree).

        Forward compatibility: a checkpoint written before top-level
        fields were ADDED to the state (or while they were None because
        their feature was off) restores with those fields at
        ``state_like``'s values — every None-gated feature treats its init
        value as a cold start, so resuming a pre-feature run with the
        feature on starts its detector from scratch at the resume step.
        Any other mismatch — a saved leaf the state no longer has, or a
        changed subtree — raises."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = self._load(step)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(state_like)
        paths = [jax.tree_util.keystr(p) for p, _ in leaves]
        saved_tops = {_top(p) for p in saved}
        added = {_top(p) for p in paths if _top(p) not in saved_tops}
        bad = sorted(set(saved) - set(paths)) + sorted(
            p for p in paths if p not in saved and _top(p) not in added)
        bad += sorted(p for (p, (_, x)) in zip(paths, leaves)
                      if p in saved and np.shape(saved[p]) != np.shape(x))
        if bad:
            raise ValueError(
                f"checkpoint {step} under {self.directory} does not match "
                f"the current TrainState structure (at {bad[:4]}) — "
                "checkpoints written before an optimizer/state schema "
                "change cannot be resumed; restart the run or re-init from "
                "generator.csv/disc_params.npz")
        if added:
            print(f"[checkpoint] forward-compat restore of step {step}: "
                  f"checkpoint predates state field(s) {sorted(added)}; "
                  "they start from their init values")
        return jax.tree_util.tree_unflatten(treedef, [
            _like(saved[p], x) if p in saved else x
            for p, (_, x) in zip(paths, leaves)])

    def load_tree(self, step: int | None = None) -> dict:
        """A checkpoint as nested dicts of NumPy arrays, keyed by field
        name, dict key or sequence index — for tools that read a run's
        state without building a ``state_like`` for it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree: dict = {}
        for path, x in self._load(step).items():
            keys = [a or b or int(c) for a, b, c in _KEY.findall(path)]
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = x
        return tree

    def close(self):
        """Nothing to release; kept for the drivers' call sites."""
