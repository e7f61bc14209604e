"""Checkpoint manager: async double-buffered saves, atomic commit,
keep-last-k retention over verified steps, verified restore (port of
``repro.checkpoint.manager``).

Save protocol:

1. **Blocked phase** (training thread): join any in-flight write (double
   buffering of depth 1), then copy every leaf to host memory
   (``snapshot_leaf``), so the next step may update the live tensors in
   place the moment ``save`` returns.
2. **Overlapped phase** (writer thread): write the shard files into a
   hidden ``.tmp-step_*`` directory, the manifest LAST, then ``os.replace``
   it to ``step_XXXXXXXX``. A crash leaves either the committed
   checkpoints untouched or a tmp directory that :func:`list_steps` ignores
   and the next manager sweeps.
3. After the commit, prune committed checkpoints beyond ``keep_last``,
   counting only steps that pass deep (CRC) verification.

Restore verifies before trusting: a pinned ``step`` must pass deep
verification or :class:`CheckpointCorruptionError` is raised; with no step,
the newest checkpoint that verifies wins and every corrupt newer step is
named in a warning. The manager stores plain nested-dict trees (see
``train/state.py`` for the TrainState tree); restores put every leaf on
one ``device``.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.checkpoint.sharded import (
    MANIFEST,
    flatten_tree,
    read_manifest,
    read_tree,
    snapshot_leaf,
    verify_checkpoint,
    write_leaf,
    write_manifest,
)
from repro_torch.resilience.recovery import CheckpointCorruptionError, ShardCorruptionError

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _step_dir(step: int) -> str:
    return f"step_{step:08d}"


def list_steps(directory: str) -> List[int]:
    """Committed checkpoint steps (dirs with a manifest), ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, MANIFEST)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def step_verifies(directory: str, step: int, deep: bool = False) -> bool:
    """True if the committed ``step`` passes checkpoint validation."""
    try:
        verify_checkpoint(os.path.join(directory, _step_dir(step)), deep=deep)
        return True
    except ShardCorruptionError:
        return False


def verified_steps(directory: str, deep: bool = False) -> List[int]:
    """Committed steps that pass validation, ascending."""
    return [s for s in list_steps(directory) if step_verifies(directory, s, deep)]


def latest_verified_step(directory: str, deep: bool = True) -> Optional[int]:
    for s in reversed(list_steps(directory)):
        if step_verifies(directory, s, deep):
            return s
    return None


def restore_tree(
    directory: str,
    step: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    verify: bool = True,
) -> Tuple[Any, Dict[str, Any]]:
    """Load a committed checkpoint -> (nested dict of tensors on ``device``,
    manifest). With ``verify``: a pinned ``step`` must pass deep
    validation or :class:`CheckpointCorruptionError` is raised; with
    ``step=None`` the newest checkpoint that verifies wins, and corrupt
    newer steps are skipped with a warning."""
    steps = list_steps(directory)
    assert steps, f"no committed checkpoint under {directory}"
    if step is not None:
        path = os.path.join(directory, _step_dir(step))
        if verify:
            try:
                verify_checkpoint(path, deep=True)
            except ShardCorruptionError as e:
                raise CheckpointCorruptionError(
                    f"checkpoint step {step} under {directory} failed validation: {e}"
                ) from e
        manifest = read_manifest(path)
        return read_tree(path, manifest, device), manifest
    tried: List[str] = []
    for s in reversed(steps):
        path = os.path.join(directory, _step_dir(s))
        try:
            if verify:
                verify_checkpoint(path, deep=True)
            manifest = read_manifest(path)
            tree = read_tree(path, manifest, device)
        except (ShardCorruptionError, OSError, ValueError, KeyError) as e:
            tried.append(f"step {s}: {e}")
            continue
        if tried:
            warnings.warn(
                f"restored step {s} from {directory} after skipping {len(tried)} corrupt newer "
                "checkpoint(s): " + "; ".join(tried),
                stacklevel=2,
            )
        return tree, manifest
    raise CheckpointCorruptionError(
        f"no checkpoint under {directory} passes validation — tried " + "; ".join(tried)
    )


class CheckpointManager:
    """Async, atomic, retained checkpoints for one run directory."""

    def __init__(self, directory: str, keep_last: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self.last_blocked_s = 0.0  # wall time the training thread spent in save()
        self.restore_fallbacks = 0  # corrupt steps skipped across restores
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # deep-verification cache for retention: committed step dirs are
        # immutable, except when a rollback re-saves a step (_write drops it)
        self._verify_cache: Dict[int, bool] = {}
        os.makedirs(directory, exist_ok=True)
        self._sweep_tmp()  # debris of a crashed writer

    def _sweep_tmp(self):
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _write(self, snaps, step: int, meta: Optional[Dict]):
        tmp = os.path.join(self.directory, f".tmp-{_step_dir(step)}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        leaves = {key: write_leaf(tmp, key, entry, shards) for key, (entry, shards) in snaps.items()}
        write_manifest(tmp, step, leaves, meta)  # manifest last = commit point
        final = os.path.join(self.directory, _step_dir(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._verify_cache.pop(step, None)  # a rollback may re-save a step
        self._prune()

    def _step_verified(self, step: int) -> bool:
        # deep (CRC): a torn-but-payload-sized or bit-flipped checkpoint
        # never counts toward retention; each step is scrubbed once, in the
        # writer thread right after its commit
        if step not in self._verify_cache:
            self._verify_cache[step] = step_verifies(self.directory, step, deep=True)
        return self._verify_cache[step]

    def _prune(self):
        """Keep the newest ``keep_last`` verified steps; delete older steps,
        corrupt ones only once they are older than the oldest kept (newer
        corrupt ones stay for the restore fallback to skip)."""
        steps = list_steps(self.directory)
        good = [s for s in steps if self._step_verified(s)]
        keep = set(good[-self.keep_last:]) if self.keep_last > 0 else set()
        if not keep:
            return  # nothing verified: delete nothing
        oldest_kept = min(keep)
        for s in steps:
            if s not in keep and s < oldest_kept:
                shutil.rmtree(os.path.join(self.directory, _step_dir(s)), ignore_errors=True)
                self._verify_cache.pop(s, None)

    def wait(self):
        """Join the in-flight write (if any); re-raise a writer failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree: Any, step: int, meta: Optional[Dict] = None, blocking: Optional[bool] = None):
        """Checkpoint ``tree`` (nested dict of tensors or arrays) as ``step``.
        Returns after the host copy; the file write overlaps the next
        training steps unless ``blocking``."""
        t0 = time.perf_counter()
        self.wait()
        snaps = {key: snapshot_leaf(val) for key, val in flatten_tree(tree).items()}
        block = self.async_save is False if blocking is None else blocking
        if block:
            self._write(snaps, step, meta)
        else:
            def run():
                try:
                    self._write(snaps, step, meta)
                except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                    self._error = e

            self._thread = threading.Thread(target=run, name=f"ckpt-write-{step}", daemon=True)
            self._thread.start()
        self.last_blocked_s = time.perf_counter() - t0

    def restore(self, step: Optional[int] = None, device: Union[str, torch.device] = "cuda",
                verify: bool = True):
        """Verified restore (see :func:`restore_tree`); also sweeps writer
        debris and counts corrupt-step fallbacks in ``restore_fallbacks``."""
        self.wait()
        self._sweep_tmp()
        before = latest_step(self.directory)
        out = restore_tree(self.directory, step, device, verify=verify)
        if step is None and before is not None and out[1]["step"] != before:
            self.restore_fallbacks += len([s for s in list_steps(self.directory) if s > out[1]["step"]])
        return out
