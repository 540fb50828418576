"""Dev-loop harness: state-preserving reload and source-watching rerun
(a copy of ``housescan_tpu/devloop/reload.py`` over this package).

  * ``store_state``/``get_state``: a module-level store that survives
    ``reload_framework()`` (an importlib reload of every
    ``housescan_tpu_torch`` module but this package's).
  * The stored state carries the checkpoint schema fingerprint; if a
    reload changed the persisted dataclasses, ``get_state`` refuses to
    hand the stale object back.
  * ``run_watched(fn)``: rerun ``fn`` whenever a package source changes.

A reload re-executes every module in place, so classes and module state
(``ops.cuda_lib``'s loaded library) are new objects after it: fetch
modules again through ``sys.modules`` or ``importlib``. The shared
tracing and counting objects are kept (``utils.metrics.GLOBAL_METRICS``
and ``NO_SPAN``, ``ops.cuda_lib.launch_counts`` and ``plain_counts``):
a name imported before the reload and one imported after it are the same
object.
"""

from __future__ import annotations

import importlib
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

# The Foreign.Store analogue: survives reload_framework because THIS
# module is deliberately excluded from reloading.
_STORE: Dict[str, Any] = {}
_PACKAGE = "housescan_tpu_torch"
_SELF = "housescan_tpu_torch.devloop"


def store_state(state: Any, slot: str = "scene") -> None:
    from housescan_tpu_torch.io.checkpoint import schema_fingerprint

    _STORE[slot] = (schema_fingerprint(), state)


def get_state(slot: str = "scene") -> Optional[Any]:
    """The stored state, or None if nothing stored OR the schema changed
    since it was stored (refuse-unsafe-restore, ref Main.hs:1213-1215:
    'works even when a field is renamed')."""
    from housescan_tpu_torch.io.checkpoint import schema_fingerprint

    entry = _STORE.get(slot)
    if entry is None:
        return None
    fingerprint, state = entry
    if fingerprint != schema_fingerprint():
        print(
            "devloop: schema fingerprint changed; refusing to restore stale "
            "state (save/load a checkpoint to migrate)",
            file=sys.stderr,
        )
        return None
    return state


def reload_framework(verbose: bool = False) -> int:
    """Reload every housescan_tpu_torch module (except this package's).
    Returns the number of modules reloaded. State in the store survives;
    fetch it back with get_state()."""
    names = [
        n
        for n in sorted(sys.modules)
        if (n == _PACKAGE or n.startswith(_PACKAGE + "."))
        and not (n == _SELF or n.startswith(_SELF + "."))
    ]
    count = 0
    for name in reversed(names):  # children before parents
        mod = sys.modules.get(name)
        if mod is None:
            continue
        try:
            importlib.reload(mod)
            count += 1
            if verbose:
                print(f"reloaded {name}")
        except Exception as e:  # pragma: no cover - depends on edit state
            print(f"devloop: failed to reload {name}: {e}", file=sys.stderr)
    return count


def _source_mtime(root: Path) -> float:
    latest = 0.0
    for p in root.rglob("*.py"):
        try:
            latest = max(latest, p.stat().st_mtime)
        except OSError:
            pass
    return latest


def run_watched(
    fn: Callable[[], Any],
    poll_seconds: float = 1.0,
    root: Optional[Path] = None,
    max_runs: Optional[int] = None,
) -> None:
    """Run ``fn``, then re-run it (after reloading the framework) whenever
    a package source file changes — the exe-mtime self-restart poller
    (ref Main.hs:1119-1121) as a dev loop."""
    root = root or Path(__file__).resolve().parents[1]
    runs = 0
    last = _source_mtime(root)
    fn()
    runs += 1
    while max_runs is None or runs < max_runs:
        time.sleep(poll_seconds)
        now = _source_mtime(root)
        if now > last:
            last = now
            print("devloop: sources changed; reloading + rerunning", file=sys.stderr)
            reload_framework()
            fn()
            runs += 1
