"""Atomic JSON persistence — the torn-write-safe state path.

The scheduler checkpoint of ``apps/server.py`` rides this pair of helpers:
``save_json_atomic`` writes a temp file and ``os.replace``s it over the
target, so a crash mid-write leaves the previous complete snapshot, and
``load_json`` treats *any* unreadable state — missing file, torn or
truncated JSON, undecodable bytes, permission errors — as "start fresh"
rather than a crash.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def save_json_atomic(path: str, obj: dict) -> None:
    """Atomically persist ``obj`` as JSON (write temp + rename, so a crash
    mid-write never corrupts the file being replaced)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def load_json(path: str) -> Optional[dict]:
    """The persisted dict, or None (a fresh start) on any unreadable state.
    ``save_json_atomic`` guarantees the file is never *partially* new — a
    crash between write and rename leaves the previous complete snapshot."""
    try:
        with open(path) as f:
            state = json.load(f)
    # ValueError covers JSONDecodeError and UnicodeDecodeError both.
    except (OSError, ValueError):
        return None
    return state if isinstance(state, dict) else None
