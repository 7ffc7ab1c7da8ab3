"""Measurement provenance stamps (port of gpis_tpu/utils/provenance.py):
a measurement record carries the git revision it measured, so a record
attached to a later line can be flagged when the code it describes no
longer exists at HEAD."""

from __future__ import annotations

import datetime
import os
import subprocess

__all__ = ["provenance", "head_rev"]


def head_rev(repo_dir: str | None = None) -> tuple[str | None, bool]:
    """(short HEAD rev, dirty flag) of the repo containing this file (or
    `repo_dir`); (None, False) when git is unavailable."""
    d = repo_dir or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        rev = subprocess.run(
            ["git", "-C", d, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
        lines = subprocess.run(
            ["git", "-C", d, "status", "--porcelain", "-uno"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip().splitlines()
        # PROGRESS.jsonl is a journal appended during every measurement by
        # construction; it says nothing about the measured code.
        dirty = any(ln.split(maxsplit=1)[-1] != "PROGRESS.jsonl" for ln in lines)
        return rev, dirty
    except Exception:
        return None, False


def provenance(repo_dir: str | None = None) -> dict:
    """Stamp dict for a measurement record: git rev + dirty + UTC date."""
    rev, dirty = head_rev(repo_dir)
    out = {"date": datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ")}
    if rev:
        out["rev"] = rev
        out["dirty"] = dirty
    return out
