"""Measurement provenance stamps (port of gpis_tpu/utils/provenance.py):
a measurement record carries the git revision it measured, so a record
attached to a later line can be flagged when the code it describes no
longer exists at HEAD; a time on the card carries the card's name and
power limit (`card_line`)."""

from __future__ import annotations

import datetime
import os
import subprocess

__all__ = ["provenance", "head_rev", "card_line"]


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


def card_line(device="cuda") -> str:
    """The CUDA card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, for the
    torch device `device`.  nvidia-smi numbers every card of the machine and
    CUDA only the visible ones, so the row is found by PCI address; where
    nvidia-smi shows no address, every row must read the same.  Raises
    RuntimeError when nvidia-smi fails or the row cannot be told."""
    import torch

    dev = torch.device(device)
    props = torch.cuda.get_device_properties(
        torch.cuda.current_device() if dev.index is None else dev.index)
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    rows = [row.split(", ", 1) for row in proc.stdout.strip().splitlines()]
    want = tuple(getattr(props, f"pci_{k}_id", None) for k in ("domain", "bus", "device"))
    for bus_id, text in rows:
        parts = bus_id.replace(".", ":").split(":")  # domain:bus:device.function
        if len(parts) == 4 and tuple(int(p, 16) for p in parts[:3]) == want:
            return text
    texts = {text for _, text in rows}
    if len(texts) == 1:
        return texts.pop()
    raise RuntimeError(f"nvidia-smi's {len(rows)} rows do not say which is {props.name}")
