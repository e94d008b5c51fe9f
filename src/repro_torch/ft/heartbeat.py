"""Failure detection + straggler mitigation primitives.

Port of ``src/repro/ft/heartbeat.py`` (host logic, the same code).

On a real cluster each host runs a `HeartbeatMonitor`; the launcher
restarts from the last checkpoint with the surviving host set when a
deadline is missed (elastic contraction — see ft/elastic.py). Here the
logic is exercised by unit tests and the trainer's simulated-failure
hooks: the algorithms are the deliverable, the transport is a file
(NFS-style) or in-process dict.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    deadline_s: float = 60.0


class HeartbeatMonitor:
    """File-based heartbeats: host i touches <dir>/host_i.json with its
    step + wall time; any reader can compute the dead set."""

    def __init__(self, directory: str, host_id: int, cfg: HeartbeatConfig):
        self.dir = directory
        self.host_id = host_id
        self.cfg = cfg
        os.makedirs(directory, exist_ok=True)

    def beat(self, step: int, now: Optional[float] = None) -> None:
        payload = {"step": step, "time": now or time.time()}
        path = os.path.join(self.dir, f"host_{self.host_id:05d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def survey(self, now: Optional[float] = None) -> Dict[int, Dict]:
        """One entry per heartbeat file. A torn, empty, or otherwise
        unreadable heartbeat is a *dead* host, not a crashed survey —
        the monitor is exactly the thing that must keep working while
        hosts are failing. The parse error is recorded in the payload
        (``payload["error"]``) so the supervisor can log why. In-flight
        ``.tmp`` files from ``beat``'s atomic write are skipped (the
        committed file is the heartbeat); files whose name carries no
        parseable host id are skipped (they are not heartbeats)."""
        now = now or time.time()
        out = {}
        for name in os.listdir(self.dir):
            if not name.startswith("host_") or name.endswith(".tmp"):
                continue
            try:
                hid = int(name.split("_")[1].split(".")[0])
            except (IndexError, ValueError):
                continue            # misnamed: not a heartbeat file
            try:
                with open(os.path.join(self.dir, name)) as f:
                    payload = json.load(f)
                stale = now - float(payload["time"])
                payload["alive"] = stale < self.cfg.deadline_s
            except (OSError, ValueError, KeyError, TypeError) as e:
                payload = {"alive": False,
                           "error": f"{type(e).__name__}: {e}"}
            out[hid] = payload
        return out

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        return sorted(h for h, p in self.survey(now).items()
                      if not p["alive"])


def detect_stragglers(step_times_s: Dict[int, float],
                      mad_factor: float = 3.0) -> List[int]:
    """Median-absolute-deviation outlier detection over per-host step
    times. Returns host ids slower than median + mad_factor·MAD."""
    if len(step_times_s) < 3:
        return []
    times = sorted(step_times_s.values())
    n = len(times)
    med = times[n // 2] if n % 2 else 0.5 * (times[n // 2 - 1] + times[n // 2])
    devs = sorted(abs(t - med) for t in times)
    mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1] + devs[n // 2])
    thresh = med + mad_factor * max(mad, 1e-9)
    return sorted(h for h, t in step_times_s.items() if t > thresh)
