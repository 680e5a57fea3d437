"""Chrome/Perfetto trace-event export of a lifecycle event stream.

``to_chrome_trace`` folds a ``Tracer.events()`` window into the Chrome
trace-event JSON format (load in Perfetto / ``chrome://tracing``):

  * one **process row per device** ("device N") whose "X" complete slices
    are resource occupancy — a task holds the device from ADMIT/GROW to
    the matching END/SHRINK/EVICT/CRASH;
  * a **counter track** ("waiters") tracking admission-queue depth,
    reconstructed from PARK/REQUEUE vs. ADMIT/GROW/SHED/CRASH/STEAL (a
    RESTOREd steal re-parks on its owner);
  * **flow arrows** stitching one task's consecutive occupancy slices —
    an evicted/migrated task's park→readmit arc draws as an arrow from
    the old device's slice to the new one's;
  * instant markers for fleet events (MARK_DEAD/REVIVE).

Timestamps are microseconds relative to the window's first event, which
keeps virtual-clock (seconds-scale) and wall-clock (monotonic-origin)
streams equally readable.

Copy of ``src/repro/obs/export.py`` with its imports rewritten
to ``repro_torch``; keep the two in step.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import events as ev

# kinds that OPEN a device-occupancy slice / CLOSE one
_OPENS = (ev.ADMIT, ev.GROW)
_CLOSES = (ev.END, ev.SHRINK, ev.EVICT, ev.CRASH)
# kinds that add to / remove from the parked-waiter population
_PARKS = (ev.PARK, ev.REQUEUE, ev.RESTORE)
_UNPARKS = (ev.ADMIT, ev.GROW, ev.SHED, ev.CRASH, ev.STEAL)

_QUEUE_PID = 1_000_000  # synthetic process row for the counter track


def device_track_name(d: int, devices_per_pod: Optional[int] = None) -> str:
    """Display name for device ``d``'s process row. With
    ``devices_per_pod`` (a sharded/multi-pod fleet) the flat global index
    is factored into ``pod{p}/dev{d}`` so Perfetto groups tracks by pod;
    a flat fleet keeps the historical ``device N``."""
    if devices_per_pod and devices_per_pod > 0:
        return f"pod{d // devices_per_pod}/dev{d % devices_per_pod}"
    return f"device {d}"


def to_chrome_trace(events: Sequence[ev.Event], *,
                    devices_per_pod: Optional[int] = None,
                    profile_counters: bool = False) -> dict:
    """Fold an event window into a Chrome trace-event document (dict).

    ``profile_counters`` merges the profiling plane's counter tracks
    (per-device "occupancy %" on each device row, and a fleet-wide
    "prediction error %" row) built by ``obs.profile`` from the same
    window — off by default so uncalibrated exports are byte-identical
    to the historical format."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.t for e in events)

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    out: List[dict] = []
    devices = sorted({e.device for e in events if e.device >= 0})
    for d in devices:
        out.append({"ph": "M", "pid": d, "tid": 0, "name": "process_name",
                    "args": {"name": device_track_name(d, devices_per_pod)}})
    out.append({"ph": "M", "pid": _QUEUE_PID, "tid": 0,
                "name": "process_name", "args": {"name": "scheduler queue"}})

    # -- occupancy slices + flows ------------------------------------------
    open_slice: Dict[int, Tuple[float, int, str]] = {}  # uid -> (t, dev, nm)
    closed: Dict[int, List[dict]] = {}                  # uid -> its slices
    for e in events:
        if e.kind in _OPENS and e.uid >= 0 and e.device >= 0:
            # re-admission with a still-open slice (shouldn't happen on a
            # sound stream, but an overwritten ring can lose the close):
            # close the stale one at the new open to keep the JSON valid
            if e.uid in open_slice:
                _close(open_slice, closed, e.uid, e.t, "lost-close", us)
            open_slice[e.uid] = (e.t, e.device, e.name or f"task {e.uid}")
        elif e.kind in _CLOSES and e.uid in open_slice:
            _close(open_slice, closed, e.uid, e.t, e.kind, us)
        elif e.kind in (ev.MARK_DEAD, ev.REVIVE) and e.device >= 0:
            out.append({"ph": "i", "s": "g", "pid": e.device, "tid": 0,
                        "name": e.kind, "ts": us(e.t)})
    t_end = max(e.t for e in events)
    for uid in list(open_slice):                 # still running at the end
        _close(open_slice, closed, uid, t_end, "open", us)
    flows = 0
    for uid, slices in closed.items():
        out.extend(slices)
        # one flow arrow per consecutive slice pair: the park→readmit arc
        # of an evicted/migrated task, drawn across devices when they moved
        for a, b in zip(slices, slices[1:]):
            out.append({"ph": "s", "id": uid, "cat": "task-flow",
                        "name": "resume", "pid": a["pid"], "tid": uid,
                        "ts": a["ts"] + a["dur"]})
            out.append({"ph": "f", "bp": "e", "id": uid, "cat": "task-flow",
                        "name": "resume", "pid": b["pid"], "tid": uid,
                        "ts": b["ts"]})
            flows += 1

    # -- waiter-depth counter ----------------------------------------------
    # Coalesced: a park+admit pair at one timestamp collapses to its final
    # depth (keep-last per ts), and a sample equal to the last emitted
    # depth is skipped entirely — a steal/restore churn that nets to zero
    # adds NO counter rows instead of a same-value sawtooth.
    parked: set = set()
    samples: List[Tuple[float, int]] = []
    for e in events:
        if e.uid < 0:
            continue
        n0 = len(parked)
        if e.kind in _PARKS:
            parked.add(e.uid)
        elif e.kind in _UNPARKS:
            parked.discard(e.uid)
        if len(parked) != n0:
            ts = us(e.t)
            if samples and samples[-1][0] == ts:
                samples[-1] = (ts, len(parked))
            else:
                samples.append((ts, len(parked)))
    last_depth: Optional[int] = None
    for ts, depth in samples:
        if depth == last_depth:
            continue
        last_depth = depth
        out.append({"ph": "C", "pid": _QUEUE_PID, "name": "waiters",
                    "ts": ts, "args": {"depth": depth}})

    # -- profiling-plane counters (lazy import: profile builds ON export) ---
    if profile_counters:
        from repro_torch.obs.profile import chrome_counter_records
        out.extend(chrome_counter_records(events, us))

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _close(open_slice: dict, closed: dict, uid: int, t: float,
           why: str, us) -> None:
    t_open, dev, name = open_slice.pop(uid)
    closed.setdefault(uid, []).append({
        "ph": "X", "pid": dev, "tid": uid, "name": name,
        "cat": "occupancy", "ts": us(t_open),
        "dur": max(round((t - t_open) * 1e6, 3), 0.0),
        "args": {"uid": uid, "end": why}})


def write_chrome_trace(events: Sequence[ev.Event], path: str, *,
                       devices_per_pod: Optional[int] = None,
                       profile_counters: bool = False) -> dict:
    """Export ``events`` to a Perfetto-loadable JSON file; returns the
    document so callers can validate/summarize without re-reading it."""
    doc = to_chrome_trace(events, devices_per_pod=devices_per_pod,
                          profile_counters=profile_counters)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# -- validation --------------------------------------------------------------

_KNOWN_PH = frozenset("XBEiMsfC")


def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural validation against the Chrome trace-event format.
    Returns a list of problems (empty == valid): every record needs a
    known ``ph``; "X" slices need pid/ts/dur with dur >= 0; flow starts
    and finishes must pair up by id."""
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    flow_s: Dict[int, int] = {}
    flow_f: Dict[int, int] = {}
    track_names: Dict[str, int] = {}   # process_name -> first pid
    for i, r in enumerate(evs):
        ph = r.get("ph")
        if ph not in _KNOWN_PH:
            problems.append(f"[{i}] unknown ph {ph!r}")
            continue
        if ph == "M" and r.get("name") == "process_name":
            # two process rows sharing one display name render as ONE
            # merged track in Perfetto — pod-qualified names must be
            # unique per pid (the sharded-fleet regression this guards)
            nm = (r.get("args") or {}).get("name")
            pid = r.get("pid")
            if nm in track_names and track_names[nm] != pid:
                problems.append(
                    f"[{i}] duplicate track name {nm!r} for pid {pid} "
                    f"(already names pid {track_names[nm]})")
            elif nm is not None:
                track_names[nm] = pid
        if ph == "X":
            if not all(k in r for k in ("pid", "ts", "dur", "name")):
                problems.append(f"[{i}] X slice missing pid/ts/dur/name")
            elif r["dur"] < 0:
                problems.append(f"[{i}] X slice negative dur {r['dur']}")
        elif ph == "C":
            if "args" not in r or not isinstance(r["args"], dict):
                problems.append(f"[{i}] counter without args dict")
        elif ph == "s":
            flow_s[r.get("id")] = flow_s.get(r.get("id"), 0) + 1
        elif ph == "f":
            flow_f[r.get("id")] = flow_f.get(r.get("id"), 0) + 1
    for fid, n in flow_s.items():
        if flow_f.get(fid, 0) != n:
            problems.append(f"flow id {fid}: {n} start(s), "
                            f"{flow_f.get(fid, 0)} finish(es)")
    for fid in flow_f:
        if fid not in flow_s:
            problems.append(f"flow id {fid}: finish without start")
    return problems


def trace_summary(doc: dict) -> dict:
    """Quick stats for assertions: device process rows, slice count, flow
    count, and how many flows CROSS devices (the migrated-task arrows the
    acceptance gate wants at least one of)."""
    evs = doc.get("traceEvents", [])
    devices = sorted({r["pid"] for r in evs
                      if r.get("ph") == "X" and isinstance(r.get("pid"), int)})
    slices = sum(1 for r in evs if r.get("ph") == "X")
    # flows were emitted strictly as an s/f pair per arc, in order — pair
    # them back up by id and order of appearance
    by_id_s: Dict[int, List[dict]] = {}
    by_id_f: Dict[int, List[dict]] = {}
    for r in evs:
        if r.get("ph") == "s":
            by_id_s.setdefault(r["id"], []).append(r)
        elif r.get("ph") == "f":
            by_id_f.setdefault(r["id"], []).append(r)
    flows = cross = 0
    for fid, ss in by_id_s.items():
        for s, f in zip(ss, by_id_f.get(fid, [])):
            flows += 1
            if s.get("pid") != f.get("pid"):
                cross += 1
    return {"devices": devices, "slices": slices,
            "flows": flows, "cross_device_flows": cross,
            "counter_samples": sum(1 for r in evs if r.get("ph") == "C")}
