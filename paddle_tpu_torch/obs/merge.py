"""Cross-rank timeline merge — the pod-level straggler hunter.

Counterpart of `paddle_tpu/obs/merge.py`; the records and the report are
the reference's, field for field.

On a multi-card job, "the step is slow" is useless until a rank and a phase are
named: rank 13's data_wait stretching every collective, one host's h2d
crawling, a single straggler dragging the allreduce. Each rank records its
own `StepTimeline`; `gather_timelines` exchanges slimmed records through
the job's rendezvous store (`collective.store_all_gather_object` — the same
cross-process regime the desync detector uses, so no extra infrastructure),
`merge_timelines` aligns them into one pod timeline, and
`straggler_report` names the worst rank per phase with its skew over the
group median. Surfaced as `TrainGuard.timeline_report()`.
"""
from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["gather_timelines", "merge_timelines", "straggler_report",
           "slim_records", "skew_over_median"]


def skew_over_median(values: Dict[Any, float]):
    """The straggler rule shared by the pod-timeline merge and the fleet
    `monitor top` table: the member with the largest value, the group
    median, and worst/median skew (inf when the median is 0 but the worst
    is not — one member doing ALL the waiting). Returns
    (worst_key, worst_value, median, skew); (None, 0, 0, 0) when empty."""
    if not values:
        return None, 0.0, 0.0, 0.0
    worst = max(values, key=lambda k: values[k])
    vals = sorted(values.values())
    median = vals[len(vals) // 2] if len(vals) % 2 else \
        0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
    skew = (values[worst] / median) if median > 0 else \
        (0.0 if values[worst] == 0 else float("inf"))
    return worst, values[worst], median, skew


def slim_records(records) -> List[Dict[str, Any]]:
    """Drop the span lists (chrome-export detail) so the store exchange
    ships a few hundred bytes per step, not the full trace."""
    out = []
    for r in records:
        out.append({"step": r.get("step"), "wall": r.get("wall"),
                    "phases": dict(r.get("phases", {})),
                    "between": dict(r.get("between", {})),
                    "error": r.get("error")})
    return out


def gather_timelines(store, rank: int, world_size: int, records,
                     key: str = "obs/timeline",
                     timeout_s: float = 30.0) -> Dict[int, List[Dict]]:
    """All-gather each rank's (slimmed) step records through the rendezvous
    store. Returns {rank: [records]}. Raises TimeoutError when a peer never
    publishes — a hang, not a straggle; callers must not blame that rank."""
    from ..parallel.collective import store_all_gather_object
    payload = slim_records(records)
    gathered = store_all_gather_object(store, key, payload, rank, world_size,
                                       timeout_s=timeout_s)
    return {int(r): v for r, v in gathered.items()}


def merge_timelines(per_rank: Dict[int, List[Dict]]) -> Dict[str, Any]:
    """Fold per-rank records into one pod timeline: per-rank per-phase
    means (in-window and between-step phases both count — a straggler's
    data_wait is exactly the between-step kind), wall means, and a
    straggler verdict per phase: the rank with the largest mean, with its
    skew over the group median."""
    ranks: Dict[int, Dict[str, Any]] = {}
    phase_names = set()
    for rank, records in per_rank.items():
        totals: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        walls: List[float] = []
        for rec in records:
            if rec.get("wall") is not None:
                walls.append(float(rec["wall"]))
            for src in ("phases", "between"):
                for name, dur in (rec.get(src) or {}).items():
                    totals[name] = totals.get(name, 0.0) + float(dur)
                    counts[name] = counts.get(name, 0) + 1
        phase_names.update(totals)
        ranks[rank] = {
            "steps": len(records),
            "wall_mean": sum(walls) / len(walls) if walls else 0.0,
            "phases": {n: {"total": totals[n], "count": counts[n],
                           "mean": totals[n] / counts[n]} for n in totals},
        }
    stragglers: Dict[str, Dict[str, Any]] = {}
    for name in phase_names:
        means = {r: ranks[r]["phases"].get(name, {}).get("mean", 0.0)
                 for r in ranks}
        worst, worst_mean, median, skew = skew_over_median(means)
        stragglers[name] = {
            "rank": worst,
            "mean": worst_mean,
            "group_median": median,
            "skew": skew,
        }
    wall_means = {r: ranks[r]["wall_mean"] for r in ranks}
    slowest = max(wall_means, key=lambda r: wall_means[r]) if wall_means \
        else None
    return {"world_size": len(ranks), "ranks": ranks,
            "stragglers": stragglers, "slowest_rank": slowest}


def straggler_report(merged: Dict[str, Any],
                     time_unit: str = "ms") -> str:
    """Human-readable pod timeline: one line per phase naming the
    straggler rank, its mean, the group median, and the skew factor."""
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
    lines = ["-" * 72,
             f"pod timeline — {merged['world_size']} ranks"
             + (f", slowest rank {merged['slowest_rank']}"
                if merged.get("slowest_rank") is not None else ""),
             "-" * 72,
             f"{'Phase':<20}{'Straggler':>10}{'Mean(' + time_unit + ')':>14}"
             f"{'Median':>12}{'Skew':>8}"]
    strag = merged.get("stragglers", {})
    for name in sorted(strag, key=lambda n: -strag[n]["mean"]):
        s = strag[name]
        skew = f"{s['skew']:.2f}x" if s["skew"] != float("inf") else "inf"
        lines.append(f"{name[:19]:<20}{'rank ' + str(s['rank']):>10}"
                     f"{s['mean'] * scale:>14.3f}"
                     f"{s['group_median'] * scale:>12.3f}{skew:>8}")
    lines.append("-" * 72)
    return "\n".join(lines)
