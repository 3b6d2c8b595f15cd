"""Cost hook — attributed FLOPs per step, MFU and the roofline gap.

Counterpart of `paddle_tpu/obs/cost.py`. The reference reads XLA's
`compiled.cost_analysis()`; the port's count is
`torch.utils.flop_counter.FlopCounterMode` over one forward + backward
(`jit.TrainStep.cost_analysis`, which counts the flash kernels through
their registered formulas). torch does not count the bytes a step moves,
so `bytes_accessed` is None there and the roofline gap reports MFU alone.
MFU and the HBM fraction default to the H100's dense bf16 peak
(989 TFLOP/s) and memory rate (3.35 TB/s).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["executable_cost", "attributed_mfu", "roofline_gap",
           "H100_PEAK_BF16_FLOPS", "H100_HBM_BYTES_PER_S"]

# NVIDIA H100 SXM: dense bf16 tensor-core peak and HBM3 rate
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def executable_cost(compiled) -> Dict[str, float]:
    """Normalized {flops, bytes_accessed, ...} from `compiled.
    cost_analysis()` (the port's `TrainStep.cost_analysis` result, or an
    object with that method): a dict, or a one-element list of dicts,
    with the reference's keys ('flops', 'bytes accessed' or
    'bytes_accessed', 'transcendentals'). Absent/failed analysis, and
    counts torch does not make (None), are left out."""
    try:
        ca = compiled if isinstance(compiled, dict) \
            else compiled.cost_analysis()
    except Exception:
        return {}
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    if not isinstance(ca, dict):
        return {}
    out: Dict[str, float] = {}
    for key, norm in (("flops", "flops"),
                      ("bytes accessed", "bytes_accessed"),
                      ("bytes_accessed", "bytes_accessed"),
                      ("transcendentals", "transcendentals")):
        if key in ca and isinstance(ca[key], (int, float)):
            out[norm] = float(ca[key])
    return out


def attributed_mfu(flops_per_step: float, step_time_s: float,
                   peak_flops: float = H100_PEAK_BF16_FLOPS) -> float:
    """MFU from the attributed FLOP count: what fraction of the
    chip's peak the executable actually sustained."""
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step / (step_time_s * peak_flops)


def roofline_gap(cost: Dict[str, float], step_time_s: float,
                 peak_flops: float = H100_PEAK_BF16_FLOPS,
                 hbm_bytes_per_s: Optional[float] = H100_HBM_BYTES_PER_S
                 ) -> Dict[str, Any]:
    """Which wall is the step leaning on: compute (MFU) vs memory
    (HBM-roofline fraction), both from the SAME attributed cost dict."""
    out: Dict[str, Any] = {}
    if "flops" in cost:
        out["mfu"] = attributed_mfu(cost["flops"], step_time_s, peak_flops)
    if hbm_bytes_per_s and "bytes_accessed" in cost and step_time_s > 0:
        out["hbm_frac"] = cost["bytes_accessed"] / (step_time_s *
                                                    hbm_bytes_per_s)
    if "mfu" in out and "hbm_frac" in out:
        out["bound"] = "memory" if out["hbm_frac"] > out["mfu"] else "compute"
    return out
