"""The program's solver counters after a traced run.

`counters` gives `redtime_tpu_torch.profiling.counters()`: they count
while a torch.profiler records, so after `traced_calls` they cover both
traced passes (the device-only pass and the host-traced one), while
`rec["traced"]["launches"]` covers the first alone.  None where the
program has no counters.
"""

from __future__ import annotations


def counters(rec: dict):
    """The program's solver counters after the traced calls of rec, or
    None without traced calls or where the program counts nothing."""
    if not rec.get("traced"):
        return None
    try:
        from redtime_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if read is not None else None
