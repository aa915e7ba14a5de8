"""The share of the lockstep's lane-attempt slots over the traced calls
that did work a lane needed, in percent: 100 x ode.lane_attempts (each
lane's own controller attempts, summed) over ode.lane_slots (attempts
launched x lanes), the program's solver counters (rtbench.spans.counters,
which cover both traced passes); None where the program has none."""

from rtbench import spans


def read(rec: dict):
    c = spans.counters(rec)
    if not c or not c.get("ode.lane_slots"):
        return None
    return 100.0 * c["ode.lane_attempts"] / c["ode.lane_slots"]
