"""The share of the lockstep's attempts over the traced calls launched
after every lane had finished its interval, in percent: 100 x
(ode.attempts_launched - ode.slowest_lane_attempts) / ode.attempts_launched
(the host checks the lanes once every CHECK_EVERY attempts), the
program's solver counters (rtbench.spans.counters, which cover both
traced passes); None where the program has none."""

from rtbench import spans


def read(rec: dict):
    c = spans.counters(rec)
    if not c or not c.get("ode.attempts_launched"):
        return None
    launched = c["ode.attempts_launched"]
    return 100.0 * (launched - c["ode.slowest_lane_attempts"]) / launched
