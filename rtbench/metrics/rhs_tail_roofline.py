"""K8 rhs_tail's share of its roofline over the traced calls: the least
time of its launches (rtbench.costs.rt_cost at [lanes] lanes, the
configuration's variant and the beta table's nodes) over their device
time in the trace, in percent."""

from rtbench import costs


def read(rec: dict):
    t = rec.get("traced")
    k = (t or {}).get("trace", {}).get("kernels", {})
    n, secs = k.get("rhs_tail", (0, 0.0))
    if not n or secs <= 0:
        return None
    sh = rec["inputs"]
    c = costs.rt_cost(sh["lanes"], sh["nk"], sh["nz"], sh["rt_variant"])
    return 100.0 * n * c["bound_ms"] * 1e-3 / secs
