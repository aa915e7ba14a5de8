"""The RHS engine's share of its roofline over the traced calls: the
least time of its launches (rtbench.costs: K9 engine_front, K10 tab_leg,
K1 out_leg and K2 pz_leg on [lanes] spectra) over their device time in
the trace, in percent."""

from rtbench import costs

ENGINE = ("engine_front", "tab_leg", "out_leg", "pz_leg")


def read(rec: dict):
    t = rec.get("traced")
    k = (t or {}).get("trace", {}).get("kernels", {})
    if not all(name in k for name in ENGINE):
        return None
    sh = rec["inputs"]
    B, nk, npts, nfam = sh["lanes"], sh["nk"], sh["npts"], sh["nfam"]
    k9, k10 = costs.engine_costs(B, nk, npts, npts, nfam)
    bound = {"engine_front": k9, "tab_leg": k10,
             "out_leg": costs.out_leg_cost(B, nfam, 2 * npts, nk + 1),
             "pz_leg": costs.pz_leg_cost(B, nk, npts)}
    secs = sum(k[name][1] for name in ENGINE)
    if secs <= 0:
        return None
    least = sum(k[name][0] * bound[name]["bound_ms"] * 1e-3
                for name in ENGINE)
    return 100.0 * least / secs
