"""K3's share of its roofline over the traced calls: the least time of
its launches (rtbench.costs: each attempt's rk_stage for stages 1 to s-1
and its rk_finish on the [lanes, 41 nk] state) over their device time in
the trace, in percent."""

from rtbench import costs


def read(rec: dict):
    t = rec.get("traced")
    k = (t or {}).get("trace", {}).get("kernels", {})
    n_fin, s_fin = k.get("rk_finish", (0, 0.0))
    n_st, s_st = k.get("rk_stage", (0, 0.0))
    if not n_fin or s_fin + s_st <= 0:
        return None
    sh = rec["inputs"]
    B, D, s = sh["lanes"], 41 * sh["nk"], sh["stages"]
    stage_ms = sum(costs.rk_stage_cost(B, D, i)["bound_ms"]
                   for i in range(1, s))
    # each attempt's stages, as many as the trace holds
    per_stage_ms = stage_ms / (s - 1)
    bound_ms = (n_fin * costs.rk_finish_cost(B, D, s)["bound_ms"]
                + n_st * per_stage_ms)
    return 100.0 * bound_ms * 1e-3 / (s_fin + s_st)
