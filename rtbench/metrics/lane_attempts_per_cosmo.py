"""Controller attempts the lockstep runs a cosmology over the traced
calls: K3 rk_finish launches (the program's launch counter; one a lane
attempt on every lane of the chunk) times the lanes, over the
cosmologies the calls solved."""


def read(rec: dict):
    t = rec.get("traced")
    if not t or not t["cosmologies"] or not t["launches"].get("rk_finish"):
        return None
    return t["launches"]["rk_finish"] * rec["inputs"]["lanes"] / \
        t["cosmologies"]
