"""The device's idle share of the traced window, in percent: 100 (1 -
busy / window), busy being the union of every device operation's
interval in the torch.profiler trace (kernels, copies, fills)."""


def read(rec: dict):
    tr = (rec.get("traced") or {}).get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
