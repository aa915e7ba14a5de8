"""Cosmologies solved to tables a minute: every cosmology of every whole
call in the window over the window's seconds (host clock, the card
synchronised after each call)."""


def read(rec: dict):
    w = rec.get("window")
    if not w or w["seconds"] <= 0:
        return None
    return 60.0 * w["cosmologies"] / w["seconds"]
