"""Images stepped over all the window's time (host clock, the window
ending when the card has finished its last step)."""


def read(rec: dict):
    w = rec["window"]
    return w["steps"] * rec["batch"] / w["seconds"]
