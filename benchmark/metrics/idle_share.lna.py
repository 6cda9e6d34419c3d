"""The device: the share of the traced window in which no device activity
ran."""


def read(r):
    if not r["busy_s"]:
        return None
    return (1 - r["busy_s"] / r["window_s"]) * 100
