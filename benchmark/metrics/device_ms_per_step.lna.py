"""train/step -> models/: device ms a micro-step, the union of the device
activities' intervals over the window's micro-steps."""


def read(r):
    if not r["busy_s"]:
        return None
    return r["busy_s"] / r["units"] * 1e3 if r["units"] else None
