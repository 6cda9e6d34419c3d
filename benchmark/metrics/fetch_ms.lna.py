"""data/ (the training loader): ms a micro-step waits for its batch, the
mean of the harness's span around each ``next`` on the loader."""


def read(r):
    s = r["spans"].get("fetch")
    return sum(s) / len(s) * 1e3 if s else None
