"""Device idle share of the traced units: 100 x (1 - the union of the
device operations' intervals / the traced window). One reader for every
split (``idle_share.gen``, ``idle_share.train``)."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
