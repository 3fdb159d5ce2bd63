"""Kernels launched per item (an image, or a training sample) over the
traced units (copies and sets not counted). One reader for every split
(``launches_per_item.gen``, ``launches_per_item.train``)."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["items"] or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["items"]
