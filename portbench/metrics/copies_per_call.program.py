"""The program's `window.copies` counter over the `spans` window's
calls: the copies a call's scalar blocks issue on the card (the pinned
upload, and each tensor scalar's copy into the block)."""
from portbench import spans


def read(run):
    w = spans.of(run)
    if w is None or not w.window.calls or \
            "window.copies" not in w.counters:
        return None
    return w.counters["window.copies"] / w.window.calls
