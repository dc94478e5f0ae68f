"""The extraction window's share with nothing running on the card, in
percent: one minus the union of the device's kernel, copy and set intervals
(the profiler's timeline) over the window's seconds."""


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
