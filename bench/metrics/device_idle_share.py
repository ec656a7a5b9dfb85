"""Share of the traced window in which no kernel, copy or memset ran on
the card: 1 - (union of the device's intervals) / window, in percent."""


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
