"""Share of the traced window in which no kernel, copy or fill ran on the card."""

UNIT = "%"


def read(run):
    t = run.trace
    return None if t is None or t.window_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)
