"""The share of the traced serve calls' wall time in which no kernel, copy or fill
ran on the card, in %."""


def read(r):
    window = r["run"].get("trace")
    if window is None or window.window_s <= 0 or window.busy_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
