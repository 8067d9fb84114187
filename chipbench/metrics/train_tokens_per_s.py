"""Tokens of every step completed in the window over the whole window, each
step ending in a synchronisation."""


def read(r):
    run = r["run"]
    if "tokens_a_step" not in run:
        return None
    return run["steps"] * run["tokens_a_step"] / run["window_s"]
