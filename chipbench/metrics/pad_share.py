"""The pad slots over all token slots of the batches handed to ``serve``
(each batch padded to its longest prompt), counted from the inputs, in %."""


def read(r):
    run = r["run"]
    if not run.get("slots"):
        return None
    return 100.0 * run["pad_slots"] / run["slots"]
