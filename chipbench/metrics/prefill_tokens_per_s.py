"""The valid prompt tokens of every request answered (padding not counted)
over the whole window, from the first request's issue to the last answer."""


def read(r):
    run = r["run"]
    if "valid_tokens" not in run:
        return None
    return run["valid_tokens"] / run["window_s"]
