"""The 95th percentile of every request's time to first token, from its
client's issue to the end of the serve call that answered it (its cache
handed over), over all requests of the window."""
import statistics


def read(r):
    ttft = r["run"].get("ttft_s")
    if not ttft or len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=20)[-1] * 1e3
