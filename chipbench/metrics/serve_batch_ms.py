"""The mean wall milliseconds of a ``SplitwiseCluster.serve`` call, ending in
a synchronisation, over the window's calls (traced ones left out)."""
import statistics


def read(r):
    s = [b["seconds"] for b in r["run"].get("batch_log", []) if not b["traced"]]
    return statistics.fmean(s) * 1e3 if s else None
