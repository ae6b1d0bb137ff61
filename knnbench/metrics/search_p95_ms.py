"""search_p95_ms: the 95th percentile over every search of the window,
each timed on the host clock from the call into ``KNNEngine.search`` until
its (dists, ids) are on the host."""
import statistics


def read(run):
    lat = run.latencies_s
    if len(lat) < 2:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
