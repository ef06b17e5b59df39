"""latency_p50_ms.b1: the median request's host-clock time (traced run)."""

from benchmark.reading import latencies_ms, percentile


def read(run):
    return percentile(latencies_ms(run), 50)
