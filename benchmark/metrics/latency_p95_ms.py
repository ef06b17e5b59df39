"""latency_p95_ms: the 95th percentile of every request's host-clock time,
from the call to its waveform on the host."""

from benchmark.reading import latencies_ms, percentile


def read(run):
    return percentile(latencies_ms(run), 95)
