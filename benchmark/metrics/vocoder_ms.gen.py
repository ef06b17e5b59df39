"""vocoder_ms.gen: the vocoder stage's device ms in a request (CUDA events
of forward hooks on the port's module, summed over its calls in the
request), the median over the window's requests."""

from benchmark.reading import stage_median_ms


def read(run):
    return stage_median_ms(run, "vocoder")
