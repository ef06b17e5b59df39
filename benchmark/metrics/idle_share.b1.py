"""The share of the traced window in which the card ran nothing, in %."""

from benchmark.reading import idle_pct


def read(run):
    return idle_pct(run)
