"""Share of the traced window in which no operation ran on the card."""

from rtabench.tracing import idle_pct


def read(run):
    return idle_pct(run)
