"""K2's share of the card's special-function peak, by the work its lanes'
own inputs need."""

from rtabench.tracing import roofline_pct


def read(run):
    return roofline_pct(run, "segment")
