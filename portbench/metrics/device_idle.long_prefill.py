"""Share of the profiled slice in which no kernel, copy or fill ran on
the card, %."""
from portbench import roofline


def read(run):
    return roofline.idle(run)
