"""Inter-token latency, 95th percentile, ms: the gaps between consecutive
output tokens of each request, stamped when the ``Server.step`` that made
the token returned, over every gap that ends in the window."""
from portbench import stats


def read(run):
    return stats.itl_tail_ms(run, 95)
