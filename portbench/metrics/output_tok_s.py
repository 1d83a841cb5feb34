"""Output tokens delivered in the window over the window's seconds."""
from portbench import stats


def read(run):
    return stats.tokens_in(run.requests, run.t0, run.t_end) / run.seconds
