"""Output tokens completed in the window over the window's seconds, in a
cell offered more than the server completes: a backlog grows from the
start, so this is the server's capacity under the mix."""
from portbench import stats


def read(run):
    return stats.tokens_in(run.requests, run.t0, run.t_end) / run.seconds
