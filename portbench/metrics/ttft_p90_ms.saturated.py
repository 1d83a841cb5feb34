"""``ttft_p90_ms`` in a cell offered more than the server sustains: the
queue grows all through the window, so the tail swings with the
smallest change; it is recorded, not judged."""
from portbench import stats


def read(run):
    return stats.ttft_tail_ms(run, 90)
