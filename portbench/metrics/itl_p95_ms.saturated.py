"""``itl_p95_ms`` in a cell offered more than the server sustains,
recorded, not judged."""
from portbench import stats


def read(run):
    return stats.itl_tail_ms(run, 95)
