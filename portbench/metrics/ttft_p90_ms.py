"""Time to first token, 90th percentile, ms: from each request's due time
in the open-loop schedule to its first token (the prefill's argmax on the
host), over every request due in the window.  A request without a first
token when the run stops counts as missing and sorts above every time;
where the percentile falls among those, the value is the longest wait
any of them had when the run stopped (a lower bound)."""
from portbench import stats


def read(run):
    return stats.ttft_tail_ms(run, 90)
