"""The decode step's share of the chip's peak, %: over the synchronised
spans of ``models/model.py:decode_step`` outside the profiled slice, the
least time the work needs (``work.decode_work``: the larger of its FLOPs
at 989 TFLOP/s and its bytes at 3.35 TB/s, for the live sequences only)
summed, over the spans' measured time summed."""
from portbench import work


def read(run):
    spans = [s for s in run.spans if s["phase"] == "decode"
             and not s["profiled"] and s["positions"]]
    if not spans:
        return None
    need = sum(work.bound_s(*work.decode_work(run.cfg, s["positions"]))[0]
               for s in spans)
    return 100.0 * need / sum(s["end"] - s["start"] for s in spans)
