"""The prefill's share of the chip's peak, %: as ``decode_mfu`` over the
spans of ``models/model.py:prefill``, with ``work.prefill_work``."""
from portbench import work


def read(run):
    spans = [s for s in run.spans if s["phase"] == "prefill"
             and not s["profiled"]]
    if not spans:
        return None
    need = sum(work.bound_s(*work.prefill_work(run.cfg, s["tokens"]))[0]
               for s in spans)
    return 100.0 * need / sum(s["end"] - s["start"] for s in spans)
