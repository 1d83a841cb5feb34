"""The decode step's share of the chip's peak, % (DeepSeek-V3's family):
over the synchronised spans of ``models/model.py:decode_step`` outside
the profiled slice, the least time of each step
(``families/mla_moe.py:decode_bound_s``: weights once, of the held
experts those the live rows reach, the latent cache, the absorbed
attention's FLOPs) summed, over the spans' measured time summed."""
from portbench.families import mla_moe


def read(run):
    spans = [s for s in run.spans if s["phase"] == "decode"
             and not s["profiled"] and s["positions"]]
    if not spans:
        return None
    need = sum(mla_moe.decode_bound_s(run.cfg, s["positions"])
               for s in spans)
    return 100.0 * need / sum(s["end"] - s["start"] for s in spans)
