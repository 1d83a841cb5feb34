"""K1 (``kernels/ame_gemm.py``) under ``decode_step``, % of its roofline:
the launches' bounds (``work.k1_bound_s``) summed over their device times
from the profiled slice summed."""
from portbench import roofline


def read(run):
    return roofline.share(run.k1, "decode", roofline.k1)
