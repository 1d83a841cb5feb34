"""K1 (``kernels/ame_gemm.py``) under ``prefill``, % of its roofline."""
from portbench import roofline


def read(run):
    return roofline.share(run.k1, "prefill", roofline.k1)
