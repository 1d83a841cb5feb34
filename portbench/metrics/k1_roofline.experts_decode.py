"""K1 (``kernels/ame_gemm.py``) on the experts' products under
``decode_step``, % of its roofline: the launches whose (k, n) are an
expert's (d -> d_ff_expert, or 2 x d_ff_expert fused, and d_ff_expert ->
d; the shared expert has the same shapes and counts with them), their
bounds (``work.k1_bound_s``) summed over their device times from the
profiled slice summed."""
from portbench import roofline


def read(run):
    d, f = run.cfg["d_model"], run.cfg["moe"]["d_ff_expert"]
    shapes = {(d, f), (d, 2 * f), (f, d)}
    return roofline.share([ln for ln in run.k1 if (ln["k"], ln["n"])
                           in shapes], "decode", roofline.k1)
