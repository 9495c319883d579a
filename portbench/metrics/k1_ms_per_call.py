"""k1_ms_per_call: device ms a call in K1, the fused IVF cell scan
(``csrc/ivf_scan.cu``: ``ivf_scan_kernel`` and the wide rows'
``query_terms_kernel``), from the profiler's timeline."""

from portbench.trace import K1, per_call_s


def read(ctx):
    s = per_call_s(ctx, K1)
    return None if not s else 1e3 * s
