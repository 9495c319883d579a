"""ivf_route_ms_per_call: device ms a call in the program's stage ``ivf.route``
(``models/ivf_base.route_to_cells``: the routing product and sort), the interval
its CUDA events give, idle time included."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "ivf.route", "device_ns", 1e-6)
