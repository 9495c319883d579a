"""ivf_lists_ms_per_call: device ms a call in the program's stage ``ivf.lists``
(the task lists built on the device, ``ops/probe_device.py``: the sort, the
counts read back, the scatters), the interval its CUDA events give."""

from portbench import spans

start = spans.start


def read(ctx):
    return spans.per_call(ctx, "ivf.lists", "device_ns", 1e-6)
