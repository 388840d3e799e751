"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``),
each beside its plain torch version. Call them through ``kernels.ops``."""

# The profiler's records of CUPTI's own overhead (buffer requests, lazy
# loading), which it files beside the device's work; no kernel, copy or
# memset has one of these names.
CUPTI_RECORDS = (
    "Activity Buffer Request", "Lazy Function Loading", "Command Buffer Full",
    "Runtime Triggered Module Loading", "Instrumentation", "Resource",
    "UVM Activity Init",
)


class KernelTotal:
    """One name's device records in a profile: ``key`` (the name),
    ``count`` and ``self_device_time_total`` (µs), as ``key_averages()``
    names them."""

    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_kernels(prof):
    """The device's kernels, copies and memsets in a ``torch.profiler``
    run, summed by name (:class:`KernelTotal`), without CUPTI's own records
    and without the device-side spans of ``record_function`` ranges (user
    annotations), which the profiler files on the device's timeline beside
    the kernels they enclose. Read from the profiler's raw records: the
    same totals as ``key_averages()``, which first builds a tree of every
    event (~10 s for the ~90,000 kernels of 360 ADWISE steps, against
    ~1 s here)."""
    from torch.autograd import DeviceType

    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        if name in CUPTI_RECORDS:
            continue
        rec = totals.get(name)
        if rec is None:
            rec = totals[name] = KernelTotal(name)
        rec.count += 1
        rec.self_device_time_total += e.duration_ns() / 1e3
    return list(totals.values())
