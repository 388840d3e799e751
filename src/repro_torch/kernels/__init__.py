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


def device_kernels(prof):
    """The device's kernels, copies and memsets in a ``torch.profiler``
    run's ``key_averages()``, without CUPTI's own records and without the
    device-side spans of ``record_function`` ranges (user annotations),
    which the profiler files on the device's timeline beside the kernels
    they enclose."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in CUPTI_RECORDS
            and not getattr(e, "is_user_annotation", False)]
