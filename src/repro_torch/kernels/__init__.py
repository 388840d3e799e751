"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``),
each beside its plain torch version. Call them through ``kernels.ops``."""
