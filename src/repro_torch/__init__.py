"""PyTorch/CUDA port of the ADWISE system (the JAX package ``repro`` is the
reference it is held against).

The port mirrors ``repro``'s module paths and public names:

  repro_torch.graph      generators + quality metrics (numpy copies)
  repro_torch.core       AdwiseConfig, the ADWISE scan step, the resident
                         scan driver, hash/dbh/grid, the registry
  repro_torch.kernels    hand-written CUDA kernels (``csrc/*.cu``) behind
                         ``kernels.ops``, each beside its plain torch version
  repro_torch.engine     partitioned graph, GAS supersteps, workloads,
                         latency model
  repro_torch.launch     the partition -> process command line
  repro_torch.convert    scan carry / partitioned graph <-> numpy

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CUDA tensor every kernel op launches its kernel or raises.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
