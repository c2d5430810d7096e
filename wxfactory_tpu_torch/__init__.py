"""wxfactory_tpu_torch: the PyTorch/CUDA port of wxfactory_tpu.

The second package beside ``wxfactory_tpu`` (the JAX reference, which it is
tested against on identical inputs). It runs the shallow-water explicit main
path on an NVIDIA GPU:

    INI -> geometry/metric/topology -> Williamson case 2/6 -> SW operator
    (hand-written CUDA kernel, csrc/sw_operator.cu) -> Euler1/TVD-RK3 ->
    checkpoint

It imports ``torch`` and never ``jax`` or ``wxfactory_tpu``. The numpy/sympy
setup code (config, quadrature, DFR operators, geometry, topology tables,
test cases) is carried over as code.

Dtype policy: float64 by default, float32 with ``precision = float32``.
TF32 is switched off for both matmuls and cuDNN, because TF32 keeps about
three decimal digits — far too few for the geostrophic-balance cancellation
in the shallow-water tendencies.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
