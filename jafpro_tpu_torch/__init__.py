"""PyTorch/CUDA port of ``jafpro_tpu`` (whole-clip video generation).

The package mirrors ``jafpro_tpu``'s layout module for module. It imports
``torch``, ``numpy`` and the standard library only; the JAX package is the
reference it is tested against, never a dependency. The one TPU kernel on
the generation path, the z-buffer rasterizer, is a hand-written CUDA kernel
(``csrc/rasterizer.cu``) built with ``nvcc`` at first use.
"""

from jafpro_tpu_torch.config import Config, get_general_options  # noqa: F401

__version__ = "0.1.0"
