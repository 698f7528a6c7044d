"""PyTorch/CUDA port of flowavenet_tpu (one-shot synthesis on the GPU).

Imports no JAX; see README.md, "PyTorch port".
"""

from .config import (Config, ModelConfig, get_config, lj8k, lj8k_gin,  # noqa: F401
                     lj22k, tiny, tiny_gin)
