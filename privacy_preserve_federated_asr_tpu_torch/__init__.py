"""PyTorch/CUDA port of privacy_preserve_federated_asr_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package beside it is the reference; this package imports none of it
(nor jax, flax, optax or orbax). It mirrors the reference's subpackage
layout (``data/``, ``models/``, ``ops/``, ``serving/``, ``train/``,
``cli.py``) so each module has one counterpart there. The hand-written CUDA
kernels live in ``csrc/`` and build into ``build/torch_kernels/`` at first
use (``ops/cuda_build.py``).
"""

__version__ = "0.1.0"
