"""summer_clip_torch: the PyTorch / CUDA (Hopper) port of summer_clip_tpu.

The JAX package ``summer_clip_tpu`` is the reference; this package mirrors its
layout (``models/clip``, ``ops``, ``methods``, ``apps``, ``engine``, ``data``,
``core``, ``store``, ``conf``) and keeps its own copy of every
framework-neutral module it uses (config composition, logging, the feature
store, datasets, tokenizer, the yaml configs), under the same relative name.
It imports ``torch``, never ``jax``, and nothing of ``summer_clip_tpu``.

Kernels are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` on first
use into ``summer_clip_torch/build/`` and bound through ``ctypes``
(``ops/_lib.py``). On CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
