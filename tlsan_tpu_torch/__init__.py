"""tlsan_tpu_torch: the PyTorch and CUDA port of ``tlsan_tpu``.

It keeps the JAX package's module layout and names, so each counterpart is
easy to find, and runs on an NVIDIA GPU (Hopper, ``sm_90a``) by default.
Plain tensor code is PyTorch; each TPU kernel of the JAX package becomes a
CUDA kernel written by hand, under ``csrc/``, with its plain PyTorch version
beside it.  The package imports ``torch``, ``numpy`` and the standard
library only.

Layering (bottom-up):
  core/      configs and JSON sidecars
  data/      numpy feature code shared by the offline builders and serving
  parallel/  the (dp, mp) mesh on torch.distributed: process grid,
             collectives, sharded lookups and top-k, a local launcher
  nn/        embedding lookups (one device or the mesh), masks,
             initializers, layer norm, dense
  ops/       feature-wise and multi-head attention: plain versions + CUDA
             kernels (ops/cuda/)
  models/    TLSAN and ATRank as nn.Modules whose parameters keep the JAX
             names
  tools/     the numpy weights bridge to and from the JAX parameter tree
  train/     checkpoints, the optimizer, the evaluator and the Trainer
             (one device or one rank of a mesh)
  serve/     featurization, the top-k Recommender (one device or a mesh)
             and the HTTP endpoint (one device)
"""

__version__ = "0.1.0"
