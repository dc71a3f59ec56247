"""repro_torch: the single-device BWT/FM-index build and count/locate
query path in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

Mirrors the module paths of the JAX package ``repro`` (its reference) and
imports nothing from it.  Entry points run on ``torch.device("cuda")``
unless the caller passes ``device="cpu"``; kernel wrappers take their plain
PyTorch version only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"
