"""Hand-written CUDA kernels for the indexing hot spots, each beside its
plain PyTorch version: ``csrc/<name>.cu`` (plain C interface, built by
``_build`` with nvcc for sm_90a), a device-dispatching wrapper in
``<module>.py``, the public entry points in ``ops.py`` and plain oracles in
``ref.py``."""
