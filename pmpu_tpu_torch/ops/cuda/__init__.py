"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.

Each wrapper dispatches on its tensors' device: on the CPU it runs the
plain version (the CPU tests use it); on a CUDA tensor it launches the
kernel or raises — nothing falls back. Sources live in ``csrc/``; they are
compiled with ``nvcc`` into one shared library per source at first use
(``_build.py``) and bound with ``ctypes``. Importing this package builds
and loads nothing.
"""
