"""``repro_torch`` -- the PyTorch/CUDA port of :mod:`repro`.

Mirrors ``repro``'s layout and public names module by module; the
transform kernels are written by hand for Hopper (``kernels/csrc``) and
bound with ``ctypes``.  Nothing here imports JAX or the ``repro``
package: the JAX package is the reference the port is tested against.
"""
