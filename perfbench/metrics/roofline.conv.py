"""The convolution's share of its roofline: the least time for the DPRT
method's forward, per-direction 1-D convolutions and inverse at the
cell's shape and dtypes (``costs/conv2d.py`` at ``peaks.py``'s rates)
over the device time of the whole ``op(x)`` call of ``radon.Conv2D``,
from CUDA events recorded on the stream just before and just after it,
summed over the requests of the traced window (the kernel's own forward,
the widening, the memset and K2's finish kernel included)."""


def read(obs):
    return obs.roofline("conv")
