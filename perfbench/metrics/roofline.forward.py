"""The forward's share of its roofline: the least time for the forward at
the cell's shape and dtypes (``costs/<op>.py`` at ``peaks.py``'s rates)
over the device time of the whole ``op(x)`` call, from CUDA events
recorded on the stream just before and just after it, summed over the
requests of the traced window (the widening included)."""


def read(obs):
    return obs.roofline("forward")
