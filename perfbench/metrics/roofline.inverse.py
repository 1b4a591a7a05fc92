"""The inverse's share of its roofline: as ``roofline.forward``, for the
whole ``op.inverse(r)`` call."""


def read(obs):
    return obs.roofline("inverse")
