"""The whole request's share of the chip's peak: the counted least time
of every stage of every request completed in the traced window (the same
counts and peaks as the rooflines) over the time from the window's start
to the last of those completions.  It still bounds a gain after a kernel
is fused away or renamed."""


def read(obs):
    if obs.stage_device_s is None or not obs.completed or obs.span_s <= 0:
        return None
    return (100.0 * obs.completed * sum(obs.stage_least_s.values())
            / obs.span_s)
