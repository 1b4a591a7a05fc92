"""The device's idle share of the profiled span: one minus the union of
its activities over the span, from the profiler's trace."""


def read(obs):
    p = obs.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
