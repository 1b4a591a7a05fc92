"""Device kernels, memsets and copies per request, from the profiler's
trace: the activities whose launch lies inside a request's mark, for the
median request of the profiled span.  Independent of kernel names.  Layer: the kernel wrappers
(``kernels/ops.py``, ``kernels/sfdprt.py``, ``kernels/stream.py``)."""


def read(obs):
    p = obs.profile
    if p is None or not p.activities_per_request:
        return None
    return p.activities_per_request
