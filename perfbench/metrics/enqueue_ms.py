"""Host milliseconds to issue one request (``op(x)``, then
``op.inverse(r)``), with no synchronise: the mean of a host-clock span in
the benchmark's step over the requests of the traced window.  Layer: the
operator API and the plan (``radon/operators.py``, ``core/plan.py``)."""


def read(obs):
    if not obs.enqueue_s:
        return None
    return 1e3 * sum(obs.enqueue_s) / len(obs.enqueue_s)
