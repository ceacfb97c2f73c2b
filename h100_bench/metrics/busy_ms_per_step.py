"""Device busy time per traced step, in ms: the union of its kernel, copy
and set intervals over the step count. A steadier reading of the device's
share of `step_ms` than the host clock gives."""


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    busy = t.busy_s()
    return busy * 1e3 / t.units if busy > 0 else None
