"""Step time: the window's seconds over the training steps it completed,
in ms (each step ends in a sync)."""


def read(run):
    if run.unit != "step" or not run.durations or run.trace is not None:
        return None
    return run.window_s * 1e3 / len(run.durations)
