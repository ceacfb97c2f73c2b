"""Frame time: the window's seconds over the frames it completed, in ms
(each frame ends in a sync, as a viewer presents it)."""


def read(run):
    if run.unit != "frame" or not run.durations or run.trace is not None:
        return None
    return run.window_s * 1e3 / len(run.durations)
