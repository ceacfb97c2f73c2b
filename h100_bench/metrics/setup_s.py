"""Set-up: process start to the first timed frame or step, in s (inputs,
kernel builds on a checkout's first run, the capacity probe, warm-up)."""


def read(run):
    return run.setup_s
