"""The share of the rows the row gather launches over that hold an
instance, in %: 100 x the sum over the traced frames of min(``instances``,
``rows``) over the sum of ``rows``, from the program's counter records
(``instances``: listed before the capacity cut; ``rows``: the gather's
rows, the capacity). Frames that gather nothing (redraws) do not count."""
import spans


def read(run):
    if run.unit != "frame":
        return None
    return spans.live_rows_pct(run, "sj.frame")
