"""The share of the rows the row gather launches over that hold an
instance, in %, over the traced training steps: as `live_rows_pct.frame`,
from the records of the program's ``sj.step`` spans."""
import spans


def read(run):
    if run.unit != "step":
        return None
    return spans.live_rows_pct(run, "sj.step")
