"""The share of the all_to_all send buffer's rows that hold a gaussian,
in %, over the traced band steps: 100 x the program's ``pair_rows``
counters (rows rank 0 sends) over its ``pair_capacity_rows`` (the rows
it could send), from the records of its ``sj.step`` spans."""
import spans


def read(run):
    if run.unit != "step":
        return None
    pairs = [(r.get("pair_rows"), r.get("pair_capacity_rows"))
             for r in spans.records(run, "sj.step")]
    pairs = [(n, cap) for n, cap in pairs if n is not None and cap]
    if not pairs:
        return None
    return 100.0 * sum(n for n, _ in pairs) / sum(c for _, c in pairs)
