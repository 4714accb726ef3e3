"""The port's five kernels (the `spig::*` custom ops) against their
roofline, time-weighted over the sub-window traced with shapes: the sum of
each launch's least time (its bytes at the card's HBM rate or its FLOPs at
the peak of its dtype, the larger; each input byte read once and each output
byte written once, from the recorded shapes) over the device time of the
operations those ops launched. Nothing when no such op ran."""

from benchmark import peaks
from benchmark import trace as tr


def read(run):
    events = run.shapes["events"]
    ops = tr.op_trees(events)
    device_us, rows = 0.0, {}
    for e in tr.device_events(events):
        launcher = ops.get(e.get("args", {}).get("External id"))
        if launcher is None:
            continue
        row = tr.row_op(launcher)
        if row.name.startswith("spig::"):
            device_us += e.get("dur", 0)
            rows[id(row)] = row
    if device_us <= 0:
        return None
    least = 0.0
    for op in rows.values():
        flops = (tr.attention_flops(op)
                 if op.name == "spig::pooled_kv_attention" else 0)
        least += max(tr.op_bytes(op) / peaks.HBM_BYTES_PER_S,
                     flops / peaks.op_peak(op))
    return 100.0 * least / (device_us * 1e-6)
