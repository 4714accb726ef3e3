"""The whole training step's share of the card's peak: the FLOPs of the
benchmark's own reference step at the cell's shapes (never the program's
launches), times the steps of the traced run's unprofiled window, over that
window's seconds, at the peak of the configuration's compute dtype."""

from benchmark import peaks


def read(run):
    if not run.on_card:
        return None
    flops = run.step_flops()
    if not flops or not run.window.get("seconds"):
        return None
    rate = flops * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / peaks.FLOPS[run.cell.config["compute_dtype"]]
