"""Per cent of the card's peak in the step's precision that a train step's
model operations reach: forward and backward (3x the forward) of the
step's batch at the cell's shapes (``counters``) over the window's
seconds a step times the peak."""
from perfbench.readings import flops_peak


def read(run):
    if not run.get("rows"):
        return None
    return 100.0 * run["work"]["step_ops"] / (run["step_s"] * flops_peak(run, run["path"]))
