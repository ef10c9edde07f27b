"""Per cent of the card's peak in the serving precision that a request's
model operations reach: both nets' operations at the cell's shapes
(``counters``) over the mean request wall of the window times the peak."""
from perfbench.readings import flops_peak, mean_wall_s


def read(run):
    wall = mean_wall_s(run)
    if not wall or not run.get("rows"):
        return None
    work = run["work"]
    ops = work["attention_ops"] + work["pointnet_ops"]
    return 100.0 * ops / (wall * flops_peak(run, "serve"))
