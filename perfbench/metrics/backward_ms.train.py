"""Device ms of a point-net train step's backward (the gather backward's
sorted scatter, kernel 2, among it): from the end of ``forward_loss`` to
the start of ``apply_update``, mean over the traced window."""
from perfbench.readings import between_mean


def read(run):
    return between_mean(run, "forward_loss.end", "apply_update.start")
