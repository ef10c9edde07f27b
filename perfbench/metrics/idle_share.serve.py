"""Per cent of a request's wall in which no operation ran on the device:
the device's busy seconds a request (the union of its kernels' and copies'
intervals in a ``torch.profiler`` trace of a few requests after the window)
over the window's own seconds a request."""
from perfbench.readings import idle_share


def read(run):
    return idle_share(run)
