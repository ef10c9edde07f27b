"""Per cent of a step's wall in which no operation ran on the device:
the device's busy seconds a step (the union of its kernels' and copies'
intervals in a ``torch.profiler`` trace of a few steps after the window)
over the window's own seconds a step."""
from perfbench.readings import idle_share


def read(run):
    return idle_share(run)
