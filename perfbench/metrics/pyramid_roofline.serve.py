"""Per cent of the pyramid stage's time that its byte bound accounts for:
the cloud read and every level's points and neighbour rows written once
(``counters``: ``pyramid_bytes``) over the memory's peak rate; over
``pyramid_ms.serve``."""
from perfbench.readings import bytes_peak, share, span_mean


def read(run):
    return share(run["work"]["pyramid_bytes"] / bytes_peak(run),
                 span_mean(run, "pyramid"))
