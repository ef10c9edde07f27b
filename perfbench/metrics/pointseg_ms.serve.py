"""Device ms of the point net's forward, argmax and label scatter (`FusedPointUnet._pointseg_scatter`) a request: CUDA events around the call, mean over
the traced run's window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "pointseg")
