"""Device ms of context-aware sampling (`FusedPointUnet._sample`) a request: CUDA events around the call, mean over
the traced run's window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "sampling")
