"""Device ms of the decimation pyramid and its KNN searches (`FusedPointUnet._pyramid_fn`) a request: CUDA events around the call, mean over
the traced run's window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "pyramid")
