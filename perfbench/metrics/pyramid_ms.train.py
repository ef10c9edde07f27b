"""Device ms of a point-net train step's pyramid and KNN searches: CUDA
events around ``PointSegTrainer.pyramid_fn``, mean over the traced run's
window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "pyramid")
