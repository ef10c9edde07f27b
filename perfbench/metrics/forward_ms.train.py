"""Device ms of a point-net train step's forward and loss: CUDA events
around ``PointSegTrainer.forward_loss``, mean over the traced window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "forward_loss")
