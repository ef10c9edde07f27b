"""Device ms of the attention stage (`FusedPointUnet._attention_mask`: the saliency net in its window, softmax, threshold) a request: CUDA events around the call, mean over
the traced run's window."""
from perfbench.readings import span_mean


def read(run):
    return span_mean(run, "attention")
