"""Device ms of a saliency train step's backward passes: from each
micro-batch's ``forward_loss`` mark to its ``backward`` mark (the marks
``SaliencyTrainer.train_step`` calls), summed a step, mean over the
traced window."""
from perfbench.readings import between_mean


def read(run):
    return between_mean(run, "mark.forward_loss", "mark.backward")
