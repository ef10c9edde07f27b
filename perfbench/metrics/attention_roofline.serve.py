"""Per cent of the attention stage's time that its roofline bound accounts
for: the larger of the saliency net's operations at the cell's window over
the peak of the serving precision, and the stage's least bytes (the window
read, the weights, the mask written) over the memory's peak rate
(``counters``); over ``attention_ms.serve``."""
from perfbench.readings import bytes_peak, flops_peak, share, span_mean


def read(run):
    work = run["work"]
    bound = max(work["attention_ops"] / flops_peak(run, "serve"),
                work["attention_bytes"] / bytes_peak(run))
    return share(bound, span_mean(run, "attention"))
