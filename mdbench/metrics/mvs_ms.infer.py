"""mvs_ms.infer: device ms per batch of the multi-view branch, from the
start of ``mvs_encoder`` (FPN4) through the cost volume to the end of
``reg3d`` (CUDA events in forward hooks), over the window."""

from mdbench.readers import event_span, mean_event_ms


def instrument(run, state):
    event_span(run, "mvs", state.models["mvs_encoder"],
               state.models["reg3d"])


def read(run):
    return mean_event_ms(run, "mvs")
