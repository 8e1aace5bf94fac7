"""mono_ms.infer: device ms per batch of the mono branch, from the start
of ``mono_encoder`` to the end of ``mono_depth`` (CUDA events in forward
hooks), over the window."""

from mdbench.readers import event_span, mean_event_ms


def instrument(run, state):
    event_span(run, "mono", state.models["mono_encoder"],
               state.models["mono_depth"])


def read(run):
    return mean_event_ms(run, "mono")
