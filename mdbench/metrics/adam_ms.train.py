"""adam_ms.train: device ms per step of Adam, from the optimizer's step
pre-hook to its post-hook (CUDA events), over the window."""

from mdbench.readers import event_span, mean_event_ms


def instrument(run, state):
    event_span(run, "adam", state.opt, state.opt, "step_pre", "step_post")


def read(run):
    return mean_event_ms(run, "adam")
