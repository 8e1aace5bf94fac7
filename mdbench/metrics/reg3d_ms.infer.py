"""reg3d_ms.infer: device ms per batch of ``infer.reg3d`` (Reg3D, the
softmax and the decode; CUDA events of the port's tracer), over the
window and the traced units."""

from mdbench import spans


def instrument(run, state):
    spans.instrument(run, state, device=True)


def read(run):
    return spans.device_ms(run, "infer.reg3d")
