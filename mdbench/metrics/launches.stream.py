"""launches.stream: kernels the device ran per frame in the traced
frames (each launch runs one kernel)."""


def read(run):
    kernels = (run.profile or {}).get("kernels")
    if not kernels or not run.traced_units:
        return None
    return len(kernels) / run.traced_units
