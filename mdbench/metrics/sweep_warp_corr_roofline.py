"""sweep_warp_corr_roofline: the bound of one cost-volume call at the
cell's shapes (``work.sweep_corr_work``: bf16 features, float32
coordinates) over the device time per call of ``sweep_warp_corr_kernel``
in the traced batches. One call per batch: one source frame."""

from mdbench import work
from mdbench.readers import roofline

KERNEL = r"sweep_warp_corr_kernel<"


def read(run):
    s = work.mvs_shape(run.ref_cfg, int(run.traffic["batch"]))
    ms = work.bound_ms(*work.sweep_corr_work(s["b"], s["r"], s["w"], s["c"],
                                             s["d"], s["h"], s["g"], 2))
    return roofline(run, [(KERNEL, len(run.ref_cfg.matching_ids) - 1, ms)])
