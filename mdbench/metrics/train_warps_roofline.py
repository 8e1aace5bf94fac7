"""train_warps_roofline: the sum of the bounds over the sum of the device
times of the train step's warp kernels in the traced steps: the plane-sweep
warp forward and backward (bf16 features, one source frame) and the
border image warp and its coordinate backward (float32, K = scales + 2
maps, one call per source frame), at the cell's shapes."""

from mdbench import work
from mdbench.readers import roofline


def read(run):
    cfg = run.ref_cfg
    b = int(run.traffic["batch"])
    s = work.mvs_shape(cfg, b)
    sweep = (s["b"], s["r"], s["w"], s["c"], s["d"], s["h"], 2)
    k = len(cfg.scales) + 2
    image = (b, k, cfg.height, cfg.width, 3)
    frames = len(cfg.frame_ids) - 1
    sources = len(cfg.matching_ids) - 1
    return roofline(run, [
        (r"sweep_warp_fwd_kernel<", sources,
         work.bound_ms(*work.sweep_warp_work(*sweep))),
        (r"sweep_warp_bwd_kernel<", sources,
         work.bound_ms(*work.sweep_warp_work(*sweep, backward=True))),
        (r"(^|[\s:])fwd_kernel<", frames,
         work.bound_ms(*work.image_warp_work(*image))),
        (r"(^|[\s:])bwd_kernel<", frames,
         work.bound_ms(*work.image_warp_work(*image, backward=True)))])
