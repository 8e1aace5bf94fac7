"""Stage ablations of the plane-sweep warp-correlate kernel on the card
(port of scripts/profile_kernel_variants.py: ``main`` and ``wrapper_ab``).

    python -m movedepth_tpu_torch.profile_kernel_variants [batch]   # 128

Each variant of ``csrc/sweep_warp_corr_variants.cu`` takes one stage out
of the CUDA kernel: the gather (``no_gather``), the bilinear weights
(``no_weights``), the product with the reference features
(``no_correlate``) or the shuffle that sums a group over the lanes of a
point (``no_reduce``). They compute wrong results by design and serve
only to time what each stage adds; ``full`` is the shipped kernel, bit
for bit. :func:`main` times each variant at the
shipped inference shape (B=128, 48x160, C=32, D=16, G=16, bfloat16) with
:func:`device_ms` (many bare launches between two CUDA events), then one
call of the public ``sweep_warp_corr`` wrapper (checks, allocation,
launch; :func:`cuda_ms`) against the bare ``full`` launch. The TPU script's
``prep_breakdown`` timed TPU-only preparation (``_prep_coords``,
``_coverage_ok``) that the port does not have; it has no counterpart.
Everything here needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from movedepth_tpu_torch import native, trace
from movedepth_tpu_torch.ops import sweep_warp as SW

# variant -> the stage mask of csrc/sweep_warp_corr.cuh (mdt_swc::Skip)
VARIANTS = {"full": 0, "no_gather": 1, "no_weights": 2, "no_correlate": 4,
            "no_reduce": 8}
SHIPPED = dict(R=48, W=160, C=32, D=16, G=16)


_SIGNATURES = {"sweep_warp_corr_variant_bf16": (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p], ctypes.c_int)}


def variant_library():
    """The variants' library (compiled at first call), typed."""
    return native.load_library("sweep_warp_corr_variants", _SIGNATURES)


def run_variant(name, src, ref, sx, sy, out=None):
    """Launch variant ``name`` on CUDA tensors: src, ref (B, R, W, 32)
    bfloat16, sx, sy (B, D, H, W) float32 -> (B, D, H, W, 16) bfloat16
    (written into ``out`` when given)."""
    if any(t.device.type != "cuda" for t in (src, ref, sx, sy)):
        raise ValueError("the kernel variants run only on a CUDA device")
    if src.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise TypeError("the kernel variants take bfloat16 features")
    b, r, w, c = src.shape
    _, d, h, _ = sx.shape
    groups = SHIPPED["G"]
    if c != SHIPPED["C"]:
        raise ValueError(f"the variants are built for C=32; got C={c}")
    SW._check_kernel_inputs(src, ref, sx, sy)
    if out is None:
        out = torch.empty((b, d, h, w, groups), dtype=src.dtype,
                          device=src.device)
    with torch.cuda.device(src.device):
        err = variant_library().sweep_warp_corr_variant_bf16(
            VARIANTS[name], src.data_ptr(), ref.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), out.data_ptr(), b, r, w, d, h, c, groups,
            torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"variant {name} launch failed: CUDA error {err}")
    trace.count("launch.sweep_warp_corr_variant")
    return out


def shipped_inputs(batch=128, seed=0, device="cuda"):
    """The TPU script's synthetic inputs at the shipped shape: normal
    bfloat16 features, sx uniform over [-2, W+1], sy within a few rows of
    each output row (clipped to [-2, R+1])."""
    s = SHIPPED
    g = torch.Generator().manual_seed(seed)
    src = torch.randn(batch, s["R"], s["W"], s["C"], generator=g)
    ref = torch.randn(batch, s["R"], s["W"], s["C"], generator=g)
    shape = (batch, s["D"], s["R"], s["W"])
    sx = torch.rand(shape, generator=g) * (s["W"] + 3.0) - 2.0
    rows = torch.arange(s["R"], dtype=torch.float32)[None, None, :, None]
    sy = (rows + torch.rand(shape, generator=g) * 6.0 - 2.0).clamp(
        -2.0, s["R"] + 1.0)
    return (src.bfloat16().to(device), ref.bfloat16().to(device),
            sx.to(device), sy.to(device))


def device_ms(fn, launches=50, warmup=5, repeats=5):
    """The device time of one ``fn`` call, the port's kernel timer: after
    ``warmup`` calls, each of ``repeats`` runs records a CUDA event, calls
    ``fn`` ``launches`` times back to back, records a second event and
    divides the elapsed time by the count; the median run. Host work
    before each launch hides behind the device's queue unless it takes
    longer than the kernel. Time a kernel through a bare launch (the typed
    C function on preallocated outputs)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def cuda_ms(fn, runs=20, warmup=3):
    """Median milliseconds of ``fn`` over ``runs`` calls, one call between
    two CUDA events and a synchronise after each: the device time plus the
    host work before the launch (Python, allocation, the autograd engine's
    hand-off), which is what one call costs its caller (``call_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bare_variant(name, src, ref, sx, sy, out):
    """A bare launch of variant ``name`` into ``out``: the typed C function
    on the tensors' pointers, with no checks, no allocation and no count.
    One :func:`run_variant` call (counted) checks the inputs first."""
    run_variant(name, src, ref, sx, sy, out)
    b, r, w, c = src.shape
    _, d, h, _ = sx.shape
    args = (VARIANTS[name], src.data_ptr(), ref.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), out.data_ptr(), b, r, w, d, h, c, SHIPPED["G"],
            torch.cuda.current_stream(src.device).cuda_stream)
    fn = variant_library().sweep_warp_corr_variant_bf16
    return lambda: fn(*args)


def time_variants(inputs):
    """{variant: device ms of its bare launch} on ``inputs`` (see
    :func:`shipped_inputs`), :func:`device_ms`."""
    out = torch.empty(inputs[3].shape + (SHIPPED["G"],),
                      dtype=torch.bfloat16, device=inputs[0].device)
    return {name: device_ms(bare_variant(name, *inputs, out))
            for name in VARIANTS}


def wrapper_ab(inputs, runs=20):
    """{"wrapper": ms of one call of the public sweep_warp_corr (checks,
    allocation, launch; :func:`cuda_ms`), "bare": device ms of the bare
    ``full`` launch into a preallocated output (:func:`device_ms`)}, same
    inputs, same call."""
    out = torch.empty(inputs[3].shape + (SHIPPED["G"],),
                      dtype=torch.bfloat16, device=inputs[0].device)
    return {"wrapper": cuda_ms(lambda: SW.sweep_warp_corr(*inputs,
                                                          SHIPPED["G"]),
                               runs=runs),
            "bare": device_ms(bare_variant("full", *inputs, out))}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernel_variants: no CUDA device; the "
                         "kernel variants run only on a GPU")
    batch = int(argv[0]) if argv else 128
    inputs = shipped_inputs(batch)
    for name, ms in time_variants(inputs).items():
        print(f"{name}: {ms:.4f} ms @ batch {batch}", flush=True)
    ab = wrapper_ab(inputs)
    print(f"public sweep_warp_corr call: {ab['wrapper']:.4f} ms; bare full "
          f"launch: {ab['bare']:.4f} ms (device) @ batch {batch}", flush=True)


if __name__ == "__main__":
    main()
