"""sweep_roofline: the profiled frames' traces at their least time
(roofline.py) over the device time of the sweep calls' kernels (K2/K3:
the plan, the sweep and the resolve pass of csrc/sweep.cu)."""

import roofline

# NVIDIA H100 SXM, the published dense rates at 700 W.
PEAKS = {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}
KERNELS = ("sweep_kernel<", "plan_kernel<", "resolve_kernel<")
COUNTED = "sweep_kernel<"
COUNTERS = ("sweep_blocks", "sweep_blocks_anyhit")


def read(rec):
    return roofline.kernel_share(rec, KERNELS, COUNTERS, PEAKS)
