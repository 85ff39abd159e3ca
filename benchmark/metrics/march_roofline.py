"""march_roofline: the profiled frames' traces at their least time
(roofline.py) over the device time of the march kernel (K8,
csrc/wavefront.cu)."""

import roofline

# NVIDIA H100 SXM, the published dense rates at 700 W.
PEAKS = {"bytes_per_s": 3.35e12, "flops_per_s": 67e12}
KERNELS = ("march_kernel<",)
COUNTED = "march_kernel<"
COUNTERS = ("wavefront_march",)


def read(rec):
    return roofline.kernel_share(rec, KERNELS, COUNTERS, PEAKS)
