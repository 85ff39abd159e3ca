"""Measurement entry points of the port: the sweep's cost decomposition
(kernel_mt20) and the four linear forms on the FP32 pipes against the
tensor cores (mxu_micro). Each module has `run()` returning its record and
a `main()` that prints it: `python3 -m hagrid_tpu_torch.exp.<module>`."""
