"""glue_ms_per_batch: device ms of the kernels that are not the port's own
(``datasketch_tpu_torch/csrc``: PyTorch's sorts, gathers, elementwise ops)
over the traced window's calls. Reads ``glue_ms_per_batch.<part>``."""

from portbench.harness.trace import matches, port_kernel_names


def read(rec):
    if rec.trace is None or not rec.calls:
        return None
    own = port_kernel_names()
    sec = rec.trace.device_s(lambda name, kind: kind == "kernel" and not matches(name, own))
    return 1e3 * sec / rec.calls
