"""k3_roofline: K3 (``inception_module_fused``, csrc/inception.cu): the
nine modules' least time a request (``counts``: the larger of operations
over the bf16 peak and bytes over HBM bandwidth, a module at a time) over
K3's device time a request. Moves serve_clips_per_s."""
from bench_h100.lib.readers import roofline


def read(rec):
    if "census" not in rec:
        return None
    return roofline(rec, "K3", rec["census"].k3_bound_s)
