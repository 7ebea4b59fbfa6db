"""The scan kernel's share of its roofline, in %: the least time any scan
needs, the text read once from HBM (``peaks.json``), over the device time
per query of the events whose names hold one of the configuration's
``scan_kernels``."""

from portbench.traces import PEAKS


def read(view):
    ms = view.per_query_ms(view.named(*view.config["scan_kernels"]))
    if not ms:
        return None
    least_ms = view.text_bytes / PEAKS["hbm_bytes_per_s"] * 1e3
    return 100.0 * least_ms / ms
