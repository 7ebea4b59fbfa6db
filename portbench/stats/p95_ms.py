"""The 95th percentile of the latency of every call in the window, in ms:
from its issue until its results are on the host."""

import numpy as np


def value(window: dict) -> float:
    return float(np.percentile(window["latency_s"], 95)) * 1e3
