"""R3 bad (capture twin), the helper module: host syncs in functions the captured body
reaches across modules, directly and through a function passed as a value."""
import time

import torch


def scale_of(x):
    return float(x.abs().max())            # a device read on the host


def live_rows(mask):
    return torch.nonzero(mask).reshape(-1)  # sized from device data


def stamp(x):
    t = time.perf_counter()                # the host clock, read once at capture
    return x * t


def pick(x):
    return stamp                           # a function handed back as a value
