"""Encoder step: device time of every kernel except the two hand-written
ones (``dct8_quant_zigzag_kernel``, ``me_mc_kernel``), in the device
trace, per frame delivered while it ran. None without a device trace or
with no frame delivered in it."""

from streambench.profiling import is_kernel

HAND_WRITTEN = ("dct8_quant_zigzag_kernel", "me_mc_kernel")


def read(rec):
    w = rec["device_window"]
    if w is None:
        return None
    t0, t1 = w["t0"], w["t1"]
    n = w["frames"]
    if not n:
        return None
    total = sum(min(e, t1) - max(s, t0) for name, s, e, _d in w["events"]
                if is_kernel(name) and e > t0 and s < t1
                and not any(h in name for h in HAND_WRITTEN))
    return total * 1e3 / n
