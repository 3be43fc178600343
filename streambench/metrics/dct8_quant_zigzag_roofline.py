"""Kernels: ``dct8_quant_zigzag``'s share of its roofline, in percent: the
least time its launch can take (its bytes, counted from the lane's shapes
by ``roofline.dct8_bytes``, at the HBM rate) over its mean time per launch
in the traced window. None without a launch in the trace."""

from streambench import roofline


def read(rec):
    w = rec["device_window"]
    if w is None:
        return None
    durs = [e - s for name, s, e, _d in w["events"]
            if "dct8_quant_zigzag_kernel" in name]
    if not durs:
        return None
    stripe_h = int(rec["config"]["reference_settings"]["stripe_height"])
    pad_h = -(-rec["height"] // stripe_h) * stripe_h
    pad_w = -(-rec["width"] // 16) * 16
    n = int(rec["env"]["SELKIES_TPU_SESSIONS_PER_CHIP"])
    bound = roofline.dct8_bound_s(n, pad_h, pad_w)
    return roofline.share_pct(bound, sum(durs) / len(durs))
