"""Encoder step: device time of the Huffman pack kernel's launches (every
kernel whose name holds ``huffman_pack``: ``csrc/huffman_pack.cu``'s count
and emit launches) in the traced window, per frame delivered while it ran.
None without a device trace, with no frame delivered in it, or with no
launch of the kernel in it (a program that packs with tensor code)."""

from streambench.profiling import is_kernel

SYMBOL = "huffman_pack"


def read(rec):
    w = rec["device_window"]
    if w is None or not w["frames"]:
        return None
    t0, t1 = w["t0"], w["t1"]
    spans = [(s, e) for name, s, e, _d in w["events"]
             if SYMBOL in name and is_kernel(name) and e > t0 and s < t1]
    if not spans:
        return None
    return sum(min(e, t1) - max(s, t0) for s, e in spans) * 1e3 / w["frames"]
