"""Device: the share of the traced window in which no operation ran on the
card, in percent: 100 x (1 - the union of the card's intervals over the
window's length), averaged over the cards used. None without a device
trace."""

from streambench.profiling import busy_s


def read(rec):
    w = rec["device_window"]
    if w is None:
        return None
    return 100.0 * (1.0 - busy_s(w) / (w["t1"] - w["t0"]))
