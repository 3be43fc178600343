"""Wire edge: a delivered frame's time in its client's send queue and in
the send (the recorder's ``queue`` + ``send``), mean over the window's
delivered frames."""

from streambench import stats


def read(rec):
    vals = []
    for f in rec["delivered"]:
        st = f["span"]["stages"]
        if "queue" in st and "send" in st:
            vals.append(sum((st[s][1] - st[s][0]) * 1e3
                            for s in ("queue", "send")))
    return stats.mean(vals)
