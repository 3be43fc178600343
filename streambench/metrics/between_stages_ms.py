"""Time of a delivered frame's flight, from capture to the end of its send,
that no recorder stage covers: waiting for the lane's tick (the slot's
pending frame) and behind earlier ticks. Mean over the window's delivered
frames."""

from streambench import stats

STAGES = ("capture", "stage", "dispatch", "fetch_wait", "pack", "queue",
          "send")


def read(rec):
    vals = []
    for f in rec["delivered"]:
        st = f["span"]["stages"]
        if "send" not in st:
            continue
        t0, t1 = f["span"]["t0"], st["send"][1]
        covered = stats.union_length(
            (max(t0, st[s][0]), min(t1, st[s][1])) for s in STAGES
            if s in st and st[s][1] > t0 and st[s][0] < t1)
        vals.append((t1 - t0 - covered) * 1e3)
    return stats.mean(vals)
