"""Server capture loop: a delivered frame's wait from the end of its
harvest (``pack``) to its last stripe offered to the client's send queue:
the display's capture loop polling the lane, then the emit (the recorder's
``handoff``), mean over the window's delivered frames. None where no
delivered frame carries the stage."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["handoff"][1]
                        - f["span"]["stages"]["handoff"][0]) * 1e3
                       for f in rec["delivered"]
                       if "handoff" in f["span"]["stages"]])
