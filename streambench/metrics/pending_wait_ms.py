"""Lane scheduler: a delivered frame's wait for its tick, from the submit
of the frame the tick took to the tick's dispatch start (the recorder's
``pending``: the tick's planning and a full in-flight window's blocking
harvest included), mean over the window's delivered frames. None where no
delivered frame carries the stage."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["pending"][1]
                        - f["span"]["stages"]["pending"][0]) * 1e3
                       for f in rec["delivered"]
                       if "pending" in f["span"]["stages"]])
