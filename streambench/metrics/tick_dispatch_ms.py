"""Lane scheduler: the host's launch of the tick that carried a delivered
frame (the recorder's ``dispatch``), mean over the window's delivered
frames."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["dispatch"][1]
                        - f["span"]["stages"]["dispatch"][0]) * 1e3
                       for f in rec["delivered"]
                       if "dispatch" in f["span"]["stages"]])
