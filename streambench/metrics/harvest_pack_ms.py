"""Lane scheduler: the host's split and assembly of a harvested tick into
each session's stripes (the recorder's ``pack``), mean over the window's
delivered frames."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["pack"][1]
                        - f["span"]["stages"]["pack"][0]) * 1e3
                       for f in rec["delivered"]
                       if "pack" in f["span"]["stages"]])
