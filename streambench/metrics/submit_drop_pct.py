"""Server capture loop: the share of captured frames that never reached an
encoder step, in percent: spans captured in the window closed
``dropped@submit`` over all spans captured in the window. (In a lane a
submit that finds the slot's previous frame still pending replaces it, and
that frame never ships.)"""


def read(rec):
    spans = rec["spans"]
    if not spans:
        return None
    dropped = sum(1 for sp in spans if sp["terminal"] == "dropped@submit")
    return 100.0 * dropped / len(spans)
