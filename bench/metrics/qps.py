"""Queries answered in the window over the window's seconds."""


def read(rec):
    if not rec["window_s"]:
        return None
    return rec["queries_answered"] / rec["window_s"]
