"""Recall@10 of the compared answers against the reference's exact top-k."""


def read(rec):
    return rec["recall"]
