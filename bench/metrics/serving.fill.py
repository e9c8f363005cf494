"""Queries dispatched a round over the policy's ``max_batch``, in percent,
over the rounds that dispatched any."""


def read(rec):
    rounds = rec.get("dispatched") or []
    if not rounds:
        return None
    return 100.0 * sum(rounds) / (len(rounds) * rec["max_batch"])
