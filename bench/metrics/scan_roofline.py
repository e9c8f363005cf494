"""The flat request's least time on this card (``bench/roofline.py``: its
bytes over the HBM peak or its operations over the TF32 peak, whichever is
longer) over the device time of all the request's operations, in percent."""
from bench.records import device_seconds, profiled_requests
from bench.roofline import flat_bound_s


def read(rec):
    n = profiled_requests(rec)
    if n is None:
        return None
    mix, cfg = rec["mix"], rec["config"]
    bound = flat_bound_s(rec["card"], int(mix["batch"]), int(cfg["n"]),
                         int(cfg["d"]), int(mix["k"]))
    per_request = device_seconds(rec) / n
    if bound is None or per_request <= 0:
        return None
    return 100.0 * bound / per_request
