"""Peak device memory allocated from the engine's set-up through the window
(``torch.cuda.max_memory_allocated``), in GB of 1e9 bytes."""


def read(rec):
    if not rec["memory_peak_bytes"]:
        return None
    return rec["memory_peak_bytes"] / 1e9
