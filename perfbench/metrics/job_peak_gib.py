"""job_peak_gib: the card's peak allocated memory during the window
(``torch.cuda.max_memory_allocated``, reset when set-up ends), in GiB."""
SOURCE = "device_trace"


def value(record):
    peak = record.get("window_peak_bytes")
    return None if peak is None else peak / 2 ** 30
