"""setup_s: seconds from the harness's start to the window's: imports, card
start, the corpus made on the card, kernels built or loaded, warm-up."""
SOURCE = "host_clock"


def value(record):
    return record.get("setup_s")
