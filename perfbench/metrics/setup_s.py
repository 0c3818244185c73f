"""Set-up seconds: from the run's first line to the window's start
(weights drawn on the card, the program built, every kernel built or
loaded, the cell's own shapes warmed)."""


def read(record):
    return record["setup_s"]
