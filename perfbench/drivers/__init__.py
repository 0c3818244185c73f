"""One module a kind of cell (``traffic/<mix>.json``'s ``kind``): each
``run(ctx)`` builds the program for the cell, warms it on the cell's own
shapes, runs the window, reads the device's peak, checks what the window
produced against the reference, and returns the record the metric
readers read."""
