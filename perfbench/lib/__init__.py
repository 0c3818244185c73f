"""The benchmark's yardstick: its data files, traffic, statistics, counts,
weights, traces and the import check. Nothing here imports the program
at module level."""
