"""The yardstick of the port's benchmark: generator, plain reference, byte
counts, table of peaks, trace reduction, comparison and the harness."""
