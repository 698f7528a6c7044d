"""The benchmark's own code: traffic, weights, the model families (each
one's layout and FLOP count), the plain references, the yardsticks (pair
costs, peaks, trace reading) and the comparison that decides ``correct``.
Nothing here imports the measured package except :mod:`fwbench.cells`,
which hands it to the drivers."""
