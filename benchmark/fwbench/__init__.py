"""The benchmark's own code: traffic, weights, the plain reference, the
yardsticks (FLOP counts, pair costs, peaks, trace reading) and the
comparison that decides ``correct``.  Nothing here imports the measured
package except :mod:`fwbench.cells`, which hands it to the drivers."""
