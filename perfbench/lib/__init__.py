"""The benchmark's yardstick: manifest, weights, traces, peaks and the
comparison that decides ``correct``."""
