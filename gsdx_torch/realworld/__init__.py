"""Robot-world facade: the simulated environment and perception."""
