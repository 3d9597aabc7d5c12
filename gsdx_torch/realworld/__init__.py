"""Robot-world facade: the simulated environment, perception, and the
hardware stack (capture processes, shared-memory IPC, RealEnv, arm,
calibration)."""
