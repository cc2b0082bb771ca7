"""Weight wire, calibration and wire planning."""
