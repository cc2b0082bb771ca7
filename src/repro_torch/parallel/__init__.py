"""Parallel layouts: the logical-axis sharding rules
(:mod:`repro_torch.parallel.sharding`)."""
