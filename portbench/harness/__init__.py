"""What every cell shares: files found by name, traffic, counts, traces."""
