"""Data generation, FLOP model, health checks and device timing."""
